"""The co-gs train cell of the benchmark (``train.cogs-1spp-15k``) against
the port on the CPU, at a tiny size: the plain reference
(``gsbench/reference/cogs.py``) follows the port's co-gs step with
SO(3) x R3 camera optimisation and its densifying refine; each planted
fault fails a number against the cell's limits; the cell's driver makes
``Trainer.train``'s calls and runs end to end; and K2's work count holds
with a live depth cotangent."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gsbench import scene as gscene
from gsbench import work
from gsbench.drivers import train_cogs
from gsbench.reference import cogs as rcogs
from gsbench.reference import splat as rsplat
from gsbench.reference import train as rtrain
from gsbench.reference.precision import Arith
from gsbench.tests.tiny import REPO, tiny_root
from gsbench.work import k2

CELL = "train.cogs-1spp-15k"
CONFIG = REPO / "gsbench" / "configs" / "cogs-1spp-15k.json"
LIMITS = json.loads((REPO / "gsbench" / "limits" / f"{CELL}.json").read_text())


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(4)
    # some Gaussians under the cull's opacity (0.1), for the refine to cull
    root = tiny_root(tmp_path_factory.mktemp("tiny"), scene={"opacity_min": 0.01})
    cfg = json.loads((root / "gsbench/configs/cogs-1spp-15k.json").read_text())
    dev = torch.device("cpu")
    cap = gscene.capture(cfg, dev)
    params = gscene.draw_scene(cfg, cap, int(cfg["capture_seed"]), dev)
    poses = train_cogs.pose_error(cap, cfg)
    views = [int(i) for i in cap.train[:3]]
    pairs = [train_cogs.target(cap, i, params, cfg) for i in views]
    return {"root": root, "cfg": cfg, "cap": cap, "params": params, "poses": poses,
            "views": views, "rgba": [p[0] for p in pairs], "depth": [p[1] for p in pairs]}


def _port_scene(params):
    from gstk_torch.core.gaussians import GaussianScene

    return GaussianScene(**{k: v.clone() for k, v in params.items()})


def _ref_views(t):
    cap = t["cap"]
    return [rsplat.View(t["poses"][i], cap.fx, cap.fy, cap.cx, cap.cy, cap.height,
                        cap.width) for i in t["views"]]


def _reference(t, first, adjust, fault="", ar=Arith()):
    c = t["params"]["alive"].numel()
    zero = torch.zeros_like(adjust)
    stats = {k: torch.zeros(c) for k in ("grad", "vis", "max2d")}
    gen = torch.Generator().manual_seed(5)
    return rcogs.run_steps(t["params"], stats,
                           {"adjust": adjust, "mu": zero, "nu": zero, "count": 0},
                           _ref_views(t), t["views"], t["rgba"], t["depth"], gen, first,
                           3, 1, len(t["cap"].poses), ar, fault)


def test_config_states_the_programs_co_gs(tiny):
    """The configuration holds ``DepthConfig``'s defaults but the planar
    prior, and ``CameraOptConfig``'s but the mode; the reference's
    constants are the program's."""
    from gstk_torch.core.camera_opt import CameraOptConfig
    from gstk_torch.models.depth import DepthConfig

    cfg = json.loads(CONFIG.read_text())
    depth, cam = DepthConfig(), CameraOptConfig()
    assert {k: v for k, v in cfg["depth"].items() if getattr(depth, k) != v} == {
        "using_planar_loss": True}
    assert {k: v for k, v in cfg["camera_opt"].items() if getattr(cam, k) != v} == {
        "mode": "SO3xR3"}
    assert cfg["reduced"] == [] and cfg["method"] == "co-gs"
    m = DepthConfig(**cfg["depth"])
    assert (rcogs.DEPTH_LAMBDA, rcogs.DEPTH_START, rcogs.DEPTH_STOP) == (
        m.depth_lambda, m.depth_loss_start_iteration, m.depth_loss_stop_iteration)
    assert (rcogs.PLANAR_START, rcogs.PATCH, rcogs.STOP_SPLIT_AT,
            rcogs.STOP_SCREEN_SIZE_AT, rcogs.WARMUP) == (
        m.planar_loss_start_iteration, m.local_patch_size, m.stop_split_at,
        m.stop_screen_size_at, m.warmup_length)
    assert (rcogs.DENSIFY_GRAD, rcogs.DENSIFY_SIZE, rcogs.SPLIT_SAMPLES,
            rcogs.CULL_SCREEN, rcogs.SPLIT_SCREEN) == (
        m.densify_grad_thresh, m.densify_size_thresh, m.n_split_samples,
        m.cull_screen_size, m.split_screen_size)
    assert (rcogs.CAM_LR, rcogs.CAM_LR_FINAL, rcogs.CAM_STEPS, rcogs.TRANS_PENALTY,
            rcogs.ROT_PENALTY) == (cam.lr, cam.lr_final, cam.max_steps,
                                   cam.trans_l2_penalty, cam.rot_l2_penalty)
    # every refine of the window densifies, and the wrap keeps it so
    for step in range(cfg["start_step"] // 100 * 100 + 100, train_cogs.WRAP_AT + 1, 100):
        assert step % rcogs.RESET_EVERY > 210 + rtrain.REFINE_EVERY, step


def test_the_reference_imports_nothing_of_the_program():
    """``gsbench/reference/cogs.py`` imports torch and the vanilla
    reference only: nothing of the port, of JAX or of the JAX package."""
    import ast

    tree = ast.parse((REPO / "gsbench" / "reference" / "cogs.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names == {"__future__", "typing", "torch", "gsbench.reference",
                     "gsbench.reference.precision"}, names


def test_cogs_step_matches_the_port(tiny):
    """Three co-gs steps with SO3xR3 of the port against the reference's,
    from adjustments off zero: losses, each group's first gradient
    (the camera group's too) and each group's change."""
    from gstk_torch.core.camera_opt import CameraOptConfig
    from gstk_torch.core.cameras import Camera
    from gstk_torch.models.depth import DepthConfig
    from gstk_torch.ops.rasterize import RasterizeConfig
    from gstk_torch.train.optim import OptimizerConfig
    from gstk_torch.train.step import init_train_state, make_train_step

    t = tiny
    cap, cfg = t["cap"], t["cfg"]
    n = len(cap.poses)
    adjust = 1e-3 * torch.randn((n, 6), generator=torch.Generator().manual_seed(3))
    state = init_train_state(_port_scene(t["params"]), num_cameras=n)
    state.cam_adjust.copy_(adjust)
    first = 12_200
    state.step.fill_(first)
    fn = make_train_step(DepthConfig(**cfg["depth"]), RasterizeConfig(isect_capacity=1 << 16),
                         OptimizerConfig(), cap.height, cap.width, 3,
                         camera_opt=CameraOptConfig(**cfg["camera_opt"]))
    gen = torch.Generator().manual_seed(5)
    losses = []
    for k, (i, rgba, depth) in enumerate(zip(t["views"], t["rgba"], t["depth"])):
        cam = Camera.create(cap.fx, cap.fy, cap.cx, cap.cy, t["poses"][i])
        state, m = fn(state, cam, rgba.float() / torch.full((), 255.0), gen,
                      depth=depth, camera_index=torch.tensor(i))
        losses.append(float(m["loss"]))
        assert float(m["planar_loss"]) > 0 and float(m["depth_l1"]) > 0
        if k == 0:
            grads = {g: float(torch.linalg.norm(mu.double()) / (1 - rtrain.B1))
                     for g, mu in state.adam.mu.items()}
            grads[rcogs.CAMERA] = float(torch.linalg.norm(
                state.cam_adam.mu[rcogs.CAMERA].double()) / (1 - rtrain.B1))
    change = {g: float(torch.linalg.norm((getattr(state.scene, g).detach()
                                           - t["params"][g]).double())) for g in rcogs.GROUPS}
    change[rcogs.CAMERA] = float(torch.linalg.norm((state.cam_adjust - adjust).double()))
    ref = _reference(t, first, adjust)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for g in rcogs.GROUPS + (rcogs.CAMERA,):
        assert grads[g] == pytest.approx(ref["grad_norms"][g], rel=1e-4), g
        assert change[g] == pytest.approx(ref["change_norms"][g], rel=1e-4), g
        assert ref["grad_norms"][g] > 0 and ref["change_norms"][g] > 0, g


@pytest.mark.parametrize("dead", [0, 500])
def test_densifying_refine_matches_the_port(tiny, dead):
    """The port's refine at a densifying step against the reference's,
    from the same state, statistics and normal draws: alive lanes,
    parameters and the moments zeroed, with the scene at the cap and with
    dead lanes to fill; lanes split, copied and culled alike."""
    from gstk_torch.models.depth import DepthConfig
    from gstk_torch.train.optim import init_adam
    from gstk_torch.train.strategy import RefineState, refine

    t = tiny
    params = {k: v.clone() for k, v in t["params"].items()}
    c = params["alive"].numel()
    g = torch.Generator().manual_seed(7)
    params["alive"] = torch.ones(c, dtype=torch.bool)
    params["alive"][torch.randperm(c, generator=g)[:dead]] = False
    lanes = torch.nonzero(params["alive"])[:, 0]
    params["opacities"][lanes[:30], 0] = -4.0
    stats = {"grad": 3e-3 * torch.rand(c, generator=g) * 20.0,
             "vis": torch.full((c,), 20.0),
             "max2d": 0.01 * torch.rand(c, generator=g)}
    step = 12_400
    scene = _port_scene(params)
    adam = init_adam(scene.params())
    for v in list(adam.mu.values()) + list(adam.nu.values()):
        v.fill_(1.0)
    _, adam, _, info = refine(scene, adam, RefineState(stats["grad"], stats["vis"],
                                                         stats["max2d"]),
                              step, DepthConfig(), len(t["cap"].train), t["cap"].width,
                              generator=torch.Generator().manual_seed(9))
    ref = dict(params)
    mu = {k: torch.ones_like(v) for k, v in params.items() if k != "alive"}
    nu = {k: torch.ones_like(v) for k, v in mu.items()}
    r = rcogs.refine(ref, mu, nu, stats, step, torch.Generator().manual_seed(9),
                     len(t["cap"].train), t["cap"].width)
    assert r["split"] > 10 and r["dup"] > 10 and r["cull"] > 30
    assert int(info["num_split"]) == r["split"] and int(info["num_dup"]) == r["dup"]
    assert torch.equal(scene.alive, ref["alive"])
    assert bool((scene.alive & ~params["alive"]).any()) is (dead > 0)
    for k in rcogs.GROUPS:
        torch.testing.assert_close(getattr(scene, k), ref[k], rtol=1e-6, atol=1e-6)
        assert torch.equal(adam.mu[k] == 0, mu[k] == 0), k
    pre = {"params": {k: v for k, v in params.items() if k != "alive"},
           "alive": params["alive"], "stats": stats, "step": step,
           "generator": torch.Generator().manual_seed(9).get_state()}
    again = rcogs.refine_from(pre, len(t["cap"].train), t["cap"].width)
    assert torch.equal(again["alive"], ref["alive"])
    assert torch.equal(again["slot"], r["slot"])


@pytest.fixture(scope="module")
def late(tiny):
    """The sound reference's late stretch: three steps whose third ends a
    densifying refine, from adjustments off zero."""
    n = len(tiny["cap"].poses)
    adjust = 1e-3 * torch.randn((n, 6), generator=torch.Generator().manual_seed(3))
    return adjust, _reference(tiny, 12_397, adjust)


@pytest.mark.parametrize("control", ["tf32"] + list(rcogs.FAULTS))
def test_a_planted_fault_fails_a_number(tiny, late, control):
    """The reference with each planted fault (and as the TF32 control) in
    the program's place, against the sound reference: the cell's
    comparison over the late stretch and its densifying refine puts at
    least one number over its limit; the sound reference against itself
    puts none."""
    adjust, ref = late
    compare = train_cogs.TrainCogs.compare
    sound = rcogs.refine_from(ref["pre_refine"], len(tiny["cap"].train),
                              tiny["cap"].width)
    same = compare(ref, ref, "late_", sound)
    assert ref["refine"]["slot"].numel() > 0
    assert all(v == 0.0 for v in same.values()), same
    kw = {"ar": Arith(tf32=True)} if control == "tf32" else {"fault": control}
    got = _reference(tiny, 12_397, adjust, **kw)
    numbers = compare(got, ref, "late_", rcogs.refine_from(
        got["pre_refine"], len(tiny["cap"].train), tiny["cap"].width))
    over = {k: v for k, v in numbers.items() if v > LIMITS[k]}
    assert over, numbers


def test_the_driver_makes_trainer_trains_calls():
    """The cell's iteration is the vanilla driver's, which makes the calls
    of ``Trainer.train``'s iteration in its order and cadence, camera
    index included."""
    import ast

    from gstk_torch.train.trainer import Trainer

    from gsbench.drivers.train import TrainLoop
    from gsbench.tests import test_gsbench_loop as loop

    assert train_cogs.TrainCogs.step_once is TrainLoop.step_once
    body = next(n for n in ast.walk(loop._source(Trainer.train)) if isinstance(n, ast.For))
    want = [c for c in loop._calls(ast.Module(body=body.body, type_ignores=[]))
            if c not in loop.LEFT_OUT]
    got = [c for c in loop._calls(loop._source(TrainLoop.step_once))
           if c not in ("record_function", "_span", "int", "float", "items")]
    assert got == want and "_camera_index" in got and "_refine" in got


def _cell_run(root, seed: int, trace: bool):
    """One run of the cell as ``gsbench.run`` makes it, on the CPU (this
    process holds JAX, which ``gsbench.run`` refuses): set-up, a short
    window, the traced stretch, the late stretch and the comparison with
    the cell's limits."""
    from gsbench import run as grun
    from gsbench import trace as gtrace

    manifest = grun.load_manifest(root)
    cell = next(w for w in manifest["workloads"] if w["name"] == CELL)
    dev = torch.device("cpu")
    driver = train_cogs.DRIVER(grun.Run(root, manifest, cell, seed, dev))
    driver.setup()
    driver.window(0.3)
    metrics = {}
    if trace:
        ctx = grun.Context(driver.traced(lambda body: gtrace.record(body, dev)))
        metrics = {n: grun._metric_reader(root, n)(ctx)
                   for n in ("mfu_cogs.train", "depth_terms_ms.train", "camera_ms.train")}
        metrics["views"] = [v.c2w for v, _, _ in ctx._inputs]
    driver.check_stretch()
    driver.release()
    verdict = driver.verify()
    over = {k: v for k, v in verdict["numbers"].items() if not v <= LIMITS[k]}
    return driver, verdict, over, metrics


def test_the_cell_runs_at_a_tiny_size(tiny, monkeypatch):
    """The cell end to end on the CPU, traced: every number under its
    limit but the change gaps, which a round-off flip of one lane's first
    Adam step (a whole learning rate) weighs more in 4,096 lanes than in
    the cell's 2^20 and which stay within three times theirs; the traced
    views taken with the adjusted cameras, the span metrics silent on the
    CPU (no device events); with the port's refine writing no children
    the refine's gap is over its limit."""
    from gstk_torch.train import strategy

    driver, verdict, over, metrics = _cell_run(tiny["root"], 4000000011, True)
    assert set(verdict["numbers"]) == set(LIMITS)
    assert set(over) <= {"change_gap", "late_change_gap"}, verdict
    assert all(v <= 3 * LIMITS[k] for k, v in over.items()), verdict
    assert metrics["mfu_cogs.train"] > 0
    assert metrics["depth_terms_ms.train"] is None and metrics["camera_ms.train"] is None
    assert all(not any(torch.equal(c, p) for p in driver.poses) for c in metrics["views"])
    assert verdict["detail"]["written"] > 0
    assert driver.counts["end"]["camera_adjust_norm"] > 0
    real = strategy._place_children

    def no_children(scene, adam, samples, split_scale, valid_a, valid_b, free):
        return real(scene, adam, samples, split_scale, torch.zeros_like(valid_a),
                    torch.zeros_like(valid_b), free)
    monkeypatch.setattr(strategy, "_place_children", no_children)
    _, verdict, over, _ = _cell_run(tiny["root"], 4000000011, False)
    assert "late_refine_gap" in over, verdict


@pytest.mark.parametrize("live", [False, True])
def test_k2_work_count_holds_with_a_live_depth_cotangent(tiny, live, monkeypatch):
    """The compositing backward walks the pairs ``gsbench/work/k2.py``
    counts (the forward's pairs needed, four channels) whether the depth
    channel's cotangent is 0 or live, as co-gs's depth terms make it; with
    it live the depth channel's colour gradient is not 0."""
    from gstk_torch.core.cameras import Camera
    from gstk_torch.models.vanilla import render_scene
    from gstk_torch.ops import raster_cuda
    from gstk_torch.ops.rasterize import RasterizeConfig

    t = tiny
    cap, params = t["cap"], t["params"]
    view = _ref_views(t)[0]
    walked = []
    real = raster_cuda._walk

    def counting(*args, **kwargs):
        for c in real(*args, **kwargs):
            walked.append(int(c.visits.sum()))
            yield c
    scene = _port_scene(params)
    cam = Camera.create(cap.fx, cap.fy, cap.cx, cap.cy, view.c2w)
    out = render_scene(scene, cam, cap.height, cap.width, sh_degree=3,
                       background=torch.zeros(3),
                       raster_config=RasterizeConfig(isect_capacity=1 << 16))
    loss = out["rgb"].mean() + (out["depth"].mean() if live else 0.0)
    monkeypatch.setattr(raster_cuda, "_walk", counting)
    (g_means,) = torch.autograd.grad(loss, [scene.means])
    p = work.analyse(params, view, 3, 1)
    assert p.channels == 4 and sum(walked) == p.pairs
    assert k2.count(p)["flops"] == k2.FLOPS_PER_PAIR * p.pairs
    # the depth channel's cotangent moves the means along the view axis
    plain = torch.autograd.grad(render_scene(
        scene, cam, cap.height, cap.width, sh_degree=3, background=torch.zeros(3),
        raster_config=RasterizeConfig(isect_capacity=1 << 16))["rgb"].mean(),
        [scene.means])[0]
    assert bool((g_means != plain).any()) is live
