"""Rank processes of ``tests/test_torch_parallel.py``: gstk_torch's
parallel paths on gloo ranks on the CPU (no JAX here).

    python tests/_torch_ranks.py <case> <rank> <world> <dir>

Each rank joins the group through ``initialize_distributed`` (a
``file://`` rendezvous in ``<dir>``, or ``tcp://`` for the trainer case),
reads its inputs from ``<dir>/in.npz`` and writes ``<dir>/out_<rank>.npz``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gstk_torch.core.camera_opt import CameraOptConfig
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import FIELD_NAMES, scene_from_numpy
from gstk_torch.models.depth import DepthConfig
from gstk_torch.models.vanilla import VanillaConfig, render_scene, splat_inputs
from gstk_torch.ops.rasterize import RasterizeConfig, rasterize
from gstk_torch.parallel import gaussian_sharding as gs
from gstk_torch.parallel import tile_sharding as ts
from gstk_torch.parallel.mesh import (
    DATA_AXIS,
    data_parallel_train_step,
    get_mesh,
    initialize_distributed,
)
from gstk_torch.train.checkpoint import (
    save_checkpoint,
    train_state_from_numpy,
    train_state_to_numpy,
)
from gstk_torch.train.optim import OptimizerConfig
from gstk_torch.train.step import init_train_state, make_train_step
from gstk_torch.train.strategy import refine

TIMEOUT = timedelta(seconds=120)  # a collective's deadline
RANK_TIMEOUT_S = 240  # a rank's, from its start
REPO = Path(__file__).resolve().parent.parent
H, W = 40, 56
RASTER = RasterizeConfig(chunk_size=16, isect_capacity=1 << 13)
MODEL = VanillaConfig(background_color="black", sh_degree=0)
INFO = ("num_alive", "num_split", "num_dup", "num_cull", "num_dropped",
        "did_reset")
# the trainer run that grows: every visible Gaussian densifies (the large
# ones split, by world size alone), and the seed cloud fills 300 of 512
# lanes (headroom 1), so the refines at steps 9 and 12 fill the lanes, the
# capacity grows at the next fetch and the refine at step 15 writes into
# the grown lanes
GROW_ITERS = 15
GROW_MODEL = dict(densify_grad_thresh=1e-12, densify_size_thresh=0.03,
                  split_screen_size=1.0)
GROW_TRAINER = dict(initial_capacity_headroom=1.0)


def spawn(case: str, world: int, io: Path) -> list:
    """Run ``world`` ranks of ``case`` with ``io`` as their directory; join
    them within ``RANK_TIMEOUT_S`` (a rank still running then is killed) and
    return every rank's outputs; fails with the ranks' logs if one failed."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(io / f"rank_{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), case, str(r),
             str(world), str(io)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = "\n".join((io / f"rank_{r}.log").read_text() for r in range(world))
    assert all(p.returncode == 0 for p, _ in procs), logs[-6000:]
    return [dict(np.load(io / f"out_{r}.npz")) for r in range(world)]


def _camera(inp, i):
    return Camera.create(float(inp["fx"]), float(inp["fy"]), float(inp["cx"]),
                         float(inp["cy"]), inp["c2w"][i], device="cpu")


def _scene(inp, prefix):
    return scene_from_numpy({k[len(prefix):]: inp[k] for k in inp.files
                             if k.startswith(prefix)}, "cpu")


def _step(mesh=None, model=MODEL, axis_name=DATA_AXIS):
    return make_train_step(model, RASTER, OptimizerConfig(), H, W,
                           sh_degree=0, axis_name=axis_name, mesh=mesh)


def _flat(state, prefix=""):
    """Copies (``train_state_to_numpy`` shares the tensors' memory, and
    refine updates in place)."""
    return {prefix + k: v.copy() for k, v in train_state_to_numpy(state).items()}


def case_dp(rank, world, inp, out):
    """One DP step from the JAX test's start state (rank r: camera r), 25
    DP steps from a perturbed start (PSNR of the first and last), the mono
    scale threaded through, the Gaussian-sharded render, step and refine
    against the replicated ones."""
    mesh = get_mesh()
    step = data_parallel_train_step(_step(mesh), mesh)
    gen = torch.Generator().manual_seed(5)
    state, m = step(init_train_state(_scene(inp, "start.")),
                    _camera(inp, rank), torch.from_numpy(inp["gts"][rank]), gen)
    out.update(_flat(state, "dp."))
    out["dp_loss"] = float(m["loss"])

    state = init_train_state(_scene(inp, "noisy."))
    psnrs = []
    for _ in range(25):
        state, m = step(state, _camera(inp, rank),
                        torch.from_numpy(inp["gts"][rank]), gen)
        psnrs.append(float(m["psnr"]))
    out["psnrs"] = np.asarray(psnrs)

    cfg = DepthConfig(
        background_color="black", sh_degree=0, use_est_depth=True,
        use_scaled_est_depth=True, depth_loss_start_iteration=0,
        mono_depth_l1_start_iteration=0,
    )
    mono = data_parallel_train_step(_step(mesh, cfg), mesh)
    losses = []
    for scale in (None, torch.tensor(2.0)):
        s = init_train_state(_scene(inp, "gt."))
        s.step = torch.tensor(10, dtype=torch.int32)
        _, m = mono(s, _camera(inp, rank), torch.from_numpy(inp["gts"][rank]),
                    gen, depth=torch.ones(H, W), mono_scale=scale,
                    mono_shift=None if scale is None else torch.tensor(0.1))
        losses.append(float(m["loss"]))
    out["mono_losses"] = np.asarray(losses)
    gauss_checks(rank, world, inp, out)


def gauss_checks(rank, world, inp, out):
    """The Gaussian-sharded render, step and refine on this group against
    the replicated ones computed here (same inputs on every rank)."""
    mesh = gs.make_gauss_mesh()
    scene = _scene(inp, "sh.")
    cam = _camera(inp, 0)
    kw = dict(sh_degree=1, background=torch.zeros(3),
              config=VanillaConfig(sh_degree=1), raster_config=RASTER)
    ref = render_scene(scene, cam, H, W, **kw)
    got = gs.render_scene_gauss_sharded(gs.shard_scene(scene, mesh), cam, H,
                                        W, mesh=mesh, **kw)
    for k in ("rgb", "depth", "alpha"):
        out[f"render_{k}"] = got[k].detach().numpy()
        out[f"render_ref_{k}"] = ref[k].detach().numpy()

    model = dataclasses.replace(MODEL, use_scale_regularization=True)
    full = init_train_state(_scene(inp, "gt."))
    gt = torch.from_numpy(inp["gts"][0])
    replicated = make_train_step(model, RASTER, OptimizerConfig(), H, W,
                                 sh_degree=0, apply_scale_reg=True)
    sharded = make_train_step(model, RASTER, OptimizerConfig(), H, W,
                              sh_degree=0, apply_scale_reg=True, mesh=mesh)
    want = init_train_state(_scene(inp, "gt."))
    got = gs.shard_train_state(full, mesh)
    for i in range(2):
        want, m_want = replicated(want, _camera(inp, 1), gt)
        got, m_got = sharded(got, _camera(inp, 1), gt)
    out.update(_flat(want, "step_ref."))
    out.update(_flat(gs.gather_train_state(got, mesh), "step."))
    out["step_metrics"] = np.asarray([float(m_got[k]) for k in sorted(m_got)])
    out["step_metrics_ref"] = np.asarray([float(m_want[k])
                                          for k in sorted(m_want)])
    cam_opt_checks(mesh, lambda: _scene(inp, "gt."),
                   [_camera(inp, i) for i in range(2)],
                   [torch.from_numpy(g) for g in inp["gts"][:2]], out)
    # one refine on the gathered state against the replicated refine, the
    # same noise drawn on every rank
    cfg = dataclasses.replace(MODEL, warmup_length=0, refine_every=1)
    for name, st in (("refine_ref.", want),
                     ("refine.", gs.gather_train_state(got, mesh))):
        refine(st.scene, st.adam, st.refine, 40, cfg, 2, W,
               generator=torch.Generator().manual_seed(3))
        if name == "refine.":
            st = gs.gather_train_state(gs.shard_train_state(st, mesh), mesh)
        out.update(_flat(st, name))


def cam_opt_checks(mesh, scene, cams, gts, out):
    """Two co-gs steps with SO3xR3 camera optimisation (step i renders
    ``cams[i]`` as camera i + 1 of 3, so the second step's pose
    regulariser is non-zero), sharded on ``mesh`` and replicated, from
    ``scene()`` each."""
    h, w = gts[0].shape[:2]
    dev = gts[0].device
    model = DepthConfig(sh_degree=0, background_color="black",
                        use_sparse_loss=True, depth_loss_start_iteration=0,
                        using_planar_loss=True, planar_loss_start_iteration=0,
                        local_patch_size=16)
    depth = torch.from_numpy(np.random.default_rng(7).uniform(
        2.0, 8.0, (h, w)).astype(np.float32)).to(dev)
    make = lambda **kw: make_train_step(
        model, RASTER, OptimizerConfig(), h, w, sh_degree=0,
        camera_opt=CameraOptConfig(mode="SO3xR3"), **kw)
    replicated, sharded = make(), make(mesh=mesh)
    want = init_train_state(scene(), num_cameras=3)
    got = gs.shard_train_state(init_train_state(scene(), num_cameras=3), mesh)
    gen_want, gen_got = (torch.Generator(dev).manual_seed(11) for _ in range(2))
    for i in range(2):
        kw = dict(depth=depth, camera_index=torch.tensor(i + 1, device=dev))
        want, m_want = replicated(want, cams[i], gts[i], gen_want, **kw)
        got, m_got = sharded(got, cams[i], gts[i], gen_got, **kw)
    out.update(_flat(want, "cam_ref."))
    out.update(_flat(gs.gather_train_state(got, mesh), "cam."))
    out["cam_metrics"] = np.asarray([float(m_got[k]) for k in sorted(m_got)])
    out["cam_metrics_ref"] = np.asarray([float(m_want[k])
                                         for k in sorted(m_want)])


def assert_cam_opt_matches(o):
    """``cam_opt_checks``' outputs: the scene, its moments and statistics
    bit for bit; the camera group, whose gradient sums the ranks'
    projection shares and then adds the pose regulariser's once, within
    rtol 5e-3, atol 1e-4 max|x| (that sum over the lanes runs in another
    order on a shard); the metrics within rtol 1e-5. The second step moves
    row 1's moments by the regulariser alone, so a regulariser counted once
    a rank shows there."""
    keys = [k for k in o if k.startswith("cam_ref.")]
    assert any(".cam_adam" in k for k in keys)
    for k in keys:
        got, want = o["cam." + k[len("cam_ref."):]], o[k]
        if ".cam_" in k:
            np.testing.assert_allclose(got, want, rtol=5e-3,
                                       atol=1e-4 * float(np.abs(want).max()),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_allclose(o["cam_metrics"], o["cam_metrics_ref"],
                               rtol=1e-5)
    assert np.abs(o["cam_ref..cam_adjust"][1:]).min() > 0


def case_mesh4(rank, world, inp, out):
    """The tile-sharded render on 4 ranks; the 2x2 data x gauss mesh
    against the 2-way data mesh (each pair of ranks the same replica)."""
    proj = {k[5:]: torch.from_numpy(inp[k]) for k in inp.files
            if k.startswith("proj.")}
    cfg = RasterizeConfig(chunk_size=16, isect_capacity=1 << 13)
    bg = torch.tensor([0.1, 0.2, 0.3])
    img, alpha = ts.rasterize_tile_sharded(
        **proj, img_height=64, img_width=128, mesh=ts.make_tile_mesh(),
        background=bg, config=cfg)
    ref_img, ref_alpha = rasterize(**proj, img_height=64, img_width=128,
                                   background=bg, config=cfg)
    out.update(tile_img=img.numpy(), tile_alpha=alpha.numpy(),
               single_img=ref_img.numpy(), single_alpha=ref_alpha.numpy())

    for name, axes in (("mesh1d.", (("rep", 2), (DATA_AXIS, 2))),
                       ("mesh2d.", ((DATA_AXIS, 2), (gs.GAUSS_AXIS, 2)))):
        mesh = get_mesh(axes=axes)
        data = mesh[DATA_AXIS].index
        state = init_train_state(_scene(inp, "noisy."))
        if gs.GAUSS_AXIS in mesh:
            state = gs.shard_train_state(state, mesh)
        state, m = _step(mesh)(state, _camera(inp, data),
                               torch.from_numpy(inp["gts"][data]))
        if gs.GAUSS_AXIS in mesh:
            state = gs.gather_train_state(state, mesh)
        out.update(_flat(state, name))
        out[name + "loss"] = float(m["loss"])


def trainer_run(root: Path, name: str, iters: int = 6, model=None,
                **extra):
    """gs-train's Trainer on the synthetic set in ``root/ds``: ``iters``
    steps, refining every 3 (an opacity reset at step 3, densifying from
    step 9), then one eval of every eval view; ``model`` overrides fields
    of the model config. Returns the trainer and that eval."""
    from gstk_torch.configs.methods import method_configs
    from gstk_torch.train.trainer import Trainer

    cfg = dataclasses.replace(
        method_configs()["gaussian-splatting"], data=root / "ds",
        output_dir=root / name, experiment_name="ds", max_num_iterations=iters,
        steps_per_save=100, steps_per_eval_image=0,
        steps_per_eval_all_images=0, isect_capacity=8192, raster_chunk=16,
        log_every=2, **extra,
    )
    cfg.model = dataclasses.replace(cfg.model, sh_degree=1, warmup_length=2,
                                    refine_every=3, **(model or {}))
    cfg.dataparser = dataclasses.replace(
        cfg.dataparser, data=root / "ds", eval_mode="interval",
        eval_interval=3, downscale_factor=1)
    trainer = Trainer(cfg, device="cpu")
    trainer.setup()
    trainer.train()
    return trainer, trainer.eval_all(cfg.max_num_iterations)


def grow_ckpts(root: Path) -> Path:
    """The checkpoints of the sharded run that grows."""
    return root / "gauss_grow" / "ds" / "gaussian-splatting" / "ckpts"


def _no_whole_state(*args, **kwargs):
    raise AssertionError("the trainer gathered the whole state")


def case_trainer(rank, world, inp, out):
    """The Trainer on 2 ranks: data parallel (the group started from
    ``coordinator_address``), then ``param_sharding="auto"`` on the same
    group, then a sharded run that refines and grows (``GROW_*``) with
    ``gather_train_state`` made to raise and the viewer on (rank 0 keeps
    its last snapshot), and one resumed from its checkpoint for 3 more
    steps, the gather raising too."""
    root = Path(str(inp["root"]))
    for name, kw in (
        ("dp", dict(coordinator_address=f"127.0.0.1:{int(inp['tcp_port'])}",
                    num_processes=world, process_id=rank)),
        ("gauss", dict(param_sharding="auto")),
        ("gauss_grow", dict(param_sharding="auto", iters=GROW_ITERS,
                            model=GROW_MODEL, vis="viewer", viewer_port=0,
                            **GROW_TRAINER)),
        ("gauss_resume", dict(param_sharding="auto", iters=GROW_ITERS + 3,
                              model=GROW_MODEL, load_dir=grow_ckpts(root),
                              **GROW_TRAINER)),
    ):
        whole = gs.gather_train_state
        if name.startswith("gauss_"):
            gs.gather_train_state = _no_whole_state
        try:
            trainer, ev = trainer_run(root, name, **kw)
        finally:
            gs.gather_train_state = whole
        out[name + "_eval_psnr"] = ev.get("eval_psnr", np.nan)
        out[name + "_world"] = trainer.world
        state = trainer.state
        if trainer.gauss_mesh is not None:
            state = gs.gather_train_state(state, trainer.gauss_mesh)
        out.update(_flat(state, name + "."))
        if trainer.viewer is not None:
            trainer.viewer.stop()
            out.update({f"{name}_viewer.{k}": getattr(
                trainer.viewer._scene, k).detach().numpy() for k in FIELD_NAMES})
        out[name + "_growth"] = json.dumps(trainer.growth_events)


def _random_state(capacity: int, seed: int, num_cameras=None):
    """A train state of ``capacity`` lanes at SH 1 from ``seed``: random
    parameters (0.7 of the lanes alive), moments, statistics and step."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=(capacity,) + shape).astype(np.float32)
    scene = scene_from_numpy(dict(
        means=f32(3), scales=f32(3) - 2.0, quats=f32(4), features_dc=f32(3),
        features_rest=f32(3, 3), opacities=f32(1),
        alive=rng.random(capacity) < 0.7), "cpu")
    state = init_train_state(scene, num_cameras=num_cameras)
    for t in (list(state.adam.mu.values()) + list(state.adam.nu.values())
              + list(state.refine)):
        t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)))
    state.step = torch.tensor(seed, dtype=torch.int32)
    return state


def case_refine(rank, world, inp, out):
    """The sharded refine against the replicated one on each case of
    ``inp["cases"]`` (JSON: name, VanillaConfig fields, train views, image
    size; the state under ``<name>.``): both drawing from a generator seeded
    alike (its state after the refine recorded), and the sharded one with
    gstk_tpu's noise (``<name>.noise``). Then the sharded growth against
    ``shard_train_state`` of the padded state (a doubling, and 24 lanes
    grown 1.5x and rounded to 64), a checkpoint written under sharding
    beside one process's, and capacities the ranks do not divide."""
    mesh = gs.make_gauss_mesh()
    # the collectives alone: rank p sends p + q + 1 rows (p, q, i) to rank
    # q; every rank's bool flags gathered on rank 0's host
    axis = mesh[gs.GAUSS_AXIS]
    rows = torch.tensor([[rank, q, i] for q in range(world)
                         for i in range(rank + q + 1)])
    out["exchange"] = axis.exchange(
        rows, [rank + q + 1 for q in range(world)],
        [p + rank + 1 for p in range(world)]).numpy()
    flags = axis.gather_to_host(torch.arange(5) % (rank + 2) == 0)
    out["gather_to_host"] = np.zeros(0) if flags is None else flags.numpy()
    for name, cfg_kw, num_train, img_size in json.loads(str(inp["cases"])):
        flat = {k[len(name) + 1:]: inp[k] for k in inp.files
                if k.startswith(name + ".")}
        noise = torch.from_numpy(flat.pop("noise"))
        cfg = VanillaConfig(**cfg_kw)
        for tag, kw in (("rep.", {}), ("shd.", dict(mesh=mesh)),
                        ("jax.", dict(mesh=mesh, noise=noise))):
            st = train_state_from_numpy(flat, "cpu")
            if "mesh" in kw:
                st = gs.shard_train_state(st, mesh)
            gen = torch.Generator().manual_seed(3)
            _, _, st.refine, info = refine(st.scene, st.adam, st.refine,
                                           st.step, cfg, num_train, img_size,
                                           generator=gen, **kw)
            if "mesh" in kw:
                st = gs.gather_train_state(st, mesh)
            out.update(_flat(st, f"{name}.{tag}"))
            out[f"{name}.{tag}info"] = np.asarray([int(info[k]) for k in INFO])
            out[f"{name}.{tag}gen"] = gen.get_state().numpy()

    for cap, new_cap in ((64, 128), (24, 64)):
        full = _random_state(cap, cap)
        out.update(_flat(gs.shard_train_state(
            gs.grow_train_state(full, new_cap), mesh), f"grow{cap}_ref."))
        out.update(_flat(gs.grow_train_state(
            gs.shard_train_state(full, mesh), new_cap, mesh), f"grow{cap}."))

    full = _random_state(64, 5, num_cameras=3)
    extras = {"isect_capacity": 8192, "bands": 2, "sh_degree": 1}
    written = save_checkpoint(inp["ckpt_dir"].item() + "/sharded",
                              gs.shard_train_state(full, mesh), extras=extras,
                              mesh=mesh)
    out["ckpt_written"] = written is not None
    if rank == 0:
        save_checkpoint(inp["ckpt_dir"].item() + "/one", full, extras=extras)

    shard = gs.shard_train_state(full, mesh)
    raised = []
    for fn in (lambda: gs.shard_train_state(_random_state(31, 1), mesh),
               lambda: gs.grow_train_state(shard, 2 * 64 + 1, mesh),
               lambda: refine(shard.scene, shard.adam, shard.refine, 100,
                              MODEL, 4, 64, noise=torch.zeros(2, 63, 3),
                              mesh=mesh)):
        try:
            fn()
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["indivisible_raised"] = np.asarray(raised)


def card_case(dev):
    """A 6000-Gaussian scene in 8192 lanes (SH 1), a 128x128 target and two
    cameras on ``dev``; returns (scene arrays, target, cameras, a step
    maker)."""
    rng = np.random.default_rng(0)
    n, cap, h, w = 6000, 8192, 128, 128
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                    rng.uniform(-7, -3, n)], -1)
    arrays = {
        "means": np.zeros((cap, 3)), "scales": np.full((cap, 3), -3.0),
        "quats": np.tile([1.0, 0, 0, 0], (cap, 1)),
        "features_dc": np.zeros((cap, 3)), "features_rest": np.zeros((cap, 3, 3)),
        "opacities": np.zeros((cap, 1)), "alive": np.zeros(cap, bool),
    }
    arrays["means"][:n] = pts
    arrays["scales"][:n] = rng.uniform(-4.0, -2.5, (n, 3))
    arrays["quats"][:n] = rng.normal(size=(n, 4))
    arrays["features_dc"][:n] = rng.normal(size=(n, 3))
    arrays["features_rest"][:n] = 0.1 * rng.normal(size=(n, 3, 3))
    arrays["opacities"][:n] = rng.uniform(-1, 2, (n, 1))
    arrays["alive"][:n] = True
    gt = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(np.float32)).to(dev)
    c2w = [np.eye(4, dtype=np.float32)[:3] for _ in range(2)]
    c2w[1][:, 3] = [0.1, -0.05, 0.2]
    cams = [Camera.create(110.0, 110.0, w / 2, h / 2, c, device=dev)
            for c in c2w]
    model = VanillaConfig(background_color="black", sh_degree=1)
    make = lambda **kw: make_train_step(model, RASTER, OptimizerConfig(), h, w,
                                        sh_degree=1, **kw)
    return arrays, gt, cams, make


def case_card(rank, world, inp, out):
    """2 gloo ranks on one CUDA card: the Gaussian-sharded step against the
    replicated step on the card, a DP step (rank r: camera r), and the
    Gaussian-sharded co-gs step with camera optimisation."""
    dev = torch.device("cuda")
    arrays, gt, cams, make = card_case(dev)
    mesh = gs.make_gauss_mesh()
    want = init_train_state(scene_from_numpy(arrays, dev))
    got = gs.shard_train_state(init_train_state(scene_from_numpy(arrays, dev)),
                               mesh)
    replicated, sharded = make(), make(mesh=mesh)
    for _ in range(2):
        want, _ = replicated(want, cams[1], gt)
        got, _ = sharded(got, cams[1], gt)
    out.update(_flat(want, "step_ref."))
    out.update(_flat(gs.gather_train_state(got, mesh), "step."))
    dp = data_parallel_train_step(make(axis_name=DATA_AXIS, mesh=get_mesh()),
                                  get_mesh())
    state, _ = dp(init_train_state(scene_from_numpy(arrays, dev)), cams[rank],
                  gt)
    out.update(_flat(state, "dp."))
    cam_opt_checks(mesh, lambda: scene_from_numpy(arrays, dev), cams,
                   [gt, gt], out)


def main():
    case, rank, world, io = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(1)
    inp = np.load(io / "in.npz")
    out = {}
    if case == "trainer":
        case_trainer(rank, world, inp, out)
    elif case == "card":  # gloo on the card: NCCL takes one rank a card
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{io / 'store'}",
                                world_size=world, rank=rank, timeout=TIMEOUT)
        case_card(rank, world, inp, out)
    else:
        initialize_distributed(f"file://{io / 'store'}", world, rank,
                               device="cpu", timeout=TIMEOUT)
        {"dp": case_dp, "mesh4": case_mesh4,
         "refine": case_refine}[case](rank, world, inp, out)
    dist.barrier()
    np.savez(io / f"out_{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
