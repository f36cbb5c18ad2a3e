"""The plain reference and the work counts against the port on the CPU,
at small sizes: renders, the intersections and the compositing pairs a
view needs, and the train step's loss and gradients. The tests import
both sides; the reference itself imports nothing of the port."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gsbench import scene as gscene
from gsbench import work
from gsbench.reference import splat as rsplat
from gsbench.reference import train as rtrain
from gsbench.reference.precision import Arith, round_tf32
from gsbench.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(4)
    root = tiny_root(tmp_path_factory.mktemp("tiny"))
    cfg = json.loads((root / "gsbench/configs/gs-1spp-30k.json").read_text())
    dev = torch.device("cpu")
    cap = gscene.capture(cfg, dev)
    params = gscene.draw_scene(cfg, cap, 12345, dev)
    return cfg, cap, params


def _views(cap, n=3):
    return [rsplat.View(cap.poses[int(i)], cap.fx, cap.fy, cap.cx, cap.cy,
                        cap.height, cap.width) for i in cap.eval[:n]]


def _port_scene(params):
    from gstk_torch.core.gaussians import GaussianScene

    return GaussianScene(**{k: v.clone() for k, v in params.items()})


@pytest.mark.parametrize("bands", [1, 2])
def test_render_matches_the_port(tiny, bands):
    from gstk_torch.core.cameras import Camera
    from gstk_torch.models.vanilla import render_scene
    from gstk_torch.ops.rasterize import RasterizeConfig

    cfg, cap, params = tiny
    scene = _port_scene(params)
    bg = torch.tensor([0.2, 0.3, 0.4])
    for view in _views(cap):
        cam = Camera.create(view.fx, view.fy, view.cx, view.cy, view.c2w)
        with torch.no_grad():
            got = render_scene(scene, cam, view.height, view.width, sh_degree=3,
                               background=bg, raster_config=RasterizeConfig(
                                   isect_capacity=1 << 16, bands=bands))
        ref = rsplat.render(params, view, 3, bg, bands, Arith())
        assert got["alpha"].max() > 0.5
        for a, b in ((got["rgb"], ref["rgb"]), (got["alpha"], ref["alpha"])):
            assert float((a - b).abs().mean()) < 1e-6
            assert float(((a - b).abs() > 1e-4).float().mean()) < 1e-3


@pytest.mark.parametrize("bands", [1, 2])
def test_work_counts_match_the_ports_walk(tiny, bands):
    """The reference's intersections and pairs needed equal the port's
    binning count and its plain compositor's entries evaluated."""
    from gstk_torch.core.cameras import Camera
    from gstk_torch.models.vanilla import splat_inputs
    from gstk_torch.ops.binning import bin_gaussians
    from gstk_torch.ops.rasterize import RasterizeConfig, band_rows, footprints, tile_counts
    from gstk_torch.ops.raster_cuda import composite_tiles_fwd_plain

    cfg, cap, params = tiny
    scene = _port_scene(params)
    rc = RasterizeConfig(isect_capacity=1 << 16, bands=bands)
    for view in _views(cap):
        cam = Camera.create(view.fx, view.fy, view.cx, view.cy, view.c2w)
        with torch.no_grad():
            inp = splat_inputs(scene, cam, view.height, view.width, sh_degree=3)
            ext, ok = footprints(inp["radii"], inp["conics"], inp["opacities"], rc)
            isects = visited = 0
            for y0, rows, h in band_rows(view.height, view.width, rc):
                xys = inp["xys"] - torch.tensor([0.0, float(y0)])
                counts = tile_counts(xys, ext, ok, (4, rows), 16)
                isect = bin_gaussians(xys, inp["depths"], ext, counts, (4, rows), 16,
                                      1 << 16, need_expansion=False)
                isects += int(isect.num_intersects)
                _, _, v = composite_tiles_fwd_plain(
                    xys, inp["conics"], inp["opacities"], inp["colors"],
                    isect.gaussian_ids, isect.tile_bins, (4, rows), 16)
                visited += int(v[:, :].reshape(rows, 4, 16, 16).permute(0, 2, 1, 3)
                               .reshape(rows * 16, 64)[:h].sum())
        p = work.analyse(params, view, 3, bands)
        assert p.intersections == isects
        assert p.pairs == visited
        assert p.alive == cfg["alive"] and p.lanes == cfg["capacity"]


def test_train_steps_match_the_port(tiny):
    """Three steps of the port's step function against the reference's:
    losses, first gradients and the change after three steps."""
    from gstk_torch.core.cameras import Camera
    from gstk_torch.models.vanilla import VanillaConfig
    from gstk_torch.ops.rasterize import RasterizeConfig
    from gstk_torch.train.optim import OptimizerConfig
    from gstk_torch.train.step import init_train_state, make_train_step

    cfg, cap, params = tiny
    state = init_train_state(_port_scene(params))
    state.step.fill_(12000)
    step = make_train_step(VanillaConfig(), RasterizeConfig(isect_capacity=1 << 16, bands=2),
                           OptimizerConfig(), cap.height, cap.width, 3)
    views = [rsplat.View(cap.poses[int(i)], cap.fx, cap.fy, cap.cx, cap.cy,
                         cap.height, cap.width) for i in cap.train[:3]]
    targets = [gscene.target(cap, int(i), params, *gscene.target_noise(cfg))
               for i in cap.train[:3]]
    gen = torch.Generator().manual_seed(5)
    losses = []
    for i, (v, t) in enumerate(zip(views, targets)):
        cam = Camera.create(v.fx, v.fy, v.cx, v.cy, v.c2w)
        state, m = step(state, cam, t.float() / torch.full((), 255.0), gen)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {k: float(torch.linalg.norm(mu.double()) / (1 - rtrain.B1))
                     for k, mu in state.adam.mu.items()}
    change = {k: float(torch.linalg.norm((getattr(state.scene, k).detach()
                                           - params[k]).double())) for k in rtrain.GROUPS}
    gen = torch.Generator().manual_seed(5)
    bgs = [torch.rand(3, generator=gen) for _ in views]
    ref = rtrain.run_steps(params, views, targets, bgs, 12000, 3, 2, Arith())
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k in rtrain.GROUPS:
        assert grads[k] == pytest.approx(ref["grad_norms"][k], rel=1e-4)
        assert change[k] == pytest.approx(ref["change_norms"][k], rel=1e-4)
        assert ref["grad_norms"][k] > 0 and ref["change_norms"][k] > 0


@pytest.mark.parametrize("step", [12100, 2900])
def test_cull_matches_the_ports_refine(tiny, step):
    """The reference's cull against the port's refine past densification:
    Gaussians under the opacity threshold, and (past the first opacity
    reset) over the world size, go; before ``stop_split_at`` the reference
    refuses, since the refine then densifies."""
    from gstk_torch.models.vanilla import VanillaConfig
    from gstk_torch.train.step import init_train_state
    from gstk_torch.train.strategy import refine

    cfg, cap, params = tiny
    params = {k: v.clone() for k, v in params.items()}
    lanes = torch.nonzero(params["alive"])[:, 0]
    params["opacities"][lanes[:40], 0] = torch.linspace(-4.0, 0.0, 40)
    params["scales"][lanes[40:50], 1] = torch.linspace(-1.5, 0.0, 10)
    params["alive"][lanes[50]] = False
    params["opacities"][lanes[50], 0] = -9.0
    mcfg = VanillaConfig()
    assert (rtrain.CULL_ALPHA, rtrain.CULL_SCALE) == (mcfg.cull_alpha_thresh,
                                                      mcfg.cull_scale_thresh)
    assert (rtrain.REFINE_EVERY, rtrain.RESET_ALPHA_EVERY, rtrain.STOP_SPLIT_AT) == (
        mcfg.refine_every, mcfg.reset_alpha_every, mcfg.stop_split_at)
    if step < rtrain.STOP_SPLIT_AT:
        with pytest.raises(ValueError):
            rtrain.cull(dict(params), step)
        return
    state = init_train_state(_port_scene(params))
    refine(state.scene, state.adam, state.refine, step, mcfg, len(cap.train),
           cap.width, generator=torch.Generator().manual_seed(1))
    ref = dict(params)
    rtrain.cull(ref, step)
    assert 0 < int((params["alive"] & ~ref["alive"]).sum()) < 60
    assert torch.equal(state.scene.alive, ref["alive"])
    for fault in ("cull_none", "cull_logit"):
        bad = dict(params)
        rtrain.cull(bad, step, fault)
        assert not torch.equal(bad["alive"], ref["alive"])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0000002, 1e-30])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10 and r[2] == 1.0
    assert r[3] == -3.0
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    y = x.clone().requires_grad_()
    round_tf32(y).sum().backward()
    assert torch.equal(y.grad, torch.ones_like(x))
