"""The co-gs depth-loss zoo (``gstk_torch/utils/losses.py``) and
``gstk_torch/models/depth.py::depth_loss_terms`` against gstk_tpu's on the
CPU, at 48x64.

Inputs come from a numpy seed: a predicted depth in [1, 5] with a constant
band (ties in every finite difference, as the background fill gives), a
GT depth with zeros (invalid pixels) and pixels equal to the prediction
(ties in ``|pred - gt|``), an image, mono scale and shift, opacity logits
with dead and saturated lanes. The Pearson and planar patch origins are the
ones gstk_tpu draws from its key, passed to the port. Each value is held
at rtol 1e-3 / atol 1e-4 and each gradient at rtol 5e-3 / atol 1e-4
max|g| (``gstk_tpu/utils/parity.py``'s image and gradient tolerances).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.models import depth as jdepth
from gstk_tpu.utils import losses as jlosses
from gstk_torch.models import depth as tdepth
from gstk_torch.utils import losses as tlosses

torch.set_num_threads(2)

H, W = 48, 64
FX, FY, CX, CY = 55.0, 57.0, 31.5, 23.5
RTOL_IMG, ATOL_IMG, RTOL_GRAD = 1e-3, 1e-4, 5e-3


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(1.0, 5.0, (H, W)).astype(np.float32)
    pred[:, 40:48] = 3.0  # a constant band: ties in the differences
    gt = (pred + rng.normal(0.0, 0.3, (H, W))).astype(np.float32)
    gt[rng.uniform(size=(H, W)) < 0.2] = 0.0  # invalid
    tie = rng.uniform(size=(H, W)) < 0.1
    gt[tie] = pred[tie]  # |pred - gt| at 0
    img = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    mask = rng.uniform(size=(H, W)) < 0.85
    return pred, gt, img, mask


def _close(name, got, want, rtol=RTOL_IMG, atol=ATOL_IMG):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _grad_close(name, got, want):
    want = np.asarray(want)
    _close(name, got, want, RTOL_GRAD, 1e-4 * max(np.abs(want).max(), 1e-30))


def _origins(key, n, size):
    """The origins gstk_tpu's local losses draw from ``key``."""
    kx, ky = jax.random.split(key)
    x0 = jax.random.randint(kx, (n,), 0, max(W - size, 1))
    y0 = jax.random.randint(ky, (n,), 0, max(H - size, 1))
    return torch.from_numpy(np.array(x0)), torch.from_numpy(np.array(y0))


KEY = jax.random.PRNGKey(3)
# name -> (gstk_tpu function of the prediction, the port's)
ZOO = {
    "total_variation": (
        lambda p, g, i: jlosses.total_variation(p),
        lambda p, g, i: tlosses.total_variation(p)),
    "total_variation_hwc": (
        lambda p, g, i: jlosses.total_variation(p[..., None] * i),
        lambda p, g, i: tlosses.total_variation(p[..., None] * i)),
    "depth_l1": (
        lambda p, g, i: jlosses.depth_l1(p, g),
        lambda p, g, i: tlosses.depth_l1(p, g)),
    "depth_l1_valid": (
        lambda p, g, i: jlosses.depth_l1(p, g, valid=i[..., 0] > 0.3),
        lambda p, g, i: tlosses.depth_l1(p, g, valid=i[..., 0] > 0.3)),
    "pearson_corr_loss": (
        lambda p, g, i: jlosses.pearson_corr_loss(p, g),
        lambda p, g, i: tlosses.pearson_corr_loss(p, g)),
    "local_pearson_loss": (
        lambda p, g, i: jlosses.local_pearson_loss(p, g, box_size=24, key=KEY),
        lambda p, g, i: tlosses.local_pearson_loss(
            p, g, box_size=24, origins=_origins(KEY, 8, 24))),
    "log_depth_gradient_loss": (
        lambda p, g, i: jlosses.log_depth_gradient_loss(p, g, i, 0.8, 0.3),
        lambda p, g, i: tlosses.log_depth_gradient_loss(p, g, i, 0.8, 0.3)),
    "local_planar_loss": (
        lambda p, g, i: jlosses.local_planar_loss(
            p, FX, FY, CX, CY, KEY, patch_size=16),
        lambda p, g, i: tlosses.local_planar_loss(
            p, FX, FY, CX, CY, patch_size=16, origins=_origins(KEY, 16, 16))),
    "edge_aware_smooth_loss": (
        lambda p, g, i: jlosses.edge_aware_smooth_loss(p, i),
        lambda p, g, i: tlosses.edge_aware_smooth_loss(p, i)),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_matches_jax(name):
    """Value and gradient by the prediction (and, where it enters, the
    GT), against gstk_tpu's."""
    jfn, tfn = ZOO[name]
    pred, gt, img, _ = _inputs()
    jval, (jgp, jgg) = jax.value_and_grad(
        lambda p, g: jfn(p, g, jnp.asarray(img)), argnums=(0, 1)
    )(jnp.asarray(pred), jnp.asarray(gt))
    p = torch.tensor(pred, requires_grad=True)
    g = torch.tensor(gt, requires_grad=True)
    val = tfn(p, g, torch.from_numpy(img))
    gp, gg = torch.autograd.grad(val, [p, g], allow_unused=True)
    _close(f"{name} value", float(val.detach()), float(jval))
    _grad_close(f"{name} grad pred", gp.numpy(), jgp)
    _grad_close(f"{name} grad gt",
                np.zeros_like(gt) if gg is None else gg.numpy(), jgg)


def test_sparse_opacity_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0.0, 3.0, 500).astype(np.float32)
    logits[:20] = -30.0  # sigmoid under 1e-6: clipped, no gradient
    logits[20:40] = 30.0  # over 1 - 1e-6
    alive = rng.uniform(size=500) < 0.8
    jval, jg = jax.value_and_grad(
        lambda x: jlosses.sparse_opacity_loss(jax.nn.sigmoid(x),
                                              jnp.asarray(alive))
    )(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    val = tlosses.sparse_opacity_loss(torch.sigmoid(x), torch.from_numpy(alive))
    (g,) = torch.autograd.grad(val, [x])
    _close("sparse value", float(val.detach()), float(jval))
    _grad_close("sparse grad", g.numpy(), jg)
    assert not g[:20].any()


def test_patch_origins_bounds_and_generator():
    """Origins drawn from a generator lie where gstk_tpu's can (x in [0,
    max(W - size, 1)), y likewise), the same seed draws the same origins,
    and a draw without a generator raises; a patch past the edge is moved
    inside, as ``lax.dynamic_slice`` moves it."""
    gen = lambda: torch.Generator().manual_seed(5)
    x0, y0 = tlosses.patch_origins(1000, 24, (H, W), gen(), "cpu")
    assert 0 <= int(x0.min()) and int(x0.max()) < W - 24
    assert 0 <= int(y0.min()) and int(y0.max()) < H - 24
    x1, y1 = tlosses.patch_origins(1000, 24, (H, W), gen(), "cpu")
    assert torch.equal(x0, x1) and torch.equal(y0, y1)
    with pytest.raises(ValueError, match="generator"):
        tlosses.patch_origins(4, 24, (H, W), None, "cpu")
    depth = np.random.default_rng(2).uniform(1, 5, (H, W)).astype(np.float32)
    want = jax.lax.dynamic_slice(jnp.asarray(depth), (40, 60), (16, 16))
    got = tlosses._patches(torch.from_numpy(depth),
                           (torch.tensor([60]), torch.tensor([40])), 16)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# config name -> (DepthConfig fields, steps before / inside / after the gates)
TERMS = {
    "sensor": (dict(depth_loss_start_iteration=10, use_sparse_loss=True),
               (0, 10, 11, 100, 30_000)),
    "mono": (dict(depth_loss_start_iteration=10, depth_loss_stop_iteration=30,
                  use_est_depth=True, use_pearson_depth=True,
                  use_scaled_est_depth=True, use_depth_regularization=True,
                  using_tv_loss=True, local_patch_size=32),
             (10, 20, 30, 20_000)),
    "planar": (dict(depth_loss_start_iteration=5, using_planar_loss=True,
                    planar_loss_start_iteration=10, local_patch_size=32),
               (5, 10, 11)),
}


@pytest.mark.parametrize("case", list(TERMS))
@pytest.mark.parametrize("masked", [False, True])
def test_depth_loss_terms_match_jax(case, masked):
    """Every term, and the gradients of their sum by the prediction and
    the opacity logits, at steps before, inside and after the gates."""
    fields, steps = TERMS[case]
    jcfg, tcfg = jdepth.DepthConfig(**fields), tdepth.DepthConfig(**fields)
    pred, gt, img, mask = _inputs(seed=4)
    rng = np.random.default_rng(5)
    logits = rng.normal(0.0, 2.0, (300, 1)).astype(np.float32)
    alive = rng.uniform(size=300) < 0.9
    scale, shift = np.float32(0.9), np.float32(0.2)
    camera = types.SimpleNamespace(fx=FX, fy=FY, cx=CX, cy=CY)
    key = jax.random.PRNGKey(11)
    # the origins gstk_tpu's depth_loss_terms draws from its key
    box = min(tcfg.local_patch_size, min(H, W) - 1)
    patch = min(tcfg.local_patch_size, min(H, W) // 2)
    pearson = _origins(jax.random.split(key)[0], 8, box)
    planar = _origins(key, 16, patch)
    m = mask if masked else None
    for step in steps:
        def jterms(p, lg):
            scene = types.SimpleNamespace(opacities=lg, alive=jnp.asarray(alive))
            return jdepth.depth_loss_terms(
                jcfg, jnp.int32(step), p, jnp.asarray(gt), jnp.asarray(img),
                scene, key, mask=None if m is None else jnp.asarray(m),
                mono_scale=jnp.float32(scale), mono_shift=jnp.float32(shift),
                camera=camera)

        jout = jterms(jnp.asarray(pred), jnp.asarray(logits))
        jgp, jgl = jax.grad(lambda p, lg: sum(jterms(p, lg).values()),
                            argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(logits))
        p = torch.tensor(pred, requires_grad=True)
        lg = torch.tensor(logits, requires_grad=True)
        scene = types.SimpleNamespace(opacities=lg, alive=torch.from_numpy(alive))
        tout = tdepth.depth_loss_terms(
            tcfg, torch.tensor(step, dtype=torch.int32), p, torch.from_numpy(gt),
            torch.from_numpy(img), scene,
            mask=None if m is None else torch.from_numpy(m),
            mono_scale=torch.tensor(scale), mono_shift=torch.tensor(shift),
            camera=camera, pearson_origins=pearson, planar_origins=planar)
        assert list(tout) == list(jout), (step, list(tout), list(jout))
        for k in jout:
            _close(f"{case} step {step} {k}", float(tout[k].detach()),
                   float(jout[k]))
        gp, gl = torch.autograd.grad(sum(tout.values()), [p, lg],
                                     allow_unused=True)
        _grad_close(f"{case} step {step} grad pred", gp.numpy(), jgp)
        _grad_close(f"{case} step {step} grad logits",
                    np.zeros_like(logits) if gl is None else gl.numpy(), jgl)


def test_depth_loss_terms_draw_from_the_generator():
    """Without origins the Pearson patches are drawn first, then the
    planar ones, from the one generator; gates are tensors, so the step
    counter never leaves the device."""
    cfg = tdepth.DepthConfig(
        depth_loss_start_iteration=0, use_est_depth=True,
        use_pearson_depth=True, using_planar_loss=True,
        planar_loss_start_iteration=0, local_patch_size=32)
    pred, gt, img, _ = _inputs()
    scene = types.SimpleNamespace(opacities=torch.zeros(4, 1),
                                  alive=torch.ones(4, dtype=torch.bool))
    camera = types.SimpleNamespace(fx=FX, fy=FY, cx=CX, cy=CY)
    args = (cfg, torch.tensor(3, dtype=torch.int32), torch.from_numpy(pred),
            torch.from_numpy(gt), torch.from_numpy(img), scene)
    got = tdepth.depth_loss_terms(*args, torch.Generator().manual_seed(9),
                                  camera=camera)
    gen = torch.Generator().manual_seed(9)
    pearson = tlosses.patch_origins(8, 32, (H, W), gen, "cpu")
    planar = tlosses.patch_origins(16, 24, (H, W), gen, "cpu")
    want = tdepth.depth_loss_terms(*args, camera=camera,
                                   pearson_origins=pearson,
                                   planar_origins=planar)
    assert list(got) == ["depth_local_pearson", "planar_loss"]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="generator"):
        tdepth.depth_loss_terms(*args, camera=camera)
