"""gstk_torch's rasterize backward (the plain twins of kernels K2 and K4,
through the compositing autograd Function) against gstk_tpu's, and the
binning expansion permutation against gstk_tpu's.

Both packages get the same projected inputs (gstk_tpu's projection, as
numpy), so only rasterization is compared. The loss is ``sum(img * w) +
sum(alpha * w_a)`` with ``w`` and ``w_a`` from the rng, which covers the
alpha cotangent path. Gradients for xys, conics, colors, opacities and the
background are held to ``check_pallas_parity``'s gradient tolerance (rtol
5e-3) with atol 1e-4 max|g|: the transmittance is a cumprod in the twin and
in gstk_tpu's JAX path, a log-space sum in its Pallas kernel, and the
per-Gaussian sums run in other orders.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.ops import binning as jbin
from gstk_tpu.ops import projection as jproj
from gstk_torch.ops import binning as tbin
from gstk_torch.ops import raster_cuda, segment_kernel

from tests._scenes import make_camera, make_gaussians

jras = importlib.import_module("gstk_tpu.ops.rasterize")
tras = importlib.import_module("gstk_torch.ops.rasterize")

torch.set_num_threads(2)

RTOL_GRAD = 5e-3
NAMES = ("xys", "conics", "colors", "opacities", "bg")


def _scene(rng, n, img_w, img_h, opaque=False):
    """gstk_tpu projection outputs, colors and opacities as numpy."""
    cam = make_camera(img_w=img_w, img_h=img_h)
    means, scales, quats, colors, opac = make_gaussians(rng, n)
    if opaque:
        opac = np.full(n, 0.99, np.float32)
    out = jproj.project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats),
        jnp.asarray(cam["viewmat"]), jnp.asarray(cam["fullmat"]),
        cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["img_h"], cam["img_w"],
    )
    proj = {k: np.array(getattr(out, k)) for k in
            ("xys", "depths", "radii", "conics", "num_tiles_hit")}
    return proj, colors, opac


def _grads_both(proj, colors, opac, h, w, jcfg, tcfg, seed):
    """(loss, grads) of both packages for the weighted image+alpha loss."""
    r = np.random.default_rng(seed)
    ch = colors.shape[1]
    w_img = r.normal(size=(h, w, ch)).astype(np.float32)
    w_a = r.normal(size=(h, w)).astype(np.float32)
    bg = r.uniform(0, 1, ch).astype(np.float32)
    fixed = ("depths", "radii", "num_tiles_hit")

    def jloss(xys, conics, cols, op, b):
        img, alpha = jras.rasterize(
            xys, jnp.asarray(proj["depths"]), jnp.asarray(proj["radii"]),
            conics, jnp.asarray(proj["num_tiles_hit"]), cols, op, h, w,
            background=b, config=jcfg,
        )
        return jnp.sum(img * w_img) + jnp.sum(alpha * w_a)

    jargs = (proj["xys"], proj["conics"], colors, opac, bg)
    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in jargs]
    )
    targs = [torch.tensor(a, requires_grad=True) for a in jargs]
    img, alpha = tras.rasterize(
        targs[0], torch.from_numpy(proj[fixed[0]]),
        torch.from_numpy(proj[fixed[1]]), targs[1],
        torch.from_numpy(proj[fixed[2]]), targs[2], targs[3], h, w,
        background=targs[4], config=tcfg,
    )
    tval = (img * torch.from_numpy(w_img)).sum() + (alpha * torch.from_numpy(w_a)).sum()
    tgrads = torch.autograd.grad(tval, targs)
    return (float(jval), [np.asarray(g) for g in jgrads],
            float(tval.detach()), [g.numpy() for g in tgrads])


def _assert_grads(jgrads, tgrads):
    for name, a, b in zip(NAMES, jgrads, tgrads):
        assert b.shape == a.shape and np.isfinite(b).all(), name
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(
            b, a, rtol=RTOL_GRAD, atol=1e-4 * np.abs(a).max(), err_msg=name
        )


@pytest.mark.parametrize("opaque", [False, True])
def test_rasterize_grads_match_jax_pallas_interpret(rng, opaque):
    """tests/test_raster_pallas_bwd.py's scene (n = 120, 64x48, capacity
    1<<13) against gstk_tpu's Pallas kernels in interpret mode; opaque
    (opacity 0.99) tiles stop early."""
    h, w = 48, 64
    proj, colors, opac = _scene(rng, 120, w, h, opaque=opaque)
    launches = (raster_cuda.composite_tiles_bwd.launches,
                segment_kernel.segment_sum_sorted.launches)
    jval, jgrads, tval, tgrads = _grads_both(
        proj, colors, opac, h, w,
        jras.RasterizeConfig(isect_capacity=1 << 13, backend="pallas_interpret"),
        tras.RasterizeConfig(isect_capacity=1 << 13), seed=1,
    )
    np.testing.assert_allclose(tval, jval, rtol=1e-4)
    _assert_grads(jgrads, tgrads)
    # CPU tensors take the twins: nothing was launched
    assert (raster_cuda.composite_tiles_bwd.launches,
            segment_kernel.segment_sum_sorted.launches) == launches


def test_chunk_size_reaches_the_twins_on_cpu(rng, monkeypatch):
    """Under the default ``"auto"`` backend, CPU tensors take the twins of
    K1 and K2, and both walk ``RasterizeConfig.chunk_size`` entries a
    step."""
    h, w = 48, 64
    proj, colors, opac = _scene(rng, 120, w, h)
    chunks = []

    def spy(twin):
        def run(*args, chunk):
            chunks.append((twin.__name__, chunk))
            return twin(*args, chunk=chunk)
        return run

    for name in ("composite_tiles_fwd_plain", "composite_tiles_bwd_plain"):
        monkeypatch.setattr(tras, name, spy(getattr(raster_cuda, name)))
    xys = torch.tensor(proj["xys"], requires_grad=True)
    img, _ = tras.rasterize(
        xys, torch.from_numpy(proj["depths"]), torch.from_numpy(proj["radii"]),
        torch.from_numpy(proj["conics"]),
        torch.from_numpy(proj["num_tiles_hit"]), torch.from_numpy(colors),
        torch.from_numpy(opac), h, w,
        config=tras.RasterizeConfig(isect_capacity=1 << 13, chunk_size=16),
    )
    torch.autograd.grad(img.sum(), xys)
    assert chunks == [("composite_tiles_fwd_plain", 16),
                      ("composite_tiles_bwd_plain", 16)]


@pytest.mark.parametrize("bands", [1, 2])
def test_rasterize_grads_match_jax_on_parity_scene(bands):
    """gstk_tpu/utils/parity.py's scene (2000 Gaussians, 96x128, seed 0)
    against gstk_tpu's JAX path, in one band and in two (the gradients of
    the bands add through autograd); ch = 4 as render_scene composites."""
    rng = np.random.default_rng(0)
    h, w = 96, 128
    proj, colors, opac = _scene(rng, 2000, w, h)
    colors = np.concatenate([colors, proj["depths"][:, None]], 1)
    jval, jgrads, tval, tgrads = _grads_both(
        proj, colors, opac, h, w,
        jras.RasterizeConfig(isect_capacity=1 << 15, bands=bands, backend="jax"),
        tras.RasterizeConfig(isect_capacity=1 << 15, bands=bands), seed=2,
    )
    np.testing.assert_allclose(tval, jval, rtol=1e-4)
    _assert_grads(jgrads, tgrads)


@pytest.mark.parametrize("capacity", [1 << 13, 97], ids=["fits", "overflow"])
def test_expansion_ids_and_positions_identical_to_jax(rng, capacity):
    proj, _, opac = _scene(rng, 300, 64, 48)
    tiles = (4, 3)
    ext = jproj.tight_extents(jnp.asarray(proj["conics"]), jnp.asarray(opac),
                              jnp.asarray(proj["radii"]))
    tmin, tmax = jproj.tile_bbox(jnp.asarray(proj["xys"]), ext, tiles, 16)
    area = (tmax[:, 0] - tmin[:, 0]) * (tmax[:, 1] - tmin[:, 1])
    counts = jnp.where((ext[:, 0] > 0) & (ext[:, 1] > 0), area, 0)
    arrays = [proj["xys"], proj["depths"], np.array(ext), np.array(counts)]
    ref = jbin.bin_gaussians(*[jnp.asarray(a) for a in arrays], tiles, 16,
                             capacity, need_expansion=True)
    got = tbin.bin_gaussians(*[torch.from_numpy(a) for a in arrays], tiles,
                             16, capacity)
    assert (int(ref.num_intersects) > capacity) == (capacity == 97)
    np.testing.assert_array_equal(got.expansion_ids.numpy(),
                                  np.asarray(ref.expansion_ids))
    np.testing.assert_array_equal(tbin.expansion_positions(got).numpy(),
                                  np.asarray(jbin.expansion_positions(ref)))
    assert got.expansion_ids.dtype == torch.int32
    render_only = tbin.bin_gaussians(*[torch.from_numpy(a) for a in arrays],
                                     tiles, 16, capacity, need_expansion=False)
    assert render_only.expansion_ids is None
    assert torch.equal(render_only.gaussian_ids, got.gaussian_ids)

