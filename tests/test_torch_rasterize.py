"""gstk_torch compositing (the plain twin of kernel K1) and rasterize against
gstk_tpu's compositing forward, its Pallas kernel in interpret mode, and the
numpy oracle, at ch = 3 and 4 and with bands = 1 and 2.

Tolerances are gstk_tpu's parity tolerances (utils/parity.py): rtol 1e-3,
atol 1e-4 on images and alpha. The break at T <= 1e-4 is computed by a
cumprod here and in gstk_tpu's JAX path, in log space in its Pallas kernel
and sequentially in the oracle, so a pixel within rounding of the threshold
may stop one entry apart; that stays inside these tolerances.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.ops import binning as jbin
from gstk_tpu.ops import oracle
from gstk_tpu.ops import projection as jproj
from gstk_torch.ops import raster_cuda

from tests._scenes import make_camera, make_gaussians

# the packages' ops/__init__ re-export the rasterize function under the
# module's name
jras = importlib.import_module("gstk_tpu.ops.rasterize")
tras = importlib.import_module("gstk_torch.ops.rasterize")

torch.set_num_threads(2)

PARITY = dict(rtol=1e-3, atol=1e-4)


def _scene(rng, ch, n=300):
    """gstk_tpu projection outputs + colors (ch) + opacities, as numpy."""
    cam = make_camera()
    means, scales, quats, colors, opac = make_gaussians(rng, n)
    out = jproj.project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats),
        jnp.asarray(cam["viewmat"]), jnp.asarray(cam["fullmat"]),
        cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["img_h"], cam["img_w"],
    )
    if ch == 4:  # depth as the 4th channel, as render_scene composites it
        colors = np.concatenate([colors, np.asarray(out.depths)[:, None]], 1)
    proj = {k: np.array(getattr(out, k)) for k in
            ("xys", "depths", "radii", "conics", "num_tiles_hit")}
    return proj, colors.astype(np.float32), opac, cam


@pytest.mark.parametrize("ch", [3, 4])
def test_composite_plain_matches_jax_forward(rng, ch):
    proj, colors, opac, cam = _scene(rng, ch)
    tiles = ((cam["img_w"] + 15) // 16, (cam["img_h"] + 15) // 16)
    isect = jbin.bin_gaussians(
        jnp.asarray(proj["xys"]), jnp.asarray(proj["depths"]),
        jnp.asarray(proj["radii"]), jnp.asarray(proj["num_tiles_hit"]),
        tiles, 16, 1 << 13, need_expansion=False,
    )
    n = colors.shape[0]
    acc_j, t_j = jras._make_composite(tiles, 16, 32)(
        jnp.asarray(proj["xys"]), jnp.asarray(proj["conics"]), jnp.asarray(colors),
        jnp.asarray(opac), jnp.minimum(isect.gaussian_ids, n - 1), isect.tile_bins,
    )
    t = lambda x: torch.from_numpy(np.array(x))
    acc, final_t, visited = raster_cuda.composite_tiles_fwd_plain(
        t(proj["xys"]), t(proj["conics"]), t(opac), t(colors),
        t(isect.gaussian_ids), t(isect.tile_bins), tiles,
    )
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), **PARITY)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(t_j), **PARITY)
    counts = np.diff(np.asarray(isect.tile_bins), axis=1)[:, 0]
    assert (visited.numpy() <= counts[:, None]).all() and visited.sum() > 0


@pytest.mark.parametrize("bands", [1, 2])
@pytest.mark.parametrize("ch", [3, 4])
def test_rasterize_matches_jax_pallas_and_oracle(rng, ch, bands):
    proj, colors, opac, cam = _scene(rng, ch)
    h, w = cam["img_h"], cam["img_w"]
    bg = rng.uniform(0, 1, ch).astype(np.float32)
    jargs = [jnp.asarray(proj[k]) for k in ("xys", "depths", "radii", "conics",
                                            "num_tiles_hit")]
    img_j, alpha_j, info_j = jras.rasterize(
        *jargs, jnp.asarray(colors), jnp.asarray(opac), h, w,
        background=jnp.asarray(bg), return_info=True,
        config=jras.RasterizeConfig(
            isect_capacity=1 << 13, bands=bands, backend="pallas_interpret"
        ),
    )
    targs = [torch.from_numpy(proj[k]) for k in ("xys", "depths", "radii",
                                                 "conics", "num_tiles_hit")]
    img, alpha, info = tras.rasterize(
        *targs, torch.from_numpy(colors), torch.from_numpy(opac), h, w,
        background=torch.from_numpy(bg), return_info=True,
        config=tras.RasterizeConfig(isect_capacity=1 << 13, bands=bands),
    )
    assert img.shape == (h, w, ch) and alpha.shape == (h, w)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), **PARITY)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_j), **PARITY)
    assert int(info["num_intersects"]) == int(info_j["num_intersects"])

    # the numpy oracle: square-radius binning, sequential compositing
    tiles = ((w + 15) // 16, (h + 15) // 16)
    gids, _, bins = oracle.bin_gaussians_np(
        proj["xys"], proj["depths"], proj["radii"], tiles, 16
    )
    img_o, t_o = oracle.rasterize_np(
        h, w, gids, bins, proj["xys"], proj["conics"], colors, opac, bg
    )
    np.testing.assert_allclose(img.numpy(), img_o, **PARITY)
    np.testing.assert_allclose(alpha.numpy(), 1.0 - t_o, **PARITY)


def test_rasterize_is_forward_only(rng):
    """``forward_only=True`` renders without the expansion permutation, and
    differentiating it raises with gstk_tpu's message."""
    proj, colors, opac, cam = _scene(rng, 3, n=20)
    targs = [torch.from_numpy(proj[k]) for k in ("xys", "depths", "radii",
                                                 "conics", "num_tiles_hit")]
    colors_t = torch.from_numpy(colors).requires_grad_()
    cfg = tras.RasterizeConfig(forward_only=True)
    img, _ = tras.rasterize(*targs, colors_t, torch.from_numpy(opac),
                            cam["img_h"], cam["img_w"], config=cfg)
    with pytest.raises(ValueError, match="forward_only=True skips"):
        torch.autograd.grad(img.sum(), colors_t)
    with torch.no_grad():
        img_ng, _ = tras.rasterize(*targs, colors_t, torch.from_numpy(opac),
                                   cam["img_h"], cam["img_w"], config=cfg)
    assert torch.isfinite(img_ng).all() and torch.equal(img_ng, img.detach())
