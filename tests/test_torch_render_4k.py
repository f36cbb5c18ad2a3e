"""The 4K banded render (``gstk_torch/tools/bench_render_4k.py``, the
port of ``tools/bench_render_4k.py``) against gstk_tpu on the CPU.

Tolerances: the scene equal to ``tests/_scenes.py``'s bit for bit; the
band count, each band's intersection count and the total equal to the
count of gstk_tpu's own band loop at the full point (300k Gaussians,
projection and counting only) and at 2,000 Gaussians (binned);
the frame at 2,000 Gaussians within rtol 1e-3 / atol 1e-4 of gstk_tpu's
with 0.1% of the values outside (ROADMAP Queue 3 item 1: the 1/255
cutoff), and ``Renderer.render`` of its checkpoint the same.
"""

import importlib
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from gstk_tpu.ops.projection import project_gaussians as jproject
from gstk_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gstk_torch.ops.rasterize import band_rows
from gstk_torch.render.renderer import Renderer
from gstk_torch.tools import bench_render_4k as b4k

from tests import _scenes

torch.set_num_threads(2)

PARITY = dict(rtol=1e-3, atol=1e-4)
# the module (``gstk_tpu.ops`` exports its ``rasterize`` function under
# the module's name)
jraster = importlib.import_module("gstk_tpu.ops.rasterize")


def _jax_rasterize(jproj, arrays, monkeypatch, count_only=False):
    """gstk_tpu's ``rasterize`` of ``jproj`` with ``bands=0`` at 4K, and
    each band's (pixel rows, intersection count) as its own band loop
    hands them to ``_rasterize_band``. With ``count_only`` a band is
    counted as ``bin_gaussians`` counts it (the sum of its per-Gaussian
    tile counts) and not composited."""
    real = jraster._rasterize_band
    seen = []

    def band(xys, depths, ext, conics, counts, colors, opacities,
             img_height, img_width, config, backend):
        if count_only:
            n = int(np.asarray(counts, np.int64).sum())
            seen.append((img_height, n))
            return (jnp.zeros((img_height, img_width, colors.shape[-1])),
                    jnp.ones((img_height, img_width)), jnp.int32(n))
        out = real(xys, depths, ext, conics, counts, colors, opacities,
                   img_height, img_width, config, backend)
        seen.append((img_height, int(out[2])))
        return out

    monkeypatch.setattr(jraster, "_rasterize_band", band)
    img, alpha, info = jraster.rasterize(
        jproj.xys, jproj.depths, jproj.radii, jproj.conics,
        jproj.num_tiles_hit,
        jnp.concatenate([jnp.asarray(arrays[3]), jproj.depths[:, None]], -1),
        jnp.asarray(arrays[4]), img_height=b4k.H, img_width=b4k.W,
        background=jnp.zeros(4),
        config=JRasterizeConfig(isect_capacity=b4k.ISECT_CAPACITY, bands=0,
                                backend="jax", forward_only=True),
        return_info=True)
    return img, alpha, info, seen


def _jax_projection(cam, arrays):
    means, scales, quats, _, _ = arrays
    return jproject(jnp.asarray(means), jnp.asarray(scales), 1.0,
                    jnp.asarray(quats), jnp.asarray(cam["viewmat"]),
                    jnp.asarray(cam["fullmat"]), cam["fx"], cam["fy"],
                    cam["cx"], cam["cy"], cam["img_h"], cam["img_w"])


def test_4k_point_bands_match_jax(monkeypatch):
    """``bench_render_4k``'s point at full size (300k Gaussians,
    3840x2160, ``bands=0``), projection and counting only: gstk_tpu's
    ``rasterize`` forms 13 bands, and the port's bands have its rows, its
    per-band intersection counts and its total, to the count."""
    cam, arrays = b4k.scene_arrays()
    ref_cam = _scenes.make_camera(img_w=b4k.W, img_h=b4k.H)
    ref = _scenes.make_gaussians(np.random.default_rng(3), b4k.N_GAUSSIANS)
    for a, b in zip(arrays, (*ref[:1], (ref[1] * 0.08).astype(np.float32),
                             *ref[2:])):
        np.testing.assert_array_equal(a, b)
    for k in ("viewmat", "projmat", "fullmat"):
        np.testing.assert_array_equal(cam[k], ref_cam[k])
    assert JRasterizeConfig(bands=0).bands == b4k.CONFIG.bands == 0
    proj = b4k.project(cam, arrays, "cpu")
    jproj = _jax_projection(cam, arrays)
    _, _, info, seen = _jax_rasterize(jproj, arrays, monkeypatch,
                                      count_only=True)
    want = [n for _, n in seen]
    got = b4k.band_intersections(proj, arrays, cam)
    total = int(proj.num_tiles_hit.long().sum())
    print(f"4K: total {total}, bands {got} (gstk_tpu {want})")
    assert len(seen) == 13
    assert [h for _, _, h in band_rows(b4k.H, b4k.W, b4k.CONFIG)] == [
        h for h, _ in seen]
    assert total == int(jnp.sum(jproj.num_tiles_hit.astype(jnp.int64)))
    assert got == want and max(want) == int(info["num_intersects"])
    assert max(got) <= b4k.ISECT_CAPACITY  # no band truncates


def test_4k_frame_matches_jax(monkeypatch):
    """The 4K frame at 2,000 Gaussians through the port's ``frame``
    (13 bands) and through ``Renderer.render`` of its checkpoint, against
    gstk_tpu's ``rasterize`` of the same projection (``bands=0``): every
    band's rows and intersection count, and the image."""
    cam, arrays = b4k.scene_arrays(2000)
    proj = b4k.project(cam, arrays, "cpu")
    img, alpha, info = b4k.frame(proj, arrays, cam)
    jproj = _jax_projection(cam, arrays)
    jimg, jalpha, jinfo, seen = _jax_rasterize(jproj, arrays, monkeypatch)
    bands = [int(x) for x in info["band_intersects"]]
    assert len(seen) == 13 and bands == [n for _, n in seen]
    assert [h for _, _, h in band_rows(b4k.H, b4k.W, b4k.CONFIG)] == [
        h for h, _ in seen]
    assert max(bands) == int(jinfo["num_intersects"])
    for got, want in ((img.numpy(), np.asarray(jimg)),
                      (alpha.numpy(), np.asarray(jalpha))):
        bad = ~np.isclose(got, want, **PARITY)
        assert bad.mean() <= 1e-3, (bad.sum(), np.abs(got - want).max())
    with tempfile.TemporaryDirectory() as tmp:
        renderer = Renderer(b4k.write_checkpoint(arrays, Path(tmp)),
                            background=(0.0, 0.0, 0.0), device="cpu")
        out = renderer.render(b4k.C2W, cam["fx"], cam["fy"], cam["cx"],
                              cam["cy"], b4k.H, b4k.W)
    assert isinstance(out["rgb"], torch.Tensor)
    assert [int(x) for x in out["band_intersects"]] == bands
    bad = ~np.isclose(out["rgb"].numpy(), np.clip(img[..., :3].numpy(), 0, 1),
                      **PARITY)
    assert bad.mean() <= 1e-3, bad.sum()
