"""gstk_torch.ops.binning.bin_gaussians against gstk_tpu's (forward-only,
``need_expansion=False``) on the same inputs: the outputs must be identical.

Both binnings are fed gstk_tpu's projection outputs: radii and tile counts
are computed from floats, and one ulp of difference in a port's projection
could flip them, which would test projection, not binning.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.ops import binning as jbin
from gstk_tpu.ops import projection as jproj
from gstk_torch.ops import binning as tbin

from tests._scenes import make_camera, make_gaussians

torch.set_num_threads(2)

FIELDS = ("gaussian_ids", "tile_ids", "tile_bins", "num_intersects")


def _inputs(rng, tight, n=300):
    """gstk_tpu projection outputs (and tight extents) as numpy."""
    cam = make_camera()
    means, scales, quats, _, opac = make_gaussians(rng, n)
    out = jproj.project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats),
        jnp.asarray(cam["viewmat"]), jnp.asarray(cam["fullmat"]),
        cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["img_h"], cam["img_w"],
    )
    tiles = ((cam["img_w"] + 15) // 16, (cam["img_h"] + 15) // 16)
    radii, counts = out.radii, out.num_tiles_hit
    if tight:  # per-axis footprint and its counts, as rasterize builds them
        radii = jproj.tight_extents(out.conics, jnp.asarray(opac), out.radii)
        tmin, tmax = jproj.tile_bbox(out.xys, radii, tiles, 16)
        area = (tmax[:, 0] - tmin[:, 0]) * (tmax[:, 1] - tmin[:, 1])
        counts = jnp.where((radii[:, 0] > 0) & (radii[:, 1] > 0), area, 0)
    arrays = [np.array(x) for x in (out.xys, out.depths, radii, counts)]
    return arrays, tiles


@pytest.mark.parametrize("segment_backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("capacity", [1 << 13, 97], ids=["fits", "overflow"])
def test_bin_gaussians_identical_to_jax(rng, segment_backend, tight, capacity):
    arrays, tiles = _inputs(rng, tight)
    ref = jbin.bin_gaussians(
        *[jnp.asarray(a) for a in arrays], tiles, 16, capacity,
        segment_backend=segment_backend, need_expansion=False,
    )
    got = tbin.bin_gaussians(
        *[torch.from_numpy(a) for a in arrays], tiles, 16, capacity
    )
    total = int(ref.num_intersects)
    assert (total > capacity) == (capacity == 97)
    for name in FIELDS:
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    # the plain backend is the same function on any device
    plain = tbin.bin_gaussians(
        *[torch.from_numpy(a) for a in arrays], tiles, 16, capacity,
        segment_backend="plain",
    )
    for name in FIELDS:
        assert torch.equal(getattr(plain, name), getattr(got, name)), name


def test_bin_gaussians_empty_scene():
    """Gaussians that hit no tile: every slot is a sentinel."""
    tiles, n = (4, 3), 16
    zeros = lambda *s: np.zeros(s, np.float32)
    arrays = [zeros(n, 2), zeros(n), zeros(n), np.zeros(n, np.int32)]
    ref = jbin.bin_gaussians(
        *[jnp.asarray(a) for a in arrays], tiles, 16, 64, need_expansion=False
    )
    got = tbin.bin_gaussians(*[torch.from_numpy(a) for a in arrays], tiles, 16, 64)
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )
    # zero Gaussians (gstk_tpu's packed path cannot take N = 0)
    got0 = tbin.bin_gaussians(
        *[torch.from_numpy(a[:0]) for a in arrays], tiles, 16, 64
    )
    assert int(got0.num_intersects) == 0
    assert not got0.gaussian_ids.any() and not got0.tile_bins.any()
