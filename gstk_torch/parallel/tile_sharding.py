"""Tile-sharded rendering: one large image across ranks (port of
``gstk_tpu/parallel/tile_sharding.py``).

The Gaussian set and the sorted intersection list are replicated while the
tile grid is split into contiguous ranges, one a rank: each rank composites
its range with kernel K1 (or its twin: :func:`gstk_torch._build.takes_kernels`),
and one gather of the per-tile outputs assembles the image. Projection,
footprints and binning (K3) run on every rank; they are a small part of a
large render. Forward only, as in gstk_tpu: training
shards over cameras instead.

K1 runs unchanged on tile ranges in which every tile outside this rank's
range is emptied (start = end), so those tiles exit at once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gstk_torch._build import takes_kernels
from gstk_torch.ops.binning import bin_gaussians
from gstk_torch.ops.raster_cuda import composite_tiles_fwd, composite_tiles_fwd_plain
from gstk_torch.ops.rasterize import (
    RasterizeConfig,
    _tiles_to_image,
    footprints,
    tile_counts,
)
from gstk_torch.parallel.mesh import Axis, Mesh, get_mesh, world_size

TILE_AXIS = "tiles"


def make_tile_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A one-axis mesh over every rank, named ``TILE_AXIS``."""
    return get_mesh(n_devices, axes=((TILE_AXIS, world_size()),))


def rasterize_tile_sharded(
    xys: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    conics: torch.Tensor,
    num_tiles_hit: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    img_height: int,
    img_width: int,
    mesh,
    background: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward rasterization with the tile grid split over the mesh's
    ``TILE_AXIS`` (or the :class:`Axis` given): ``(img (H, W, ch), alpha
    (H, W))``, as :func:`gstk_torch.ops.rasterize.rasterize` gives them in
    one band, on every rank.

    The tile count is padded to a multiple of the axis size; rank r
    composites tiles ``[r T', (r + 1) T')`` of the padded count, T' = T /
    n. ``num_tiles_hit`` is accepted for API compatibility; the footprints
    are computed as ``rasterize`` computes them."""
    axis = mesh if isinstance(mesh, Axis) else mesh[TILE_AXIS]
    bw = config.block_width
    tile_bounds = ((img_width + bw - 1) // bw, (img_height + bw - 1) // bw)
    num_tiles = tile_bounds[0] * tile_bounds[1]
    per = -(-num_tiles // axis.size)
    lo = min(axis.index * per, num_tiles)
    hi = min(lo + per, num_tiles)

    ext, alive = footprints(radii, conics, opacities, config)
    counts = tile_counts(xys, ext, alive, tile_bounds, bw)
    isect = bin_gaussians(
        xys.detach(), depths.detach(), ext, counts, tile_bounds, bw,
        config.isect_capacity, segment_backend=config.backend,
        need_expansion=False,
    )
    bins = isect.tile_bins.clone()
    bins[:lo] = 0
    bins[hi:] = 0
    args = (xys, conics, opacities, colors, isect.gaussian_ids, bins,
            tile_bounds, bw)
    if takes_kernels(xys.device, config.backend):
        acc, final_t = composite_tiles_fwd(*args)
    else:
        acc, final_t, _ = composite_tiles_fwd_plain(*args,
                                                    chunk=config.chunk_size)
    ch = colors.shape[-1]
    local = torch.cat([acc[lo:hi], final_t[lo:hi, :, None]], dim=-1)
    pad = local.new_zeros((per - (hi - lo),) + local.shape[1:])
    pad[..., ch] = 1.0  # an empty tile: nothing accumulated, T = 1
    tiles = axis.all_gather(torch.cat([local, pad]))[:num_tiles]
    img = _tiles_to_image(tiles[..., :ch], tile_bounds, bw, img_height,
                          img_width)
    final_t_img = _tiles_to_image(tiles[..., ch:], tile_bounds, bw,
                                  img_height, img_width)[..., 0]
    if background is not None:
        img = img + final_t_img[..., None] * background
    return img, 1.0 - final_t_img
