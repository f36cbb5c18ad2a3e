"""Tile binning: expand Gaussians to per-tile intersections and depth-sort
(port of ``gstk_tpu/ops/binning.py``).

Static capacity, as in gstk_tpu, so the output is identical to it:

  1. ``num_tiles_hit`` is cumsum'ed; Gaussian g owns the slots
     ``[cum[g] - count[g], cum[g])``. Slot j's owner is
     ``#{g: cum[g] <= j}`` — kernel K3 (:mod:`gstk_torch.ops.segment_kernel`)
     with a column of ones (or its twin: ``segment_backend``); slots past
     the total get the sentinel id N.
  2. Each slot gathers its owner's tile bbox, offset and depth by id and
     walks the bbox row-major to its tile.
  3. One stable ``torch.sort`` on the int64 key ``tile << 32 | depth_bits``
     orders intersections front to back within each tile. Counted Gaussians
     have depth >= clip_thresh > 0 (projection culls the rest), and positive
     float32 bit patterns sort like the floats, so this equals gstk_tpu's
     (tile, depth) sort; ties keep the Gaussian-major slot order.
  4. Tile ranges come from one ``searchsorted``.
  5. For the backward pass, the sort permutation is kept as
     ``expansion_ids`` (each sorted entry's slot in the Gaussian-major
     expansion), and :func:`expansion_positions` inverts it with one
     scatter. ``need_expansion=False`` (render-only) leaves them out.

If the true count exceeds ``capacity`` the tail of the Gaussian-major
expansion is dropped and the last tile ends at ``min(total, capacity)``;
``num_intersects`` reports the true count.

gstk_tpu's ``_segment_constant`` and the bit-packed columns avoid TPU
gathers; here the per-slot values are plain gathers by Gaussian id.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gstk_torch._build import takes_kernels
from gstk_torch.ops.projection import tile_bbox
from gstk_torch.ops.segment_kernel import (
    segment_broadcast,
    segment_broadcast_plain,
)

_INF_BITS = 0x7F800000  # float32 +inf: the sentinel depth


class Intersections(NamedTuple):
    gaussian_ids: torch.Tensor  # (capacity,) int32, sorted by (tile, depth); sentinel = N
    tile_ids: torch.Tensor  # (capacity,) int32 sorted; sentinel = num_tiles
    tile_bins: torch.Tensor  # (num_tiles, 2) int32 [start, end)
    num_intersects: torch.Tensor  # () int32 true count (may exceed capacity)
    # (capacity,) int32 expansion-order slot of each sorted entry; None when
    # binned with need_expansion=False
    expansion_ids: Optional[torch.Tensor] = None


def bin_gaussians(
    xys: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    num_tiles_hit: torch.Tensor,
    tile_bounds: Tuple[int, int],
    block_width: int,
    capacity: int,
    segment_backend: str = "auto",
    need_expansion: bool = True,
) -> Intersections:
    """Build the sorted per-tile intersection list with a static capacity.

    xys/depths: outputs of ``project_gaussians``. radii: per-Gaussian
    footprint half-extents, (N,) square radii or (N, 2) per-axis tight
    extents; ``num_tiles_hit`` must equal the resulting bbox areas.
    tile_bounds: (tiles_x, tiles_y). segment_backend: the rasterizer's
    backend, which picks kernel K3 or its plain twin
    (:func:`gstk_torch._build.takes_kernels`). need_expansion=False leaves
    ``expansion_ids`` out (None), for callers that never differentiate."""
    device = xys.device
    n = xys.shape[0]
    tiles_x = tile_bounds[0]
    num_tiles = tile_bounds[0] * tile_bounds[1]
    counts = num_tiles_hit.to(torch.int64)
    cum = torch.cumsum(counts, 0)
    total = cum[-1] if n > 0 else torch.zeros((), dtype=torch.int64, device=device)

    broadcast = (segment_broadcast if takes_kernels(device, segment_backend)
                 else segment_broadcast_plain)
    gid = broadcast(
        torch.clamp(cum, max=capacity).to(torch.int32),
        [torch.ones(n, dtype=torch.int32, device=device)],
        capacity,
    )[0]
    is_real = gid < n
    g = torch.clamp(gid.long(), max=max(n - 1, 0))

    if n > 0:
        tile_min, tile_max = tile_bbox(
            xys, radii.to(torch.float32), tile_bounds, block_width
        )
        bbox_w = torch.clamp(tile_max[:, 0] - tile_min[:, 0], min=1).long()
        pos = torch.arange(capacity, device=device) - (cum - counts)[g]
        bw = bbox_w[g]
        q = torch.div(pos, bw, rounding_mode="floor")
        tx = tile_min[g, 0].long() + (pos - q * bw)
        ty = tile_min[g, 1].long() + q
        tile_id = torch.where(is_real, ty * tiles_x + tx, num_tiles)
        depth_bits = depths.to(torch.float32).contiguous().view(torch.int32)[g]
        depth_key = torch.where(is_real, depth_bits.long(), _INF_BITS)
    else:
        tile_id = torch.full((capacity,), num_tiles, device=device)
        depth_key = torch.full((capacity,), _INF_BITS, device=device)
    key = (tile_id << 32) | depth_key
    sorted_key, perm = torch.sort(key, stable=True)
    sorted_gid = gid[perm]
    sorted_tile = (sorted_key >> 32).to(torch.int32)

    tile_range = torch.arange(num_tiles, dtype=torch.int32, device=device)
    starts = torch.searchsorted(sorted_tile, tile_range, side="left").to(torch.int32)
    # tiles partition the sorted list contiguously (sentinels sort last), so
    # a tile ends where the next starts and the last ends at the kept count
    n_real = torch.clamp(total, max=capacity).to(torch.int32)
    ends = torch.cat([starts[1:], n_real[None]])
    return Intersections(
        gaussian_ids=sorted_gid,
        tile_ids=sorted_tile,
        tile_bins=torch.stack([starts, ends], dim=-1),
        num_intersects=total.to(torch.int32),
        expansion_ids=perm.to(torch.int32) if need_expansion else None,
    )


def expansion_positions(isect: Intersections) -> torch.Tensor:
    """Expansion-order -> sorted-position permutation, the inverse of the
    binning sort: ``out[e]`` is where expansion slot e landed in the sorted
    list. One scatter of ``arange``, not a second sort."""
    if isect.expansion_ids is None:
        raise ValueError("binned with need_expansion=False: no expansion_ids")
    ids = isect.expansion_ids.long()
    pos = torch.empty_like(isect.expansion_ids)
    pos[ids] = torch.arange(ids.shape[0], dtype=pos.dtype, device=pos.device)
    return pos
