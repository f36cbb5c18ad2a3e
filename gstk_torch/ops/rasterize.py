"""Differentiable tile rasterization (port of ``gstk_tpu/ops/rasterize.py``).

Per horizontal band: tile footprints (tight visible-support extents or the
3-sigma square), binning (:mod:`gstk_torch.ops.binning`), and tile
compositing (:mod:`gstk_torch.ops.raster_cuda`) as one autograd Function.
The background is added through the final transmittance after all bands.

Alpha semantics match the reference forward kernel: clamp at 0.999, skip
``sigma < 0`` and ``alpha < 1/255``, stop for good at ``T <= 1e-4``.

The backward pass (port of ``_make_composite_pallas``' VJP): kernel K2
writes per-intersection gradients by sorted position, a gather by
``expansion_positions`` puts them in Gaussian-major expansion order, and
kernel K4 (:func:`gstk_torch.ops.segment_kernel.segment_sum_sorted`) sums
each Gaussian's contiguous segment. Gradients flow to xys, conics, colors,
opacities and the background; binning is not differentiated, and gradients
add across bands through autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from gstk_torch.ops.binning import bin_gaussians, expansion_positions
from gstk_torch.ops.projection import tight_extents, tile_bbox
from gstk_torch.ops.raster_cuda import (
    composite_tiles_bwd,
    composite_tiles_bwd_plain,
    composite_tiles_fwd,
    composite_tiles_fwd_plain,
    pack_records,
)
from gstk_torch.ops.segment_kernel import (
    segment_sum_sorted,
    segment_sum_sorted_plain,
)

FORWARD_ONLY_MESSAGE = (
    "RasterizeConfig.forward_only=True skips the expansion permutation the "
    "backward reduction needs; use forward_only=False for training."
)

BACKENDS = ("auto", "plain")


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Rasterizer settings.

    ``kernel_precision`` and ``attr_layout`` are TPU-only knobs of gstk_tpu;
    they are accepted and ignored: the port always computes in exact f32
    and gathers attributes by Gaussian id."""

    block_width: int = 16  # tile side in pixels
    chunk_size: int = 32  # entries per step of the plain compositing loop
    isect_capacity: int = 1 << 19  # static intersection buffer length per band
    # "auto": the CUDA kernels for CUDA tensors, their plain twins for CPU
    # tensors; "plain": the plain twins on any device (the reference path)
    backend: str = "auto"
    # bin each Gaussian into the AABB of its visible ellipse intersected
    # with the 3-sigma square (projection.tight_extents); exact output
    tight_culling: bool = True
    # horizontal bands, each binned and composited with its own
    # isect_capacity; 0 = auto (one band per ~640k pixels)
    bands: int = 1
    kernel_precision: str = "exact"  # TPU-only: ignored
    attr_layout: str = "auto"  # TPU-only: ignored
    # render-only: binning skips the expansion permutation the backward
    # needs, and differentiating the result raises
    forward_only: bool = False


def _tiles_to_image(tiles, tile_bounds, block_width, img_height, img_width):
    """(T, P, ch) tile layout -> (H, W, ch) image, cropping pad tiles."""
    tiles_x, tiles_y = tile_bounds
    ch = tiles.shape[-1]
    img = tiles.reshape(tiles_y, tiles_x, block_width, block_width, ch)
    img = img.permute(0, 2, 1, 3, 4).reshape(
        tiles_y * block_width, tiles_x * block_width, ch
    )
    return img[:img_height, :img_width]


def footprints(radii, conics, opacities, config: RasterizeConfig):
    """Each Gaussian's (N, 2) footprint half-extents in pixels (the tight
    visible-support extents, or the 3-sigma square) and whether it has one."""
    radii_f = radii.to(torch.float32)
    if config.tight_culling:
        ext = tight_extents(conics.detach(), opacities.detach(), radii_f)
    else:
        ext = torch.stack([radii_f, radii_f], dim=-1)
    return ext, (ext[:, 0] > 0) & (ext[:, 1] > 0)


def tile_counts(xys, ext, alive, tile_bounds, block_width) -> torch.Tensor:
    """Tiles each Gaussian's footprint covers within ``tile_bounds`` (0
    without a footprint), int32."""
    tmin, tmax = tile_bbox(xys.detach(), ext, tile_bounds, block_width)
    area = (tmax[:, 0] - tmin[:, 0]) * (tmax[:, 1] - tmin[:, 1])
    return torch.where(alive, area, 0).to(torch.int32)


def band_rows(img_height: int, img_width: int, config: RasterizeConfig):
    """Each band's (first pixel row, tile rows, pixel rows); ``bands=0``
    gives one band per ~640k pixels."""
    bw = config.block_width
    tiles_y_total = (img_height + bw - 1) // bw
    bands = config.bands
    if bands == 0:  # auto: one band per ~640k pixels
        bands = max(1, -(-img_height * img_width // 640_000))
    bands = min(bands, tiles_y_total)
    rows_per = -(-tiles_y_total // bands)
    out = []
    for b in range(bands):
        rows_b = min(rows_per, tiles_y_total - b * rows_per)
        if rows_b <= 0:
            break
        y0 = b * rows_per * bw
        out.append((y0, rows_b, min(img_height - y0, rows_b * bw)))
    return out


def rasterize(
    xys: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    conics: torch.Tensor,
    num_tiles_hit: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    img_height: int,
    img_width: int,
    background: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
    return_info: bool = False,
):
    """Rasterize projected Gaussians; returns ``(img (H, W, ch), alpha
    (H, W))`` and, with ``return_info``, ``{"num_intersects": max over
    bands, "band_intersects": (bands,) each band's count}`` (device
    tensors: reading them is the caller's one sync). Any channel count composites in one pass (callers concatenate
    depth as a 4th channel); the CUDA kernel takes 3 or 4.

    ``num_tiles_hit`` is accepted for API compatibility; tile footprints are
    recomputed per band. Gradients flow to xys, conics, colors, opacities
    and background."""
    if config.backend not in BACKENDS:
        raise ValueError(f"RasterizeConfig.backend {config.backend!r} not in {BACKENDS}")
    bw = config.block_width
    tiles_x = (img_width + bw - 1) // bw
    bands = band_rows(img_height, img_width, config)

    ext, ext_alive = footprints(radii, conics, opacities, config)

    band_imgs, band_ts, band_isects = [], [], []
    for y0, rows_b, band_h in bands:
        if len(bands) == 1:
            xys_b = xys
        else:
            shift = torch.tensor([0.0, float(y0)], device=xys.device)
            xys_b = xys - shift
        counts_b = tile_counts(xys_b, ext, ext_alive, (tiles_x, rows_b), bw)
        img_b, t_b, ni = _rasterize_band(
            xys_b, depths, ext, conics, counts_b, colors, opacities,
            band_h, img_width, config,
        )
        band_imgs.append(img_b)
        band_ts.append(t_b)
        band_isects.append(ni)

    img = torch.cat(band_imgs, dim=0)
    final_t_img = torch.cat(band_ts, dim=0)
    if background is not None:
        img = img + final_t_img[..., None] * background
    alpha = 1.0 - final_t_img
    if return_info:
        # max over bands: the growth signal for the static capacity
        per_band = torch.stack(band_isects)
        return img, alpha, {"num_intersects": per_band.max(),
                            "band_intersects": per_band}
    return img, alpha


class _CompositeTiles(torch.autograd.Function):
    """Tile compositing with its backward pass.

    Forward: kernel K1 (or its twin). Backward: K2's per-intersection
    gradients, gathered into expansion order by ``positions`` and summed per
    Gaussian by K4 over the segments ``hi = min(cumsum(counts), cap)``.
    The kernels read one packed record per Gaussian, built once here and
    kept for K2. ``positions`` is None for a forward-only rasterize, whose
    backward raises."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacities, gaussian_ids, tile_bins,
                positions, counts, tile_bounds, block_width, plain, chunk):
        args = (xys, conics, opacities, colors, gaussian_ids, tile_bins,
                tile_bounds, block_width)
        records = None
        if plain:
            acc, final_t, _ = composite_tiles_fwd_plain(*args, chunk=chunk)
        else:
            if xys.is_cuda:
                records = pack_records(xys, conics, opacities, colors)
            acc, final_t = composite_tiles_fwd(*args, records=records)
        ctx.save_for_backward(xys, conics, colors, opacities, gaussian_ids,
                              tile_bins, positions, counts, acc, final_t,
                              records)
        ctx.geometry = (tile_bounds, block_width, plain, chunk)
        return acc, final_t

    @staticmethod
    @once_differentiable
    def backward(ctx, g_acc, g_final_t):
        (xys, conics, colors, opacities, gaussian_ids, tile_bins, positions,
         counts, acc, final_t, records) = ctx.saved_tensors
        tile_bounds, block_width, plain, chunk = ctx.geometry
        if positions is None:
            raise ValueError(FORWARD_ONLY_MESSAGE)
        if g_acc is None:
            g_acc = torch.zeros_like(acc)
        if g_final_t is None:
            g_final_t = torch.zeros_like(final_t)
        args = (xys, conics, opacities, colors, gaussian_ids, tile_bins, acc,
                final_t, g_acc.contiguous(), g_final_t.contiguous(),
                tile_bounds, block_width)
        if plain:
            gout, _ = composite_tiles_bwd_plain(*args, chunk=chunk)
            segment_sum = segment_sum_sorted_plain
        else:
            gout = composite_tiles_bwd(*args, records=records)
            segment_sum = segment_sum_sorted
        # rows in expansion (Gaussian-major) order: each Gaussian's entries
        # are then one contiguous segment ending at its clipped count cumsum;
        # K4 reads the gathered rows entry-major, as they are
        g_et = gout.index_select(0, positions).t()
        cap = gaussian_ids.shape[0]
        hi = torch.clamp(torch.cumsum(counts.long(), 0), max=cap)
        sums = segment_sum(g_et, hi)  # (6 + ch, N)
        return (sums[0:2].t(), sums[2:5].t(), sums[6:].t(), sums[5],
                None, None, None, None, None, None, None, None)


def _rasterize_band(
    xys, depths, ext, conics, counts, colors, opacities,
    img_height, img_width, config,
):
    """Bin + composite one horizontal band (the whole image when bands=1).
    ``xys`` are band-local; ``ext`` the (N, 2) footprint half-extents;
    ``counts`` the band-clipped per-Gaussian tile counts."""
    bw = config.block_width
    tile_bounds = ((img_width + bw - 1) // bw, (img_height + bw - 1) // bw)
    isect = bin_gaussians(
        xys.detach(), depths.detach(), ext, counts, tile_bounds, bw,
        config.isect_capacity, segment_backend=config.backend,
        need_expansion=not config.forward_only,
    )
    positions = None if config.forward_only else expansion_positions(isect)
    acc, final_t = _CompositeTiles.apply(
        xys, conics, colors, opacities, isect.gaussian_ids, isect.tile_bins,
        positions, counts, tile_bounds, bw, config.backend == "plain",
        config.chunk_size,
    )
    img = _tiles_to_image(acc, tile_bounds, bw, img_height, img_width)
    final_t_img = _tiles_to_image(
        final_t[..., None], tile_bounds, bw, img_height, img_width
    )[..., 0]
    return img, final_t_img, isect.num_intersects
