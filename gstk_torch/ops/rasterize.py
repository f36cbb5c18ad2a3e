"""Tile rasterization, forward only (port of ``gstk_tpu/ops/rasterize.py``).

Per horizontal band: tile footprints (tight visible-support extents or the
3-sigma square), binning (:mod:`gstk_torch.ops.binning`), and tile
compositing (kernel K1, :mod:`gstk_torch.ops.raster_cuda`). The background
is added through the final transmittance after all bands.

Alpha semantics match the reference forward kernel: clamp at 0.999, skip
``sigma < 0`` and ``alpha < 1/255``, stop for good at ``T <= 1e-4``.

The backward pass (the compositing backward kernel and the per-Gaussian
gradient reduction) is not ported yet: differentiating :func:`rasterize`
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gstk_torch.ops.binning import bin_gaussians
from gstk_torch.ops.projection import tight_extents, tile_bbox
from gstk_torch.ops.raster_cuda import (
    composite_tiles_fwd,
    composite_tiles_fwd_plain,
)

BACKENDS = ("auto", "plain")


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Rasterizer settings.

    ``kernel_precision`` and ``attr_layout`` are TPU-only knobs of gstk_tpu;
    they are accepted and ignored: the port always computes in exact f32
    and gathers attributes by Gaussian id. ``forward_only`` is accepted and
    has no effect yet: every rasterize of this version is forward-only."""

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
    forward_only: bool = False  # ignored: rasterize is forward-only here


def _tiles_to_image(tiles, tile_bounds, block_width, img_height, img_width):
    """(T, P, ch) tile layout -> (H, W, ch) image, cropping pad tiles."""
    tiles_x, tiles_y = tile_bounds
    ch = tiles.shape[-1]
    img = tiles.reshape(tiles_y, tiles_x, block_width, block_width, ch)
    img = img.permute(0, 2, 1, 3, 4).reshape(
        tiles_y * block_width, tiles_x * block_width, ch
    )
    return img[:img_height, :img_width]


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
    bands}``. Any channel count composites in one pass (callers concatenate
    depth as a 4th channel); the CUDA kernel takes 3 or 4.

    ``num_tiles_hit`` is accepted for API compatibility; tile footprints are
    recomputed per band. Raises when autograd would need a gradient."""
    if config.backend not in BACKENDS:
        raise ValueError(f"RasterizeConfig.backend {config.backend!r} not in {BACKENDS}")
    needs_grad = [x for x in (xys, conics, colors, opacities, background)
                  if x is not None and x.requires_grad]
    if torch.is_grad_enabled() and needs_grad:
        raise NotImplementedError(
            "gstk_torch.rasterize is forward-only: the compositing backward "
            "pass is not ported yet; call it under torch.no_grad()"
        )
    bw = config.block_width
    tiles_x = (img_width + bw - 1) // bw
    tiles_y_total = (img_height + bw - 1) // bw
    bands = config.bands
    if bands == 0:  # auto: one band per ~640k pixels
        bands = max(1, -(-img_height * img_width // 640_000))
    bands = min(bands, tiles_y_total)
    rows_per = -(-tiles_y_total // bands)

    radii_f = radii.to(torch.float32)
    if config.tight_culling:
        ext = tight_extents(conics, opacities, radii_f)
    else:
        ext = torch.stack([radii_f, radii_f], dim=-1)
    ext_alive = (ext[:, 0] > 0) & (ext[:, 1] > 0)

    band_imgs, band_ts, band_isects = [], [], []
    for b in range(bands):
        r0 = b * rows_per
        rows_b = min(rows_per, tiles_y_total - r0)
        if rows_b <= 0:
            break
        y0 = r0 * bw
        band_h = min(img_height - y0, rows_b * bw)
        if bands == 1:
            xys_b = xys
        else:
            shift = torch.tensor([0.0, float(y0)], device=xys.device)
            xys_b = xys - shift
        tmin, tmax = tile_bbox(xys_b, ext, (tiles_x, rows_b), bw)
        area = (tmax[:, 0] - tmin[:, 0]) * (tmax[:, 1] - tmin[:, 1])
        counts_b = torch.where(ext_alive, area, 0).to(torch.int32)
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
        return img, alpha, {"num_intersects": torch.stack(band_isects).max()}
    return img, alpha


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
        xys, depths, ext, counts, tile_bounds, bw, config.isect_capacity,
        segment_backend=config.backend,
    )
    args = (xys, conics, opacities, colors, isect.gaussian_ids,
            isect.tile_bins, tile_bounds, bw)
    if config.backend == "plain":
        acc, final_t, _ = composite_tiles_fwd_plain(*args, chunk=config.chunk_size)
    else:
        acc, final_t = composite_tiles_fwd(*args)
    img = _tiles_to_image(acc, tile_bounds, bw, img_height, img_width)
    final_t_img = _tiles_to_image(
        final_t[..., None], tile_bounds, bw, img_height, img_width
    )[..., 0]
    return img, final_t_img, isect.num_intersects
