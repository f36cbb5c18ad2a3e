"""Tile compositing forward: kernel K1 and its plain twin.

Port of the forward half of ``gstk_tpu/ops/raster_pallas.py``
(``composite_tiles_fwd`` / ``_fwd_kernel``). Each 16x16 tile composites its
depth-sorted range ``tile_bins[t] = [start, end)`` of the intersection list
front to back with the reference semantics: alpha clamp 0.999, entries with
``sigma < 0`` or ``alpha < 1/255`` skipped, and a permanent per-pixel stop at
the first entry that would push T to 1e-4 or below (that entry is not
applied). Outputs are the accumulated colors without background,
``acc (T, 256, ch)``, and the final transmittance ``final_t (T, 256)``.

:func:`composite_tiles_fwd` launches the CUDA kernel
(``csrc/composite_fwd.cu``) for CUDA tensors and runs
:func:`composite_tiles_fwd_plain` only for CPU tensors. The kernel gathers
attributes by Gaussian id straight from the per-Gaussian arrays; the TPU's
packed 128-lane attribute tables, bf16 splits and padded tile ranges are not
carried over.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gstk_torch import _build

ALPHA_CLAMP = 0.999
ALPHA_CUTOFF = 1.0 / 255.0
T_CUTOFF = 1e-4
KERNEL_BLOCK_WIDTH = 16
KERNEL_CHANNELS = (3, 4)  # the instantiations of csrc/composite_fwd.cu

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]


def _tile_pixel_coords(
    tile_bounds: Tuple[int, int], block_width: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel coordinates of every tile's pixels: (T, P) float32 x and y."""
    tiles_x, tiles_y = tile_bounds
    t = torch.arange(tiles_x * tiles_y, device=device)
    p = torch.arange(block_width * block_width, device=device)
    px = (t % tiles_x)[:, None] * block_width + (p % block_width)[None, :]
    py = (t // tiles_x)[:, None] * block_width + (p // block_width)[None, :]
    return px.float(), py.float()


def _check(xys, conics, opacities, colors, gaussian_ids, tile_bins,
           tile_bounds):
    n = xys.shape[0]
    shapes_ok = (
        xys.shape == (n, 2) and conics.shape == (n, 3)
        and opacities.shape == (n,) and colors.ndim == 2
        and colors.shape[0] == n and gaussian_ids.ndim == 1
        and tile_bins.shape == (tile_bounds[0] * tile_bounds[1], 2)
    )
    if not shapes_ok:
        raise ValueError(
            "composite_tiles_fwd: expected xys (N,2), conics (N,3), "
            "opacities (N,), colors (N,ch), gaussian_ids (cap,), tile_bins "
            f"(T,2); got {tuple(xys.shape)} {tuple(conics.shape)} "
            f"{tuple(opacities.shape)} {tuple(colors.shape)} "
            f"{tuple(gaussian_ids.shape)} {tuple(tile_bins.shape)}"
        )
    for x in (xys, conics, opacities, colors):
        if x.dtype != torch.float32:
            raise ValueError(f"composite_tiles_fwd: float32 expected, got {x.dtype}")
    for x in (gaussian_ids, tile_bins):
        if x.dtype != torch.int32:
            raise ValueError(f"composite_tiles_fwd: int32 expected, got {x.dtype}")
    devices = {x.device for x in (xys, conics, opacities, colors,
                                  gaussian_ids, tile_bins)}
    if len(devices) != 1:
        raise ValueError(f"composite_tiles_fwd: tensors on {devices}")


def composite_tiles_fwd_plain(
    xys, conics, opacities, colors, gaussian_ids, tile_bins,
    tile_bounds: Tuple[int, int], block_width: int = 16, chunk: int = 32,
):
    """Plain PyTorch compositing (port of ``rasterize._composite_fwd_loop``):
    all tiles advance together through chunks of ``chunk`` sorted entries;
    the stop is an exclusive cumprod of (1 - alpha) with a carried per-pixel
    ``dead`` flag and an in-chunk cumulative-or over stop events.

    Returns ``(acc (T,P,ch), final_t (T,P), visited (T,P))``; ``visited``
    counts the entries each pixel evaluated (up to and including its stop),
    the work a sequential compositor does."""
    _check(xys, conics, opacities, colors, gaussian_ids, tile_bins,
           tile_bounds)
    device = xys.device
    num_tiles = tile_bounds[0] * tile_bounds[1]
    p = block_width * block_width
    n, ch = colors.shape
    cap = gaussian_ids.shape[0]
    px, py = _tile_pixel_coords(tile_bounds, block_width, device)
    start = tile_bins[:, 0].long()
    end = tile_bins[:, 1].long()
    t_run = torch.ones((num_tiles, p), dtype=torch.float32, device=device)
    dead = torch.zeros((num_tiles, p), dtype=torch.bool, device=device)
    acc = torch.zeros((num_tiles, p, ch), dtype=torch.float32, device=device)
    visited = torch.zeros((num_tiles, p), dtype=torch.int64, device=device)
    if num_tiles == 0 or cap == 0 or n == 0:
        return acc, t_run, visited
    longest = int((end - start).max())
    karange = torch.arange(chunk, device=device)
    for i in range(-(-longest // chunk)):
        raw = start[:, None] + i * chunk + karange[None, :]  # (T, K)
        in_range = (raw < end[:, None])[:, None, :]
        gid = gaussian_ids[raw.clamp(max=cap - 1)].long().clamp(0, n - 1)
        xy, con, op = xys[gid], conics[gid], opacities[gid]
        dx = xy[..., 0][:, None, :] - px[:, :, None]  # (T, P, K)
        dy = xy[..., 1][:, None, :] - py[:, :, None]
        sigma = 0.5 * (
            con[..., 0][:, None, :] * dx * dx
            + con[..., 2][:, None, :] * dy * dy
        ) + con[..., 1][:, None, :] * dx * dy
        alpha = torch.clamp(op[:, None, :] * torch.exp(-sigma), max=ALPHA_CLAMP)
        valid = (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF) & in_range
        one_m = 1.0 - torch.where(valid, alpha, 0.0)
        cp = torch.cumprod(one_m, dim=-1)
        t_prev = t_run[..., None] * torch.cat(
            [torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1
        )
        stop = valid & (t_prev * one_m <= T_CUTOFF)
        stops = torch.cumsum(stop, dim=-1)
        stops_incl = stops > 0
        stops_excl = (stops - stop.long()) > 0
        keep = valid & ~(dead[..., None] | stops_incl)
        a_k = torch.where(keep, alpha, 0.0)
        visited += (in_range & ~(dead[..., None] | stops_excl)).sum(-1)
        acc += torch.einsum("tpk,tkc->tpc", t_prev * a_k, colors[gid])
        t_run = t_run * torch.prod(1.0 - a_k, dim=-1)
        dead = dead | stop.any(dim=-1)
    return acc, t_run, visited


def composite_tiles_fwd(
    xys, conics, opacities, colors, gaussian_ids, tile_bins,
    tile_bounds: Tuple[int, int], block_width: int = 16,
):
    """Composite every tile: kernel K1 on CUDA tensors, the plain twin on
    CPU tensors.

    xys (N,2), conics (N,3), opacities (N,), colors (N,ch) float32;
    gaussian_ids (cap,) int32 sorted by (tile, depth) with sentinel N;
    tile_bins (T,2) int32 ranges. Returns acc (T,256,ch), final_t (T,256).
    The kernel takes 16x16 tiles and ch in ``KERNEL_CHANNELS``."""
    _check(xys, conics, opacities, colors, gaussian_ids, tile_bins,
           tile_bounds)
    device = xys.device
    if device.type == "cpu":
        acc, final_t, _ = composite_tiles_fwd_plain(
            xys, conics, opacities, colors, gaussian_ids, tile_bins,
            tile_bounds, block_width,
        )
        return acc, final_t
    if device.type != "cuda":
        raise ValueError(f"composite_tiles_fwd: unsupported device {device}")
    ch = colors.shape[1]
    if block_width != KERNEL_BLOCK_WIDTH or ch not in KERNEL_CHANNELS:
        raise ValueError(
            f"composite_tiles_fwd kernel takes block_width "
            f"{KERNEL_BLOCK_WIDTH} and ch in {KERNEL_CHANNELS}; got "
            f"block_width {block_width}, ch {ch}"
        )
    num_tiles = tile_bounds[0] * tile_bounds[1]
    p = block_width * block_width
    args = [x.contiguous() for x in (xys, conics, opacities, colors,
                                     gaussian_ids, tile_bins)]
    acc = torch.empty((num_tiles, p, ch), dtype=torch.float32, device=device)
    final_t = torch.empty((num_tiles, p), dtype=torch.float32, device=device)
    fn = _build.kernel_function("gstk_composite_fwd", _ARGTYPES)
    with torch.cuda.device(device):
        err = fn(
            args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
            args[3].data_ptr(), ch, xys.shape[0], args[4].data_ptr(),
            args[5].data_ptr(), num_tiles, tile_bounds[0],
            acc.data_ptr(), final_t.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check("composite_tiles_fwd", err)
    composite_tiles_fwd.launches += 1
    return acc, final_t


composite_tiles_fwd.launches = 0
