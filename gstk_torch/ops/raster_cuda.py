"""Tile compositing: kernels K1 (forward) and K2 (backward) and their plain
twins.

Port of ``gstk_tpu/ops/raster_pallas.py`` (``composite_tiles_fwd`` /
``_fwd_kernel`` and ``composite_tiles_bwd`` / ``_bwd_kernel``). Each 16x16
tile composites its depth-sorted range ``tile_bins[t] = [start, end)`` of
the intersection list front to back with the reference semantics: alpha
clamp 0.999, entries with ``sigma < 0`` or ``alpha < 1/255`` skipped, and a
permanent per-pixel stop at the first entry that would push T to 1e-4 or
below (that entry is not applied). The forward's outputs are the
accumulated colors without background, ``acc (T, 256, ch)``, and the final
transmittance ``final_t (T, 256)``. The backward recomputes the same walk
and returns per-intersection gradients ``(cap, 6 + ch)`` in the order
``[x, y, a, b, c, opacity, colors...]``, indexed by sorted position; the
per-Gaussian sums are :func:`gstk_torch.ops.segment_kernel.segment_sum_sorted`'s.

:func:`composite_tiles_fwd` and :func:`composite_tiles_bwd` launch the CUDA
kernels (``csrc/composite_fwd.cu``, ``csrc/composite_bwd.cu``) for CUDA
tensors and run their plain twins only for CPU tensors. The kernels gather
attributes by Gaussian id from one packed 48-B record per Gaussian
(:func:`pack_records`), which a caller that runs both kernels builds once and
passes to both; the TPU's packed 128-lane attribute tables, bf16 splits,
side slabs and padded tile ranges are not carried over.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from gstk_torch import _build

ALPHA_CLAMP = 0.999
ALPHA_CUTOFF = 1.0 / 255.0
T_CUTOFF = 1e-4
KERNEL_BLOCK_WIDTH = 16
KERNEL_CHANNELS = (3, 4)  # the instantiations of csrc/composite_{fwd,bwd}.cu
# floats per Gaussian in the kernels' packed record (csrc/composite_common.cuh)
RECORD_WIDTH = 12

# records, ch, n, gids, tile_bins, num_tiles, tiles_x, acc, final_t, stream
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
]
# the forward's arguments with acc, final_t, g_acc, g_final_t and gout in
# place of its two outputs
_BWD_ARGTYPES = _ARGTYPES[:7] + [ctypes.c_void_p] * 6


def pack_records(xys, conics, opacities, colors) -> torch.Tensor:
    """The kernels' per-Gaussian record, (N, 12) float32 on the inputs'
    device: ``[x, y, a, b | c, op, col0, col1 | col2, col3, 0, 0]``, 48 B or
    three 16-B chunks a Gaussian, colors past ch zero. Takes ch in
    ``KERNEL_CHANNELS``."""
    n, ch = colors.shape
    if ch not in KERNEL_CHANNELS:
        raise ValueError(f"pack_records: the kernels take ch in "
                         f"{KERNEL_CHANNELS}; got ch {ch}")
    pad = colors.new_zeros((n, RECORD_WIDTH - 6 - ch))
    return torch.cat([xys, conics, opacities[:, None], colors, pad], dim=1)


def _kernel_records(records, xys, conics, opacities, colors, name):
    """``records`` checked against the attributes, or built from them when
    None."""
    if records is None:
        return pack_records(xys, conics, opacities, colors)
    if (tuple(records.shape) != (xys.shape[0], RECORD_WIDTH)
            or records.dtype != torch.float32 or records.device != xys.device
            or not records.is_contiguous() or records.data_ptr() % 16):
        raise ValueError(
            f"{name}: records must be contiguous, 16-B aligned float32 "
            f"({xys.shape[0]}, {RECORD_WIDTH}) on {xys.device} (pack_records); "
            f"got {records.dtype} {tuple(records.shape)} on {records.device}"
        )
    return records


def resident_ctas(kernel: str, ch: int) -> int:
    """CTAs of kernel ``"fwd"`` (K1) or ``"bwd"`` (K2) at ``ch`` channels
    that fit on one SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    with the kernel's registers and shared memory)."""
    if kernel not in ("fwd", "bwd") or ch not in KERNEL_CHANNELS:
        raise ValueError(f"resident_ctas: kernel fwd or bwd, ch in "
                         f"{KERNEL_CHANNELS}; got {kernel!r}, {ch}")
    fn = _build.kernel_function(f"gstk_composite_{kernel}_occupancy",
                                [ctypes.c_int, ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    _build.check(f"resident_ctas({kernel!r}, {ch})",
                 fn(ch, ctypes.addressof(blocks)))
    return blocks.value


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
           tile_bounds, name="composite_tiles_fwd"):
    n = xys.shape[0]
    shapes_ok = (
        xys.shape == (n, 2) and conics.shape == (n, 3)
        and opacities.shape == (n,) and colors.ndim == 2
        and colors.shape[0] == n and gaussian_ids.ndim == 1
        and tile_bins.shape == (tile_bounds[0] * tile_bounds[1], 2)
    )
    if not shapes_ok:
        raise ValueError(
            f"{name}: expected xys (N,2), conics (N,3), "
            "opacities (N,), colors (N,ch), gaussian_ids (cap,), tile_bins "
            f"(T,2); got {tuple(xys.shape)} {tuple(conics.shape)} "
            f"{tuple(opacities.shape)} {tuple(colors.shape)} "
            f"{tuple(gaussian_ids.shape)} {tuple(tile_bins.shape)}"
        )
    for x in (xys, conics, opacities, colors):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: float32 expected, got {x.dtype}")
    for x in (gaussian_ids, tile_bins):
        if x.dtype != torch.int32:
            raise ValueError(f"{name}: int32 expected, got {x.dtype}")
    devices = {x.device for x in (xys, conics, opacities, colors,
                                  gaussian_ids, tile_bins)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on {devices}")


def _check_planes(colors, tile_bounds, block_width, acc, final_t, g_acc,
                  g_final_t):
    """The backward's per-pixel inputs: (T, P, ch) and (T, P) float32 planes
    on the attributes' device."""
    t_p = (tile_bounds[0] * tile_bounds[1], block_width * block_width)
    want = {"acc": t_p + (colors.shape[1],), "final_t": t_p,
            "g_acc": t_p + (colors.shape[1],), "g_final_t": t_p}
    for name, x in zip(want, (acc, final_t, g_acc, g_final_t)):
        if (tuple(x.shape) != want[name] or x.dtype != torch.float32
                or x.device != colors.device):
            raise ValueError(
                f"composite_tiles_bwd: {name} must be float32 {want[name]} "
                f"on {colors.device}; got {x.dtype} {tuple(x.shape)} on {x.device}"
            )


class _Chunk(NamedTuple):
    """One chunk of the front-to-back walk, for all tiles at once."""

    index: torch.Tensor  # (T, K) sorted positions of the chunk's entries
    in_range: torch.Tensor  # (T, 1, K) entry lies in the tile's range
    gid: torch.Tensor  # (T, K) Gaussian ids, clipped into [0, N)
    dx: torch.Tensor  # (T, P, K) Gaussian center minus pixel
    dy: torch.Tensor
    exp_neg: torch.Tensor  # (T, P, K) exp(-sigma)
    clamped: torch.Tensor  # (T, P, K) op exp(-sigma) > 0.999
    alpha: torch.Tensor  # (T, P, K) clamped alpha
    keep: torch.Tensor  # (T, P, K) the entry is composited
    t_prev: torch.Tensor  # (T, P, K) T before the entry
    t_next: torch.Tensor  # (T, P) T after the chunk
    visits: torch.Tensor  # (T, P) entries evaluated, up to and including a stop


def _walk(xys, conics, opacities, gaussian_ids, tile_bins, tile_bounds,
          block_width, chunk):
    """All tiles advance together through chunks of ``chunk`` sorted entries
    (port of the shared part of ``rasterize._composite_fwd_loop`` and
    ``_composite_bwd_loop``): the stop is an exclusive cumprod of
    (1 - alpha) with a carried per-pixel ``dead`` flag and an in-chunk
    cumulative-or over stop events (``_keep_weights``). Yields one
    :class:`_Chunk` per step and carries T and ``dead`` to the next."""
    device = xys.device
    num_tiles = tile_bounds[0] * tile_bounds[1]
    n = xys.shape[0]
    cap = gaussian_ids.shape[0]
    if num_tiles == 0 or cap == 0 or n == 0:
        return
    px, py = _tile_pixel_coords(tile_bounds, block_width, device)
    start = tile_bins[:, 0].long()
    end = tile_bins[:, 1].long()
    t_run = torch.ones(px.shape, dtype=torch.float32, device=device)
    dead = torch.zeros(px.shape, dtype=torch.bool, device=device)
    longest = int((end - start).max())
    karange = torch.arange(chunk, device=device)
    for i in range(-(-longest // chunk)):
        index = start[:, None] + i * chunk + karange[None, :]  # (T, K)
        in_range = (index < end[:, None])[:, None, :]
        gid = gaussian_ids[index.clamp(max=cap - 1)].long().clamp(0, n - 1)
        xy, con, op = xys[gid], conics[gid], opacities[gid]
        dx = xy[..., 0][:, None, :] - px[:, :, None]  # (T, P, K)
        dy = xy[..., 1][:, None, :] - py[:, :, None]
        sigma = 0.5 * (
            con[..., 0][:, None, :] * dx * dx
            + con[..., 2][:, None, :] * dy * dy
        ) + con[..., 1][:, None, :] * dx * dy
        exp_neg = torch.exp(-sigma)
        raw_alpha = op[:, None, :] * exp_neg
        alpha = torch.clamp(raw_alpha, max=ALPHA_CLAMP)
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
        visits = (in_range & ~(dead[..., None] | stops_excl)).sum(-1)
        t_run = t_run * torch.prod(1.0 - torch.where(keep, alpha, 0.0), dim=-1)
        yield _Chunk(index, in_range, gid, dx, dy, exp_neg,
                     raw_alpha > ALPHA_CLAMP, alpha, keep, t_prev, t_run,
                     visits)
        dead = dead | stop.any(dim=-1)


def composite_tiles_fwd_plain(
    xys, conics, opacities, colors, gaussian_ids, tile_bins,
    tile_bounds: Tuple[int, int], block_width: int = 16, chunk: int = 32,
):
    """Plain PyTorch compositing (port of ``rasterize._composite_fwd_loop``)
    over :func:`_walk`.

    Returns ``(acc (T,P,ch), final_t (T,P), visited (T,P))``; ``visited``
    counts the entries each pixel evaluated (up to and including its stop),
    the work a sequential compositor does."""
    _check(xys, conics, opacities, colors, gaussian_ids, tile_bins,
           tile_bounds)
    device = xys.device
    t_p = (tile_bounds[0] * tile_bounds[1], block_width * block_width)
    final_t = torch.ones(t_p, dtype=torch.float32, device=device)
    acc = torch.zeros(t_p + (colors.shape[1],), dtype=torch.float32,
                      device=device)
    visited = torch.zeros(t_p, dtype=torch.int64, device=device)
    for c in _walk(xys, conics, opacities, gaussian_ids, tile_bins,
                   tile_bounds, block_width, chunk):
        a_k = torch.where(c.keep, c.alpha, 0.0)
        visited += c.visits
        acc += torch.einsum("tpk,tkc->tpc", c.t_prev * a_k, colors[c.gid])
        final_t = c.t_next
    return acc, final_t, visited


def composite_tiles_bwd_plain(
    xys, conics, opacities, colors, gaussian_ids, tile_bins, acc, final_t,
    g_acc, g_final_t, tile_bounds: Tuple[int, int], block_width: int = 16,
    chunk: int = 32,
):
    """Plain PyTorch compositing backward (port of
    ``rasterize._composite_bwd_loop``) over :func:`_walk`: per kept entry

        v_alpha = T_prev <g, c> - (<g, acc> - prefix_incl) / max(1 - a, 1e-3)
                  - g_T T_final / max(1 - a, 1e-3)

    gated to no mean, conic or opacity gradient where the alpha clamp was
    hit. Unlike gstk_tpu's loop, which ``segment_sum``s by Gaussian id, the
    per-intersection gradients summed over each tile's pixels are written to
    their sorted positions.

    Returns ``(gout (cap, 6+ch) [x, y, a, b, c, opacity, colors...],
    kept (T,P))``; entries no pixel kept stay zero, and ``kept`` counts the
    entries each pixel composited."""
    _check(xys, conics, opacities, colors, gaussian_ids, tile_bins,
           tile_bounds, name="composite_tiles_bwd")
    _check_planes(colors, tile_bounds, block_width, acc, final_t, g_acc,
                  g_final_t)
    device = xys.device
    ch = colors.shape[1]
    gout = torch.zeros((gaussian_ids.shape[0], 6 + ch), dtype=torch.float32,
                       device=device)
    kept = torch.zeros(final_t.shape, dtype=torch.int64, device=device)
    # <g, suffix_k> = <g, acc> - <g, prefix_k>: contract channels up front
    g_dot_acc = (g_acc * acc).sum(-1)[..., None]
    gt_tf = (g_final_t * final_t)[..., None]
    g_prefix = torch.zeros(final_t.shape, dtype=torch.float32, device=device)
    for c in _walk(xys, conics, opacities, gaussian_ids, tile_bins,
                   tile_bounds, block_width, chunk):
        a_k = torch.where(c.keep, c.alpha, 0.0)
        w = c.t_prev * a_k  # (T, P, K)
        col = colors[c.gid]  # (T, K, ch)
        con = conics[c.gid][:, None]  # (T, 1, K, 3)
        g_dot_col = torch.einsum("tpc,tkc->tpk", g_acc, col)
        prefix_incl = g_prefix[..., None] + torch.cumsum(w * g_dot_col, -1)
        inv_one_m = 1.0 / torch.clamp(1.0 - a_k, min=1.0 - ALPHA_CLAMP)
        v_alpha = (c.t_prev * g_dot_col - (g_dot_acc - prefix_incl) * inv_one_m
                   - gt_tf * inv_one_m)
        v_alpha = torch.where(c.keep, v_alpha, 0.0)
        gate = c.keep & ~c.clamped
        v_opac = torch.where(gate, c.exp_neg * v_alpha, 0.0)
        v_sigma = torch.where(gate, -c.alpha * v_alpha, 0.0)
        dx, dy = c.dx, c.dy
        per_pixel = torch.stack([
            (con[..., 0] * dx + con[..., 1] * dy) * v_sigma,
            (con[..., 2] * dy + con[..., 1] * dx) * v_sigma,
            0.5 * dx * dx * v_sigma,
            dx * dy * v_sigma,
            0.5 * dy * dy * v_sigma,
            v_opac,
        ], dim=-1)  # (T, P, K, 6)
        rows = torch.cat(
            [per_pixel.sum(1), torch.einsum("tpk,tpc->tkc", w, g_acc)], dim=-1
        )  # (T, K, 6 + ch)
        in_range = c.in_range[:, 0]
        gout[c.index[in_range]] = rows[in_range]
        kept += c.keep.sum(-1)
        g_prefix = g_prefix + (w * g_dot_col).sum(-1)
    return gout, kept


def composite_tiles_fwd(
    xys, conics, opacities, colors, gaussian_ids, tile_bins,
    tile_bounds: Tuple[int, int], block_width: int = 16, *,
    records: Optional[torch.Tensor] = None,
):
    """Composite every tile: kernel K1 on CUDA tensors, the plain twin on
    CPU tensors.

    xys (N,2), conics (N,3), opacities (N,), colors (N,ch) float32;
    gaussian_ids (cap,) int32 sorted by (tile, depth) with sentinel N;
    tile_bins (T,2) int32 ranges. Returns acc (T,256,ch), final_t (T,256).
    The kernel takes 16x16 tiles and ch in ``KERNEL_CHANNELS``, and reads
    the attributes from ``records`` (:func:`pack_records` of the same four
    arrays), built here when None; the twin ignores it."""
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
    records = _kernel_records(records, xys, conics, opacities, colors,
                              "composite_tiles_fwd")
    gids, bins = gaussian_ids.contiguous(), tile_bins.contiguous()
    acc = torch.empty((num_tiles, p, ch), dtype=torch.float32, device=device)
    final_t = torch.empty((num_tiles, p), dtype=torch.float32, device=device)
    fn = _build.kernel_function("gstk_composite_fwd", _ARGTYPES)
    with torch.cuda.device(device):
        err = fn(
            records.data_ptr(), ch, xys.shape[0], gids.data_ptr(),
            bins.data_ptr(), num_tiles, tile_bounds[0],
            acc.data_ptr(), final_t.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check("composite_tiles_fwd", err)
    composite_tiles_fwd.launches += 1
    return acc, final_t


composite_tiles_fwd.launches = 0


def composite_tiles_bwd(
    xys, conics, opacities, colors, gaussian_ids, tile_bins, acc, final_t,
    g_acc, g_final_t, tile_bounds: Tuple[int, int], block_width: int = 16, *,
    records: Optional[torch.Tensor] = None,
):
    """Per-intersection compositing gradients: kernel K2 on CUDA tensors,
    the plain twin on CPU tensors.

    The forward's inputs, its outputs ``acc (T,256,ch)`` and ``final_t
    (T,256)``, and their cotangents ``g_acc`` and ``g_final_t``. Returns
    ``gout (cap, 6+ch)``: the gradients ``[x, y, a, b, c, opacity,
    colors...]`` of each sorted entry summed over its tile's pixels, zero
    where no pixel kept the entry. The kernel takes 16x16 tiles and ch in
    ``KERNEL_CHANNELS``, and ``records`` as :func:`composite_tiles_fwd`
    does."""
    _check(xys, conics, opacities, colors, gaussian_ids, tile_bins,
           tile_bounds, name="composite_tiles_bwd")
    _check_planes(colors, tile_bounds, block_width, acc, final_t, g_acc,
                  g_final_t)
    device = xys.device
    if device.type == "cpu":
        return composite_tiles_bwd_plain(
            xys, conics, opacities, colors, gaussian_ids, tile_bins, acc,
            final_t, g_acc, g_final_t, tile_bounds, block_width,
        )[0]
    if device.type != "cuda":
        raise ValueError(f"composite_tiles_bwd: unsupported device {device}")
    ch = colors.shape[1]
    if block_width != KERNEL_BLOCK_WIDTH or ch not in KERNEL_CHANNELS:
        raise ValueError(
            f"composite_tiles_bwd kernel takes block_width "
            f"{KERNEL_BLOCK_WIDTH} and ch in {KERNEL_CHANNELS}; got "
            f"block_width {block_width}, ch {ch}"
        )
    num_tiles = tile_bounds[0] * tile_bounds[1]
    records = _kernel_records(records, xys, conics, opacities, colors,
                              "composite_tiles_bwd")
    args = [x.contiguous() for x in (gaussian_ids, tile_bins, acc, final_t,
                                     g_acc, g_final_t)]
    gout = torch.zeros((gaussian_ids.shape[0], 6 + ch), dtype=torch.float32,
                       device=device)
    fn = _build.kernel_function("gstk_composite_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(device):
        err = fn(
            records.data_ptr(), ch, xys.shape[0], args[0].data_ptr(),
            args[1].data_ptr(), num_tiles, tile_bounds[0],
            args[2].data_ptr(), args[3].data_ptr(), args[4].data_ptr(),
            args[5].data_ptr(), gout.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check("composite_tiles_bwd", err)
    composite_tiles_bwd.launches += 1
    return gout


composite_tiles_bwd.launches = 0
