"""Probe P1: where the compositing forward K1 spends its time on the card.

Counterpart of ``tools/ablate_fwd.py``, which times clones of gstk_tpu's
``_fwd_kernel`` with one part removed each. Here the clones are K1's own
loop (``csrc/composite_fwd.cu``) instantiated from one template in
``csrc/ablate_fwd.cu``, with K1's staging kept exactly (256-thread CTAs,
48-B records through three 16-B ``cp.async`` into a double buffer, one
barrier per batch):

* ``full``: K1's function, bit-identical to ``composite_tiles_fwd``;
* ``noexit``: no tile exit and no per-pixel break (a stopped pixel skips
  every later entry), bit-identical to ``full``;
* ``dmaonly``: the staging, the barrier and the batch loop without any
  compositing; pixel p adds word ``p mod 12`` of the batch's record p (zero
  past the range) once a batch, into channel 0, and T is 1;
* ``marg_none``: ``full`` as a separate instantiation (bit-identical);
  ``marg_sigma``: sigma = (a dx) dx in place of the conic's quadratic form;
  ``marg_exp``: 1 - sigma / 2 in place of exp(-sigma); ``marg_contrib``: one
  running sum of the weights in place of the color FMAs, in every channel.
  The marg variants are for timing; each is held against its twin.

The tool's other variants have no counterpart on the card (``REFUSED`` says
why for each) and :func:`run_variant` raises for them.

    python -m gstk_torch.tools.ablate_fwd [--device cpu]

prints each variant's device time (torch.profiler's mean per launch; a
call is one launch) and µs per tile at the tool's two shapes, T=2048 tiles
of one 128-entry chunk and T=128 tiles of 16, and checks that ``noexit``
and ``marg_none`` match ``full``. With ``--device cpu`` it runs the plain
twins on 16 chunks (T=16 and T=1) and times nothing.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gstk_torch import _build
from gstk_torch.ops.raster_cuda import (
    ALPHA_CLAMP,
    ALPHA_CUTOFF,
    RECORD_WIDTH,
    T_CUTOFF,
    pack_records,
)
from gstk_torch.tools import kernel_device_ms

# the variants csrc/ablate_fwd.cu instantiates, in the order of its Variant
# codes
VARIANTS = ("full", "noexit", "dmaonly", "marg_none", "marg_sigma",
            "marg_exp", "marg_contrib")
# the variants of tools/ablate_fwd.py that have no counterpart on the card
REFUSED = {
    "accloop": "K1 already keeps its color accumulators in registers and "
               "writes each pixel once, so on the card accloop is full",
    "noreshape": "it drops the TPU's (P, 1) -> (1, P) relayout of T, which "
                 "K1 does not do",
    "batchT": "it batches the TPU's relayout of T across a grid cell's "
              "tiles, which K1 does not do",
    "batchTmxu": "it moves the TPU's relayout of T onto the MXU, which K1 "
                 "does not do",
    "marg_transpose": "it drops the TPU's MXU transpose of a chunk, which K1 "
                      "does not do",
    "marg_cumsum": "K1 runs T one pixel and entry at a time, with no "
                   "log-space prefix sum to drop",
    "marg_log1p": "K1 runs T one pixel and entry at a time, with no log1p "
                  "to drop",
    "pair": "it interleaves two chunks' MXU and VPU dependency chains, a "
            "TPU split K1 does not have",
}
KERNEL_CH = 4  # the channels csrc/ablate_fwd.cu is instantiated for
BLOCK = 16
PIXELS = BLOCK * BLOCK
BATCH = PIXELS  # entries a CTA stages at once
CHUNK = 128  # entries per chunk of the tool's scene
SHAPES = (1, 16)  # the tool's chunks per tile
TOTAL_CHUNKS = 2048  # the tool's chunks in all
TOTAL_CHUNKS_CPU = 16  # a size the plain twins run in seconds
ITERS = 20  # profiled calls per variant

# variant, records, ch, n, gids, tile_bins, num_tiles, tiles_x, acc,
# final_t, stream
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def probe_scene(c_per_tile: int, total_chunks: int = TOTAL_CHUNKS,
                ch: int = KERNEL_CH, seed: int = 0, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The tool's scene in K1's inputs: ``(records, gids, tile_bins,
    tiles_x)``.

    ``total_chunks`` chunks of 128 entries, ``c_per_tile`` per tile, on
    T = total_chunks / c_per_tile tiles in one row. Each entry is its own
    Gaussian (gids ``arange``): mean (16 tile + 8, 8), conic (1e-4, 0,
    1e-4), opacity 0.004, colors U[0, 1) from ``np.random.default_rng(seed)``
    as the tool draws them. Every pair keeps (T stays above 1e-4 through
    2048 entries: 0.996^2048 is about 2.7e-4), so every variant composites
    the full work."""
    if total_chunks % c_per_tile:
        raise ValueError(f"total_chunks {total_chunks} is not a multiple of "
                         f"c_per_tile {c_per_tile}")
    tiles = total_chunks // c_per_tile
    cap = total_chunks * CHUNK
    rng = np.random.default_rng(seed)
    tile_of = np.arange(cap) // (c_per_tile * CHUNK)
    xys = np.stack([tile_of * 16 + 8.0, np.full(cap, 8.0)], 1).astype(np.float32)
    conics = np.tile(np.float32([1e-4, 0.0, 1e-4]), (cap, 1))
    opacities = np.full(cap, 0.004, np.float32)
    colors = rng.uniform(0, 1, (cap, 4)).astype(np.float32)[:, :ch]
    bins = np.stack([np.arange(tiles) * c_per_tile * CHUNK,
                     (np.arange(tiles) + 1) * c_per_tile * CHUNK], axis=-1)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    records = pack_records(to(xys), to(conics), to(opacities), to(colors))
    gids = torch.arange(cap, dtype=torch.int32, device=records.device)
    return records, gids, to(bins.astype(np.int32)), tiles


def _check_variant(variant: str) -> int:
    if variant in REFUSED:
        raise ValueError(f"ablation variant {variant!r} has no counterpart on "
                         f"the card: {REFUSED[variant]}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown ablation variant {variant!r}; the card's "
                         f"are {VARIANTS}")
    return VARIANTS.index(variant)


def _check_inputs(records, gids, tile_bins, tiles_x, ch):
    n = records.shape[0] if records.ndim == 2 else -1
    if (records.ndim != 2 or records.shape[1] != RECORD_WIDTH
            or records.dtype != torch.float32):
        raise ValueError(f"records must be float32 (N, {RECORD_WIDTH}) "
                         f"(pack_records); got {records.dtype} "
                         f"{tuple(records.shape)}")
    if gids.ndim != 1 or gids.dtype != torch.int32:
        raise ValueError(f"gids must be 1-D int32; got {gids.dtype} "
                         f"{tuple(gids.shape)}")
    if (tile_bins.ndim != 2 or tile_bins.shape[1] != 2
            or tile_bins.dtype != torch.int32):
        raise ValueError(f"tile_bins must be int32 (T, 2); got "
                         f"{tile_bins.dtype} {tuple(tile_bins.shape)}")
    if tiles_x < 1 or tile_bins.shape[0] % tiles_x:
        raise ValueError(f"tiles_x {tiles_x} does not divide the "
                         f"{tile_bins.shape[0]} tiles")
    if not 1 <= ch <= RECORD_WIDTH - 6:
        raise ValueError(f"ch {ch} outside 1..{RECORD_WIDTH - 6}")
    if len({records.device, gids.device, tile_bins.device}) != 1:
        raise ValueError("records, gids and tile_bins on different devices")
    return n


def ablate_fwd_plain(variant: str, records, gids, tile_bins, tiles_x: int,
                     ch: int = KERNEL_CH):
    """The plain twin of ``variant``: ``(acc (T, 256, ch), final_t (T,
    256))`` as the kernel computes them, walking every tile's range entry
    by entry, all tiles and pixels at once (sigma rounded op by op in the
    kernels' order; the color sums are not fused, so they may differ from
    the kernel's FMAs in the last bits)."""
    _check_variant(variant)
    n = _check_inputs(records, gids, tile_bins, tiles_x, ch)
    device = records.device
    num_tiles, cap = tile_bins.shape[0], gids.shape[0]
    tile = torch.arange(num_tiles, device=device)[:, None]
    pix = torch.arange(PIXELS, device=device)[None, :]
    px = ((tile % tiles_x) * BLOCK + pix % BLOCK).float()
    py = ((tile // tiles_x) * BLOCK + pix // BLOCK).float()
    start = tile_bins[:, 0].long()
    end = tile_bins[:, 1].long()
    longest = int((end - start).clamp(min=0).max()) if num_tiles else 0
    if cap == 0 or n == 0:
        longest = 0

    def staged(index, live):
        """Records at sorted positions ``index`` where ``live``; a sentinel
        or an id out of range reads zeros, as the kernel's staging does."""
        gid = torch.where(live, gids[index.clamp(0, cap - 1)].long(), n)
        ok = (gid >= 0) & (gid < n)
        rec = records[gid.clamp(0, max(n - 1, 0))]
        return torch.where(ok[..., None], rec, 0.0)

    acc = torch.zeros((num_tiles, PIXELS, ch), dtype=torch.float32,
                      device=device)
    final_t = torch.ones((num_tiles, PIXELS), dtype=torch.float32,
                         device=device)
    if variant == "dmaonly":
        word = (pix % RECORD_WIDTH).expand(num_tiles, PIXELS)
        total = torch.zeros((num_tiles, PIXELS), dtype=torch.float32,
                            device=device)
        for b0 in range(0, longest, BATCH):
            index = start[:, None] + b0 + pix
            rec = staged(index, index < end[:, None])  # (T, P, 12)
            total = total + rec.gather(-1, word[..., None])[..., 0]
        acc[..., 0] = total
        return acc, final_t

    t = final_t
    done = torch.zeros((num_tiles, PIXELS), dtype=torch.bool, device=device)
    wsum = torch.zeros((num_tiles, PIXELS), dtype=torch.float32, device=device)
    for k in range(longest):
        live = start + k < end
        r = staged(start + k, live)[:, None, :]  # (T, 1, 12)
        dx = r[..., 0] - px
        dy = r[..., 1] - py
        a, b, c, op = r[..., 2], r[..., 3], r[..., 4], r[..., 5]
        if variant == "marg_sigma":
            sigma = (a * dx) * dx
        else:
            sigma = 0.5 * ((a * dx) * dx + (c * dy) * dy) + (b * dx) * dy
        if variant == "marg_exp":
            falloff = 1.0 - 0.5 * sigma
        else:
            falloff = torch.exp(-sigma)
        alpha = torch.clamp(op * falloff, max=ALPHA_CLAMP)
        ok = (live[:, None] & ~done & (sigma >= 0.0)
              & (alpha >= ALPHA_CUTOFF))
        next_t = t * (1.0 - alpha)
        stop = ok & (next_t <= T_CUTOFF)
        keep = ok & ~stop
        w = torch.where(keep, alpha * t, 0.0)
        if variant == "marg_contrib":
            wsum = wsum + w
        else:
            acc = acc + w[..., None] * r[..., 6:6 + ch]
        t = torch.where(keep, next_t, t)
        done = done | stop
    if variant == "marg_contrib":
        acc = wsum[..., None].expand(num_tiles, PIXELS, ch).contiguous()
    return acc, t


def run_variant(variant: str, records, gids, tile_bins, tiles_x: int,
                ch: int = KERNEL_CH):
    """``variant``'s ``(acc (T, 256, ch), final_t (T, 256))``: its kernel on
    CUDA tensors (ch 4 only), its plain twin on CPU tensors. Raises for a
    variant the card has no counterpart of."""
    code = _check_variant(variant)
    n = _check_inputs(records, gids, tile_bins, tiles_x, ch)
    device = records.device
    if device.type == "cpu":
        return ablate_fwd_plain(variant, records, gids, tile_bins, tiles_x, ch)
    if device.type != "cuda":
        raise ValueError(f"run_variant: unsupported device {device}")
    if ch != KERNEL_CH:
        raise ValueError(f"the ablation kernels take ch {KERNEL_CH}; got {ch}")
    if not records.is_contiguous() or records.data_ptr() % 16:
        raise ValueError("records must be contiguous and 16-B aligned")
    num_tiles = tile_bins.shape[0]
    gids, bins = gids.contiguous(), tile_bins.contiguous()
    acc = torch.empty((num_tiles, PIXELS, ch), dtype=torch.float32,
                      device=device)
    final_t = torch.empty((num_tiles, PIXELS), dtype=torch.float32,
                          device=device)
    fn = _build.kernel_function("gstk_ablate_fwd", _ARGTYPES)
    with torch.cuda.device(device):
        err = fn(code, records.data_ptr(), ch, n, gids.data_ptr(),
                 bins.data_ptr(), num_tiles, tiles_x, acc.data_ptr(),
                 final_t.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    _build.check(f"run_variant({variant!r})", err)
    _build.count_launch(run_variant)
    return acc, final_t


run_variant.launches = 0


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The probe at the tool's two shapes; returns, by chunks per tile,
    ``tiles``, ``launches`` (kernel launches made at that shape) and by
    variant its profiler timing (None on the CPU)."""
    parser = argparse.ArgumentParser(
        prog="python -m gstk_torch.tools.ablate_fwd",
        description="Time K1's ablation clones on the card (probe P1).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain twins at 16 "
                             "chunks, no timing)")
    device = torch.device(parser.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ablate_fwd: no CUDA device (use --device cpu)")
    timed = device.type == "cuda"
    total_chunks = TOTAL_CHUNKS if timed else TOTAL_CHUNKS_CPU
    results, mismatched = {}, []
    for c_per_tile in SHAPES:
        records, gids, bins, tiles = probe_scene(
            c_per_tile, total_chunks, KERNEL_CH, 0, device)
        inputs = (records, gids, bins, tiles, KERNEL_CH)
        print(f"--- T={tiles} C={c_per_tile} ---", flush=True)
        before = run_variant.launches
        shape = {"tiles": tiles, "variants": {}}
        base = None
        for variant in VARIANTS:
            out = run_variant(variant, *inputs)
            timing = None
            if timed:
                timing = kernel_device_ms(lambda: run_variant(variant, *inputs),
                                          "ablate_fwd_kernel", ITERS)
            note = ""
            if variant == "full":
                base = out
            elif variant in ("noexit", "marg_none"):
                same = all(torch.equal(x, y) for x, y in zip(out, base))
                note = "  (matches full)" if same else "  (MISMATCH with full)"
                if not same:
                    mismatched.append((tiles, variant))
            shape["variants"][variant] = timing
            if timing is None:
                print(f"{variant:12s}: not measured (plain twin on "
                      f"{device.type}){note}")
            else:
                ms = timing["ms"]
                print(f"{variant:12s}: {ms:8.4f} ms "
                      f"({ms / tiles * 1e3:7.4f} us/tile){note}")
        shape["launches"] = run_variant.launches - before
        results[c_per_tile] = shape
    if mismatched:
        raise RuntimeError(f"variants that must match full do not: {mismatched}")
    return results


if __name__ == "__main__":
    main()
