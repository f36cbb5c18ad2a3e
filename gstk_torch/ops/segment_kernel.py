"""Sorted-boundary segment kernels: K3 (segment broadcast) and K4 (segment
sum), each with its plain twin.

Port of ``gstk_tpu/ops/segment_kernel.py``. For boundaries ``b`` sorted
nondecreasing and up to three int32 columns ``d_c``, :func:`segment_broadcast`
computes

    out_c[j] = sum_{i: b[i] <= j} d_c[i]   (mod 2**32),   j in [0, length)

which is the composed scatter-then-cumsum of ``binning``: with ``b`` the
cumsum of per-Gaussian tile counts and ``d = 1`` it gives every intersection
slot the id of the Gaussian that owns it (sentinel N past the total).
:func:`segment_sum_sorted` is the backward pass's per-Gaussian gradient
reduction over contiguous segments with sorted ends ``hi``:

    out[c, g] = sum_{hi[g-1] <= j < hi[g]} vals[c, j]   (hi[-1] = 0)

Each wrapper launches its CUDA kernel (``csrc/segment_broadcast.cu``,
``csrc/segment_sum.cu``) for CUDA tensors and runs its plain twin only for
CPU tensors. The TPU versions' MXU limb matmuls, masked MXU contractions,
128-lane tables and chunk prefixes are TPU workarounds and are not carried
over. A CTA of K3 owns a run of 64 boundaries and writes the slots they
span, counting each slot against the run in shared memory; the slots past
the last boundary take the last prefix with no search. K4 reads the values
entry-major, (Np, rows) with each entry's rows contiguous, the order the
backward's per-intersection rows have once gathered by expansion position;
it stages a run of Gaussians' contiguous span in shared memory and sums
each segment in one thread (a warp for long segments).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from gstk_torch import _build

MAX_COLS = 3

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32 (two's complement), exactly."""
    low = torch.bitwise_and(x, 0xFFFFFFFF)
    return torch.where(low >= 2**31, low - 2**32, low).to(torch.int32)


def _check(b: torch.Tensor, ds: Sequence[torch.Tensor], length: int) -> None:
    if b.ndim != 1 or b.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"b must be a 1-D int tensor, got {b.dtype} {tuple(b.shape)}")
    if not 1 <= len(ds) <= MAX_COLS:
        raise ValueError(f"1 to {MAX_COLS} columns, got {len(ds)}")
    for d in ds:
        if d.shape != b.shape or d.dtype not in (torch.int32, torch.int64):
            raise ValueError("every column must be an int tensor shaped like b")
        if d.device != b.device:
            raise ValueError("b and the columns must be on one device")
    if length < 0 or length >= 2**31:
        raise ValueError(f"length {length} out of range")


def segment_broadcast_plain(
    b: torch.Tensor, ds: Sequence[torch.Tensor], length: int
) -> List[torch.Tensor]:
    """The definition as a scatter-add at the clamped boundaries followed by a
    cumsum, in int64 and wrapped to int32 (exact mod 2**32)."""
    _check(b, ds, length)
    b_c = torch.clamp(b.long(), max=length)
    outs = []
    for d in ds:
        buf = torch.zeros(length + 1, dtype=torch.int64, device=b.device)
        buf.index_add_(0, b_c, d.long())
        outs.append(_wrap_int32(torch.cumsum(buf[:-1], 0)))
    return outs


def segment_broadcast(
    b: torch.Tensor, ds: Sequence[torch.Tensor], length: int
) -> List[torch.Tensor]:
    """``out_c[j] = sum_{i: b[i] <= j} ds[c][i]`` (mod 2**32) for j in
    [0, length): kernel K3 on CUDA tensors, the plain twin on CPU tensors.

    ``b`` must be sorted nondecreasing and >= 0; entries past ``length``
    never contribute. Returns one (length,) int32 tensor per column."""
    _check(b, ds, length)
    if b.device.type == "cpu":
        return segment_broadcast_plain(b, ds, length)
    if b.device.type != "cuda":
        raise ValueError(f"segment_broadcast: unsupported device {b.device}")
    n = b.shape[0]
    # inclusive prefixes outside the kernel, as the TPU wrapper does
    prefix = torch.stack(
        [_wrap_int32(torch.cumsum(d.long(), 0)) for d in ds]
    ).contiguous()
    b32 = b.to(torch.int32).contiguous()
    out = torch.empty((len(ds), length), dtype=torch.int32, device=b.device)
    fn = _build.kernel_function("gstk_segment_broadcast", _ARGTYPES)
    with torch.cuda.device(b.device):
        err = fn(
            b32.data_ptr(), n, prefix.data_ptr(), len(ds), out.data_ptr(),
            length, torch.cuda.current_stream(b.device).cuda_stream,
        )
    _build.check("segment_broadcast", err)
    _build.count_launch(segment_broadcast)
    return list(out.unbind(0))


segment_broadcast.launches = 0


_SUM_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]


def _check_sum(vals_t: torch.Tensor, hi: torch.Tensor) -> None:
    if vals_t.ndim != 2 or vals_t.dtype != torch.float32:
        raise ValueError(
            f"vals_t must be (rows, Np) float32, got {vals_t.dtype} "
            f"{tuple(vals_t.shape)}"
        )
    if hi.ndim != 1 or hi.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"hi must be a 1-D int tensor, got {hi.dtype} {tuple(hi.shape)}")
    if hi.device != vals_t.device:
        raise ValueError("vals_t and hi must be on one device")


def segment_sum_sorted_plain(vals_t: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The definition as one ``index_add_`` by segment id: value j belongs to
    segment ``#{g: min(hi[g], Np) <= j}``, and values past the last end fall
    into a dropped extra segment."""
    _check_sum(vals_t, hi)
    rows, npv = vals_t.shape
    n = hi.shape[0]
    hi_c = torch.clamp(hi.long(), max=npv)
    j = torch.arange(npv, device=vals_t.device)
    seg = torch.searchsorted(hi_c, j, right=True)
    out = torch.zeros((rows, n + 1), dtype=torch.float32, device=vals_t.device)
    out.index_add_(1, seg, vals_t)
    return out[:, :n]


def segment_sum_sorted(vals_t: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``out[c, g] = sum_{hi[g-1] <= j < hi[g]} vals_t[c, j]`` (hi[-1] = 0):
    kernel K4 on CUDA tensors, the plain twin on CPU tensors.

    ``vals_t`` (rows, Np) float32, in any layout; the kernel reads it
    entry-major, so ``x.t()`` of a contiguous (Np, rows) ``x`` costs no
    copy. ``hi`` (N,) nondecreasing segment ends, clipped to Np. Returns
    (rows, N) float32, zero for empty segments; the kernel sums in a fixed
    order, so its result is the same on every run."""
    _check_sum(vals_t, hi)
    if vals_t.device.type == "cpu":
        return segment_sum_sorted_plain(vals_t, hi)
    if vals_t.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted: unsupported device {vals_t.device}")
    rows, npv = vals_t.shape
    n = hi.shape[0]
    # the kernel reads entry-major values, (Np, rows) contiguous: the
    # transpose of such a tensor goes in as it is, any other layout is
    # copied into that order first
    vals = vals_t.t()
    if not vals.is_contiguous():
        vals = vals.contiguous()
    hi32 = torch.clamp(hi, 0, npv).to(torch.int32).contiguous()
    out = torch.empty((rows, n), dtype=torch.float32, device=vals.device)
    fn = _build.kernel_function("gstk_segment_sum", _SUM_ARGTYPES)
    with torch.cuda.device(vals.device):
        err = fn(
            vals.data_ptr(), rows, npv, hi32.data_ptr(), n, out.data_ptr(),
            torch.cuda.current_stream(vals.device).cuda_stream,
        )
    _build.check("segment_sum_sorted", err)
    _build.count_launch(segment_sum_sorted)
    return out


segment_sum_sorted.launches = 0
