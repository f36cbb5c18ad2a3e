"""Probes P2 and P3: moving table rows to data-dependent places on the card.

Counterpart of ``tools/bench_dynrow.py``, which measures the TPU's dynamic
row moves against XLA's gather. On the card both probes are scatters of
512-B rows (``csrc/dynrow.cu``), timed against the gather baseline and a
one-op PyTorch call computing the same function:

* A: ``table[idx]`` with uniform random indices, the gather baseline;
* B (P2, :func:`local_perm`): a permutation of row groups inside blocks,
  ``out[b R + perm[b, i] g + r] = table[b R + i g + r]``, at (R, g) =
  (4096, 8), (4096, 1), (512, 8);
* D (P3, :func:`dynwrite`): sub-block j of W rows to slot ``dst.flat[j]``,
  ``out[dst[j] W + r] = table[j W + r]``, at W = 64, 8, 256 with R = 4096
  (R only groups the slots by the tool's grid cell, as ``dst`` (n / R,
  R / W) does).

The tool's C (``onehot_perm``) is an XLA one-hot product on the MXU in
three bf16 planes, a TPU workaround for a permutation with no Pallas kernel
behind it, and has no counterpart here.

Each wrapper launches its kernel on CUDA tensors and runs its plain twin (a
loop over blocks) on CPU tensors; :func:`index_copy_rows` is the library
call. A group or sub-block whose index is out of range is dropped by all
three, and rows no index reaches are left undefined (a permutation reaches
every row).

    python -m gstk_torch.tools.bench_dynrow [--device cpu]

prints each row's device time (torch.profiler's mean per launch; a call is
one launch) and ns per row at n = 2^20
rows of 128 f32 (512 MiB a table) and checks every result against the
library call bit for bit; with ``--device cpu`` it checks the twins at
n = 2^12 and times nothing, as the tool's ``--interpret`` run does.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from gstk_torch import _build
from gstk_torch.tools import kernel_device_ms

ROW = 128  # floats per table row
PERM_CASES = ((4096, 8), (4096, 1), (512, 8))  # B: (R, group)
DYNWRITE_CASES = ((4096, 64), (4096, 8), (4096, 256))  # D: (R, W)
ROWS_CARD, ROWS_CPU = 1 << 20, 1 << 12
ITERS = 20  # profiled calls per row

# table, index, n, R, group or W, out, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _check(name, table, index, R, rows):
    """Shapes of a (n, 128) float32 table and an int32 (n / R, R / rows)
    index on one device, with R a multiple of ``rows`` and n of R."""
    if (table.ndim != 2 or table.shape[1] != ROW
            or table.dtype != torch.float32):
        raise ValueError(f"{name}: table must be float32 (n, {ROW}); got "
                         f"{table.dtype} {tuple(table.shape)}")
    n = table.shape[0]
    if rows < 1 or R < rows or R % rows or n % R:
        raise ValueError(f"{name}: need n % R == 0 and R % {rows} == 0; got "
                         f"n {n}, R {R}")
    if tuple(index.shape) != (n // R, R // rows) or index.dtype != torch.int32:
        raise ValueError(f"{name}: index must be int32 ({n // R}, "
                         f"{R // rows}); got {index.dtype} "
                         f"{tuple(index.shape)}")
    if table.device != index.device:
        raise ValueError(f"{name}: table on {table.device}, index on "
                         f"{index.device}")


def _launch(name, symbol, table, index, R, rows):
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    table, index = table.contiguous(), index.contiguous()
    out = torch.empty_like(table)
    fn = _build.kernel_function(symbol, _ARGTYPES)
    with torch.cuda.device(device):
        err = fn(table.data_ptr(), index.data_ptr(), table.shape[0], R, rows,
                 out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _build.check(name, err)
    return out


def perm_destinations(perm: torch.Tensor, R: int, group: int) -> torch.Tensor:
    """The global group index ``b R / g + perm[b, i]`` of every group, in
    source order (int64, flat)."""
    groups = R // group
    blocks = torch.arange(perm.shape[0], device=perm.device)[:, None]
    return (blocks * groups + perm.long()).reshape(-1)


def index_copy_rows(out, dest, table, rows: int) -> torch.Tensor:
    """The library call: ``rows``-row piece k of ``table`` to piece
    ``dest[k]`` of ``out``, one ``index_copy_``."""
    return out.view(-1, rows * ROW).index_copy_(
        0, dest, table.view(-1, rows * ROW)).view(-1, ROW)


def local_perm_plain(table, perm, R: int, group: int) -> torch.Tensor:
    """P2's plain twin: a loop over blocks, each block's groups moved by
    indexing."""
    _check("local_perm", table, perm, R, group)
    groups = R // group
    src = table.reshape(-1, groups, group * ROW)
    out = torch.empty_like(table)
    dst = out.view(-1, groups, group * ROW)
    for b in range(src.shape[0]):
        to = perm[b].long()
        ok = (to >= 0) & (to < groups)
        dst[b][to[ok]] = src[b][ok]
    return out


def local_perm(table, perm, R: int, group: int) -> torch.Tensor:
    """``out[b R + perm[b, i] group + r] = table[b R + i group + r]``: the
    P2 kernel on CUDA tensors, the plain twin on CPU tensors. ``table``
    (n, 128) float32, ``perm`` (n / R, R / group) int32."""
    _check("local_perm", table, perm, R, group)
    if table.device.type == "cpu":
        return local_perm_plain(table, perm, R, group)
    out = _launch("local_perm", "gstk_local_perm", table, perm, R, group)
    local_perm.launches += 1
    return out


local_perm.launches = 0


def dynwrite_plain(table, dst, R: int, W: int) -> torch.Tensor:
    """P3's plain twin: a loop over blocks of R rows, each block's
    sub-blocks written to their slots by indexing."""
    _check("dynwrite", table, dst, R, W)
    slots = table.shape[0] // W
    src = table.reshape(-1, R // W, W * ROW)
    out = torch.empty_like(table)
    dst_rows = out.view(slots, W * ROW)
    for b in range(src.shape[0]):
        to = dst[b].long()
        ok = (to >= 0) & (to < slots)
        dst_rows[to[ok]] = src[b][ok]
    return out


def dynwrite(table, dst, R: int, W: int) -> torch.Tensor:
    """``out[dst.flat[j] W + r] = table[j W + r]``: the P3 kernel on CUDA
    tensors, the plain twin on CPU tensors. ``table`` (n, 128) float32,
    ``dst`` (n / R, R / W) int32 slots in [0, n / W)."""
    _check("dynwrite", table, dst, R, W)
    if table.device.type == "cpu":
        return dynwrite_plain(table, dst, R, W)
    out = _launch("dynwrite", "gstk_dynwrite", table, dst, R, W)
    dynwrite.launches += 1
    return out


dynwrite.launches = 0


def _report(tag, ms, n):
    if not ms:
        print(f"{tag:>28s}: checked (plain twin, not timed)", flush=True)
    else:
        print(f"{tag:>28s}: {ms:8.4f} ms  {ms * 1e6 / n:6.3f} ns/row",
              flush=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The tool's rows A, B and D; returns by tag the case, the launches
    made, whether the result equals the library call's and (on the card)
    the plain twin's bit for bit (it raises if not), the kernel's and the
    library call's profiler timings (row A: the gather's) and the plain
    twin's time by CUDA events (one call); the times are None on the
    CPU."""
    parser = argparse.ArgumentParser(
        prog="python -m gstk_torch.tools.bench_dynrow",
        description="Time row scatters on the card (probes P2 and P3).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain twins at n = 2^12, "
                             "no timing)")
    device = torch.device(parser.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_dynrow: no CUDA device (use --device cpu)")
    timed = device.type == "cuda"
    n = ROWS_CARD if timed else ROWS_CPU
    time = lambda fn, name: kernel_device_ms(fn, name, ITERS) if timed else None
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        (rng.standard_normal((n, ROW)) * 10).astype(np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, n, n)).to(device)

    gather_ms = time(lambda: table[idx], None)
    results = {"A_gather": {"library": gather_ms}}
    _report("A_gather", gather_ms and gather_ms["ms"], n)

    cases = [("B_local_perm", R, g, local_perm, local_perm_plain,
              "local_perm_kernel") for R, g in PERM_CASES]
    cases += [("D_dynwrite", R, W, dynwrite, dynwrite_plain,
               "dynwrite_kernel") for R, W in DYNWRITE_CASES]
    for kind, R, rows, fn, plain, kernel in cases:
        nb, per = n // R, R // rows
        if fn is local_perm:
            tag = f"{kind}_R{R}_g{rows}"
            index_np = np.stack([rng.permutation(per) for _ in range(nb)])
            index = torch.from_numpy(index_np.astype(np.int32)).to(device)
            dest = perm_destinations(index, R, rows)
        else:
            tag = f"{kind}_R{R}_W{rows}"
            index_np = rng.permutation(n // rows).reshape(nb, per)
            index = torch.from_numpy(index_np.astype(np.int32)).to(device)
            dest = index.reshape(-1).long()
        before = fn.launches
        got = fn(table, index, R, rows)
        library = lambda out=torch.empty_like(table): index_copy_rows(
            out, dest, table, rows)
        equal = {"library": torch.equal(got, library())}
        plain_ms = None
        if timed:  # on the CPU the wrapper's result is the plain twin's
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            want = plain(table, index, R, rows)
            end.record()
            equal["plain"] = torch.equal(got, want)
            plain_ms = start.elapsed_time(end)
        kernel_ms = time(lambda: fn(table, index, R, rows), kernel)
        results[tag] = {"case": (R, rows), "equal": equal,
                        "kernel": kernel_ms, "library": time(library, None),
                        "plain_ms": plain_ms,
                        "launches": fn.launches - before}
        _report(tag, kernel_ms and kernel_ms["ms"], n)
        if not all(equal.values()):
            raise RuntimeError(f"{tag}: the result differs from {equal}")
    return results


if __name__ == "__main__":
    main()
