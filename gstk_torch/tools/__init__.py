"""The ports of the reference's ``tools/``: the card probes (the
counterparts of its Pallas probes), ``make_mono_depth``, the quality
workflow's scripts, and its benchmark, profiling and preflight tools.

* :mod:`gstk_torch.tools.ablate_fwd` (P1) times clones of the compositing
  forward K1 with one part removed each (``csrc/ablate_fwd.cu``);
* :mod:`gstk_torch.tools.bench_dynrow` (P2, P3) times row moves to
  data-dependent destinations (``csrc/dynrow.cu``) against the gather
  baseline and a one-op PyTorch call.

Each is an entry point (``python -m gstk_torch.tools.<name> [--device
cpu]``) whose wrappers launch their kernel on CUDA tensors and run their
plain twin on CPU tensors. :func:`kernel_device_ms` is the device timing
they and ``chip_smoke.py`` share, beside the other helpers the tools and
``chip_smoke.py`` share: CUDA-event and host-clock timing
(:func:`event_ms`, :func:`event_samples`, :func:`host_samples`,
:func:`spread`), K1-K4's launch counts (:func:`launches_during`), and the
bound of a piece of work (:func:`bound`, with K1's and K2's work in
:func:`k1_work` and :func:`k2_work`).

:mod:`gstk_torch.tools.make_mono_depth` writes the mono-depth variant of a
raytraced dataset (host numpy; ``python -m gstk_torch.tools.make_mono_depth
--data <dir> --out <dir>``).

The quality workflow, each on the card unless given ``--device cpu``:
:mod:`~gstk_torch.tools.gen_raytraced_sharded` (the band-limited 240-view
capture), :mod:`~gstk_torch.tools.run_quality` (the 15k recipe, resumable),
:mod:`~gstk_torch.tools.summarize_run` (a run's report),
:mod:`~gstk_torch.tools.analyze_gt_aliasing` and
:mod:`~gstk_torch.tools.eval_vs_supersampled` (the ceiling analysis),
:mod:`~gstk_torch.tools.convert_lpips_weights` (LPIPS weights to ``.npz``),
:mod:`~gstk_torch.tools.quality_workflow` (all of it in one call, with a
report) and :mod:`~gstk_torch.tools.tpu_precision_probe` (the recipe with
a TPU's default matmul rounding emulated). ``quality_workflow --capture
1spp --n-views 64 --downstream --published
gstk_torch/tools/published/results_15k.json`` is the reference's round-2
run (``tools/run_15k.sh``) with its downstream toolchain.

The benchmark and profiling tools, ports of the reference's ``tools/``
scripts on the scenes of :mod:`~gstk_torch.tools.bench_point` (bench.py's
point, and ``tools/bench_kernels.py``'s bit for bit). Each runs on the
card (``python -m gstk_torch.tools.<name>``), where it times; with
``--device cpu`` it runs the plain twins untimed at a size its own
docstring gives, and checks what it computes:

* :mod:`~gstk_torch.tools.profile_step`: a per-op device-time table of
  bench.py's step (``--render``: its render), the device's busy time and
  idle share, launches made against recorded, a Chrome trace under
  ``--trace-dir`` (``traces/profile_step``), ``--parse-only``;
* :mod:`~gstk_torch.tools.bench_kernels`: K1 and K2 alone against their
  plain twins and their bounds, ``--sweep`` the fixed and marginal cost;
* :mod:`~gstk_torch.tools.bench_render`: forward-only frames a second;
* :mod:`~gstk_torch.tools.bench_refine`: one refine at 2^20 and 2^21 lanes;
* :mod:`~gstk_torch.tools.bench_sort`: the sort size cliff;
* :mod:`~gstk_torch.tools.bench_scatter` and
  :mod:`~gstk_torch.tools.bench_gather` (``geometry`` and ``locality``, the
  ports of ``tools/bench_gather_geometry.py`` and
  ``tools/bench_gather_locality.py``, and ``port``, the gather the port's
  step runs before K4, beside the same shape by other indices): scatter
  and gather economics.

:mod:`~gstk_torch.tools.preflight` is the hardware-parity gate: ``python
-m gstk_torch.tools.preflight run`` (the gpu tests on the card) or
``python3 chip_smoke.py`` writes the stamp ``.preflight_stamp_torch.json``
when it passes, ``check`` says whether the kernel files still match it,
and ``run_quality`` and ``quality_workflow`` refuse to train on CUDA
without a fresh stamp unless ``GSTK_SKIP_PREFLIGHT=1``.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import time
from typing import Callable, Dict, List

import torch

# sessions tried before a kernel counts as unrecorded: on the card CUPTI has
# recorded nothing for two sessions and everything in the next
PROFILER_SESSIONS = 5


def kernel_device_ms(fn, kernel_name, iters: int,
                     names: bool = False) -> dict:
    """Device time of the CUDA kernel whose name holds the identifier
    ``kernel_name`` (every device event when None) over ``iters`` calls of
    ``fn``, from torch.profiler.

    Returns ``ms``, the mean over the launches the profiler recorded,
    ``ms_per_call``, the recorded total over ``iters``, and
    ``profiler_launches``, the count recorded (a few more or fewer than the
    launches made have been seen on the card, so prefer ``ms``); with
    ``names``, also ``names``: each kernel matched, with its count. Only
    device-side events are matched, the name as a whole identifier. A
    session that records no launch is repeated, with the device event names
    it did record printed, up to ``PROFILER_SESSIONS`` sessions; then this
    raises."""
    from torch.profiler import ProfilerActivity, profile

    pattern = (None if kernel_name is None
               else re.compile(rf"(?<!\w){re.escape(kernel_name)}(?!\w)"))
    label = kernel_name or "any kernel"
    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILER_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        events = [e for e in device if pattern is None or pattern.search(e.key)]
        us = sum(e.self_device_time_total for e in events)
        launches = sum(e.count for e in events)
        print(f"  profiler: {launches} launches of {label} recorded for "
              f"{iters} calls, {us / 1e3:.4f} ms in all")
        if launches > 0 and us > 0:
            out = {"ms": us / 1e3 / launches, "ms_per_call": us / 1e3 / iters,
                   "profiler_launches": launches}
            if names:
                out["names"] = {e.key[:160]: e.count for e in events}
            return out
        recorded = sorted({e.key[:100] for e in device})
        print(f"  profiler session {session} of {PROFILER_SESSIONS} recorded no "
              f"launch of {label}; device events recorded: {recorded}")
    raise RuntimeError(f"the profiler recorded no launch of {label} in "
                       f"{PROFILER_SESSIONS} sessions of {iters} calls")


# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def event_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean ms a call of ``fn`` by CUDA events around ``iters`` calls,
    after one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def event_samples(fn: Callable[[], object], iters: int) -> List[float]:
    """CUDA-event ms of each of ``iters`` calls of ``fn``."""
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def host_samples(fn: Callable[[], object], iters: int) -> List[float]:
    """Host-clock ms of each of ``iters`` calls of ``fn``, synchronized
    before and after."""
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def spread(ms: List[float]) -> Dict[str, float]:
    """Median and min of ``ms``, and their count."""
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "samples": len(ms)}


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float = 0.0) -> Dict:
    """The least time the card could take for work that moves ``nbytes``
    and does ``ops`` f32 operations: ``bound_ms``, the larger of the two
    times at the peaks above, and ``bound_by``."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


K1_FLOP_PER_PAIR = 21  # ~20 FLOP + 1 exp per (pixel, entry) pair evaluated
# K2 (csrc/composite_bwd.cu): the recompute per pair evaluated, and the
# gradient per pair kept, at ch channels. The sum over pixels counts the
# 6 + ch adds a pair needs, not the butterfly's 16 padded adds and selects
# a lane, nor any shuffle: those are the kernel's cost, not the function's.
K2_FLOP_PER_PAIR = 15
K2_FLOP_PER_KEPT = lambda ch: 37 + 4 * ch


def k1_work(n_isect: int, num_tiles: int, ch: int, pairs: int) -> tuple:
    """(bytes, f32 operations) of K1: each kept entry's id and record read
    once, each tile's range read, the outputs written once."""
    return (n_isect * (4 + 4 * (6 + ch)) + num_tiles * 8
            + num_tiles * 256 * (ch + 1) * 4, pairs * K1_FLOP_PER_PAIR)


def k2_work(isect_capacity: int, n_isect: int, num_tiles: int, ch: int,
            pairs: int, kept: int) -> tuple:
    """(bytes, f32 operations) of K2: the gradient rows written, each
    entry's id and record read, the forward's outputs and cotangents read,
    the tile ranges read."""
    return (isect_capacity * (6 + ch) * 4 + n_isect * (4 + 4 * (6 + ch))
            + num_tiles * 256 * (2 * ch + 2) * 4 + num_tiles * 8,
            pairs * K2_FLOP_PER_PAIR + kept * K2_FLOP_PER_KEPT(ch))


def launches_during(fn: Callable[[], object]) -> Dict[str, int]:
    """K1-K4's launches while ``fn`` runs (each wrapper's count set to 0
    first)."""
    from gstk_torch.ops import raster_cuda, segment_kernel

    kernels = (raster_cuda.composite_tiles_fwd, raster_cuda.composite_tiles_bwd,
               segment_kernel.segment_broadcast,
               segment_kernel.segment_sum_sorted)
    for k in kernels:
        k.launches = 0
    fn()
    return {k.__name__: k.launches for k in kernels}
