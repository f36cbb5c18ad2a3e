"""Card probes: the counterparts of the Pallas probes under ``tools/``,
the ports of ``tools/make_mono_depth.py`` and of the quality workflow's
scripts.

* :mod:`gstk_torch.tools.ablate_fwd` (P1) times clones of the compositing
  forward K1 with one part removed each (``csrc/ablate_fwd.cu``);
* :mod:`gstk_torch.tools.bench_dynrow` (P2, P3) times row moves to
  data-dependent destinations (``csrc/dynrow.cu``) against the gather
  baseline and a one-op PyTorch call.

Each is an entry point (``python -m gstk_torch.tools.<name> [--device
cpu]``) whose wrappers launch their kernel on CUDA tensors and run their
plain twin on CPU tensors. :func:`kernel_device_ms` is the device timing
they and ``chip_smoke.py`` share.

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
a TPU's default matmul rounding emulated).
"""

from __future__ import annotations

import re

import torch


PROFILER_SESSIONS = 3  # sessions tried before a kernel counts as unrecorded


def kernel_device_ms(fn, kernel_name, iters: int) -> dict:
    """Device time of the CUDA kernel whose name holds the identifier
    ``kernel_name`` (every device event when None) over ``iters`` calls of
    ``fn``, from torch.profiler.

    Returns ``ms``, the mean over the launches the profiler recorded,
    ``ms_per_call``, the recorded total over ``iters``, and
    ``profiler_launches``, the count recorded (a few more or fewer than the
    launches made have been seen on the card, so prefer ``ms``). Only
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
            return {"ms": us / 1e3 / launches, "ms_per_call": us / 1e3 / iters,
                    "profiler_launches": launches}
        names = sorted({e.key[:100] for e in device})
        print(f"  profiler session {session} of {PROFILER_SESSIONS} recorded no "
              f"launch of {label}; device events recorded: {names}")
    raise RuntimeError(f"the profiler recorded no launch of {label} in "
                       f"{PROFILER_SESSIONS} sessions of {iters} calls")
