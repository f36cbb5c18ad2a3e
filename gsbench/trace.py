"""The traced stretch: record it with ``torch.profiler``, read the Chrome
trace back, and tie each device event to the host span that launched it.

The arithmetic is ``gstk_torch/tools/profile_step.py``'s, copied: device
events are the trace's kernels, copies and fills; each is matched by its
correlation id to the runtime call (a launch, copy or fill) that put it on
the device; the device's busy time is the length of the union of their
intervals. Here each matched call is also placed in the harness's span
(``gsbench.<name>``) whose host interval holds it, so that a metric can
take the device time of one layer's calls.

:func:`check` refuses a trace that lost events: a launch, copy or fill call
with no device event, or a count of K1-K4 kernels other than the
wrappers' own launch counters.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")
CALL_WORDS = ("Launch", "Memcpy", "Memset")
WINDOW = "gsbench.window"
# K1-K4: the wrapper (module, function) and its CUDA kernel's name
KERNELS = {
    "k1": ("gstk_torch.ops.raster_cuda", "composite_tiles_fwd", "composite_fwd_kernel"),
    "k2": ("gstk_torch.ops.raster_cuda", "composite_tiles_bwd", "composite_bwd_kernel"),
    "k3": ("gstk_torch.ops.segment_kernel", "segment_broadcast", "segment_broadcast_kernel"),
    "k4": ("gstk_torch.ops.segment_kernel", "segment_sum_sorted", "segment_sum_kernel"),
}


def busy_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, duration)`` intervals."""
    total, end = 0.0, float("-inf")
    for start, dur in sorted(spans):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def _wrappers():
    import importlib

    return {k: getattr(importlib.import_module(mod), fn)
            for k, (mod, fn, _) in KERNELS.items()}


def record(body: Callable[[], None], device) -> "Trace":
    """Run ``body`` under the profiler inside a ``gsbench.window`` span and
    return the parsed trace with the wrappers' launches made during it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    wrappers = _wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    prof = profile(activities=acts)
    with prof:
        with torch.profiler.record_function(WINDOW):
            body()
    made = {k: w.launches - before[k] for k, w in wrappers.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events, made)


class Trace:
    """The parsed events of one traced stretch."""

    def __init__(self, events: List[Dict], made: Dict[str, int]):
        xs = [e for e in events if e.get("ph") == "X"]
        self.made = made
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATEGORIES]
        calls = [e for e in xs if e.get("cat") in CALL_CATEGORIES
                 and any(w in e.get("name", "") for w in CALL_WORDS)
                 and "correlation" in e.get("args", {})]
        self.calls = {e["args"]["correlation"]: e for e in calls}
        self.cpu_ops = [e for e in xs if e.get("cat") == "cpu_op"]
        annos = [e for e in xs if e.get("cat") == "user_annotation"]
        windows = [e for e in annos if e["name"] == WINDOW]
        self.window = windows[-1] if windows else None
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in annos:
            if e["name"].startswith("gsbench.") and e["name"] != WINDOW:
                self.spans[e["name"][len("gsbench."):]].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for v in self.spans.values():
            v.sort()
        self.matched = [e for e in self.device
                        if e.get("args", {}).get("correlation") in self.calls]

    def span_of(self, event: Dict) -> str:
        """The harness span whose host interval holds the call that
        launched ``event`` ("" when none does)."""
        call = self.calls.get(event.get("args", {}).get("correlation"))
        if call is None:
            return ""
        ts = float(call["ts"])
        for name, ivs in self.spans.items():
            i = bisect.bisect_right(ivs, (ts, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= ts <= ivs[i][1]:
                return name
        return ""

    def events_in(self, span: str) -> List[Dict]:
        return [e for e in self.matched if self.span_of(e) == span]

    def kernel_events(self, key: str) -> List[Dict]:
        sym = KERNELS[key][2]
        pat = re.compile(rf"(?<!\w){sym}(?!\w)")
        return [e for e in self.device if e.get("cat") == "kernel"
                and pat.search(e.get("name", ""))]

    def window_us(self) -> float:
        return float(self.window["dur"]) if self.window else 0.0

    def busy_us(self, events=None) -> float:
        evs = self.device if events is None else events
        return busy_us((float(e["ts"]), float(e["dur"])) for e in evs)


def check(trace: Trace, on_card: bool) -> List[str]:
    """What the trace lost, as messages; empty when it is whole."""
    problems = []
    if not on_card:
        return problems
    if not trace.device:
        problems.append("the trace holds no device event")
    unmatched = len(trace.calls) - len({e["args"]["correlation"] for e in trace.matched})
    if unmatched:
        problems.append(f"{unmatched} of {len(trace.calls)} launch, copy or fill "
                        "calls have no device event")
    for key, made in trace.made.items():
        got = len(trace.kernel_events(key))
        if got != made:
            problems.append(f"{KERNELS[key][2]}: {made} launches made, {got} recorded")
    return problems
