"""The program's own layer spans in a traced stretch.

``gstk_torch``'s ``utils/profiler.py::timer`` opens a range named
``gstk.<layer>`` around each layer's work while a profiler records. The
trace lists such a range as a host operation (category ``cpu_op``), so it
is among :attr:`gsbench.trace.Trace.cpu_ops`, beside the ATen calls, on
the same clock as the launch calls and the device events.

:func:`of` gathers them once a trace. :meth:`ProgramSpans.layer_of`
charges a device event to the innermost span that holds the call that
launched it, matched by correlation id as :meth:`gsbench.trace.Trace.span_of`
matches it and with the same test of time; :meth:`ProgramSpans.layer_at`
names the innermost span open at a host time. A trace of a program
without the spans gives an empty map, and every layer reads "".
"""

from __future__ import annotations

import bisect
import weakref
from collections import defaultdict
from typing import Dict, List, Tuple

PREFIX = "gstk."

_seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class ProgramSpans:
    """The ``gstk.*`` ranges of one trace, by layer."""

    def __init__(self, trace):
        self.trace = trace
        # (start, end, thread) by layer
        self.spans: Dict[str, List[Tuple[float, float, int]]] = defaultdict(list)
        for e in trace.cpu_ops:
            if e["name"].startswith(PREFIX):
                start = float(e["ts"])
                self.spans[e["name"][len(PREFIX):]].append(
                    (start, start + float(e["dur"]), e.get("tid")))
        # by layer and thread, where the spans of one name do not overlap
        self._threads: Dict[Tuple[str, int], List] = defaultdict(list)
        for name, ivs in self.spans.items():
            ivs.sort(key=lambda iv: iv[:2])
            for iv in ivs:
                self._threads[name, iv[2]].append(iv)

    def layer_at(self, ts: float, tid=None) -> str:
        """The innermost span open at host time ``ts`` ("" when none is):
        the one that started last, or of two that started together the one
        that ends first. With ``tid``, a span of that thread wins over the
        others; the autograd engine launches the backward's kernels from a
        thread of its own, which opens no span, so those fall to the span
        the calling thread has open."""
        best, key = "", None
        for (name, thread), ivs in self._threads.items():
            i = bisect.bisect_right(ivs, (ts, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= ts <= ivs[i][1]:
                k = (tid is not None and thread == tid, ivs[i][0], -ivs[i][1])
                if key is None or k > key:
                    best, key = name, k
        return best

    def layer_of(self, event: Dict) -> str:
        """The span charged with ``event``: the innermost one holding the
        call that launched it ("" when none does, or the event has no
        call)."""
        call = self.trace.calls.get(event.get("args", {}).get("correlation"))
        if call is None:
            return ""
        return self.layer_at(float(call["ts"]), call.get("tid"))


def of(trace) -> ProgramSpans:
    """The program's spans of ``trace``, gathered on the first call."""
    spans = _seen.get(trace)
    if spans is None:
        spans = _seen[trace] = ProgramSpans(trace)
    return spans
