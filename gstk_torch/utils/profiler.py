"""Layer spans: a running mean of each span on the host clock and, while
a ``torch.profiler`` session records, a range in its trace (port of the
timer half of ``gstk_tpu/utils/profiler.py``).

A span is ``with timer(name): ...`` around one layer's work, opened on the
calling thread and never inside an autograd ``Function.backward``. It
always adds its host wall time to :data:`PROFILER`, whose means the
trainer prints at the end of a run. That time does not synchronize the
device: a span that only enqueues device work is charged its enqueue time.

While a profiler session records, the span also opens a range named
``"gstk." + name`` with torch's fast record-function, which the trace
lists as a host operation (category ``cpu_op``, beside the ATen calls it
holds) rather than as a user annotation. It lands in the same Chrome
trace as the device events, on one clock: a device event can then be
charged to the span whose host interval holds the call that launched it,
and an idle stretch of the device to the span the host was in when the
stretch began. With no session recording, no range is entered (one test
of a flag, about 0.1 us).

The spans of the port, by layer: ``step`` (one train step, from
:func:`gstk_torch.train.step.make_train_step`), ``project`` (projection,
SH, colours and opacities), ``raster`` (footprints, binning and sort,
compositing), ``loss``, with ``depth_terms`` inside it (co-gs's depth
terms), ``backward``, ``update`` (densify statistics and Adam),
``camera`` (camera optimisation: the adjustment's exp map before
``project``, the pose penalty inside ``loss``, the camera group's Adam and
metrics inside ``update``), ``refine``, ``grow_capacity`` and
``save_checkpoint`` (the trainer's), and ``copy_out`` (a render's outputs
to the host).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast as record_range

PREFIX = "gstk."


class Profiler:
    """Running mean of each span's host wall time (reference
    utils/profiler.py:189)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def update(self, name: str, dt: float) -> None:
        self.totals[name] += dt
        self.counts[name] += 1

    def report(self) -> str:
        rows = sorted(
            self.totals.items(), key=lambda kv: kv[1], reverse=True
        )
        lines = ["Spans (host ms, mean over calls):"]
        for name, total in rows:
            n = self.counts[name]
            lines.append(f"  {name}: {total / n * 1e3:.2f} ms x {n}")
        return "\n".join(lines)


PROFILER = Profiler()


class timer:
    """A span: ``with timer("section"): ...``"""

    __slots__ = ("name", "t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _profiler_enabled():
            self._range = record_range(PREFIX + self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        PROFILER.update(self.name, time.perf_counter() - self.t0)
        if self._range is not None:
            self._range.__exit__(*exc)
