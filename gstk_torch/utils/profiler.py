"""Running-mean section timers on the host clock (port of the timer half
of ``gstk_tpu/utils/profiler.py``).

``time_function`` decorates host-side sections and ``timer`` times a
``with`` block; the means are printed at exit. The timers read the host
clock and do not synchronize the device, so a section that only enqueues
device work is charged its enqueue time.
"""

from __future__ import annotations

import atexit
import functools
import time
from collections import defaultdict
from typing import Dict


class Profiler:
    """Running-average wall-clock profiler (reference utils/profiler.py:189)."""

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
        lines = ["Profiler (mean over calls):"]
        for name, total in rows:
            n = self.counts[name]
            lines.append(f"  {name}: {total / n * 1e3:.2f} ms x {n}")
        return "\n".join(lines)


PROFILER = Profiler()
_printed = False


def _print_at_exit():
    global _printed
    if not _printed and PROFILER.totals:
        _printed = True
        print(PROFILER.report(), flush=True)


atexit.register(_print_at_exit)


def time_function(fn):
    """Decorator: accumulate wall time under the function's qualname."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        PROFILER.update(fn.__qualname__, time.perf_counter() - t0)
        return out

    return wrapper


class timer:
    """Context manager: ``with timer("section"): ...``"""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        PROFILER.update(self.name, time.perf_counter() - self.t0)
