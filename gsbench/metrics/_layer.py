"""Device and idle time of the program's own layers in the traced
stretch, a step or request, in ms.

The program opens a ``gstk.<layer>`` range around each layer's work while
the profiler records; :mod:`gsbench.program` gathers them from the trace's
host operations. A device event is charged to the innermost such span
that holds the call that launched it
(:meth:`~gsbench.program.ProgramSpans.layer_of`). An idle gap of the
device, a stretch between the union of its events as ``run.py``'s
``breakdown`` finds them, is charged to the innermost span the host was in
when the gap began (:meth:`~gsbench.program.ProgramSpans.layer_at`). Both
are summed over the traced stretch and divided by the steps or requests in
it. None when the trace holds no device event (as on the CPU) or no span
of the layer (a program without the spans)."""

from gsbench import program


def _spans(ctx, layer: str):
    if not ctx.trace.device:
        return None
    spans = program.of(ctx.trace)
    return spans if spans.spans.get(layer) else None


def device_ms(ctx, layer: str):
    """Device time of the events the layer launched, a step or request."""
    spans = _spans(ctx, layer)
    if spans is None:
        return None
    us = sum(float(e["dur"]) for e in ctx.trace.matched if spans.layer_of(e) == layer)
    return us / 1e3 / ctx.iterations


def gaps(trace):
    """The device's idle gaps, ``(start, end)`` in host-clock us."""
    ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in trace.device)
    out, end = [], None
    for s, t in ivs:
        if end is not None and s > end:
            out.append((end, s))
        end = t if end is None else max(end, t)
    return out


def idle_ms(ctx, layer: str):
    """Idle time of the device in the gaps that began while the host was
    in the layer, a step or request."""
    spans = _spans(ctx, layer)
    if spans is None:
        return None
    us = sum(t - s for s, t in gaps(ctx.trace) if spans.layer_at(s) == layer)
    return us / 1e3 / ctx.iterations
