"""The share of its roofline that a kernel reached over the traced
stretch: the least time its work needs on the chip (the larger of its
operations over the float32 peak and its bytes over the HBM peak, counted
by ``gsbench/work/<kernel>.py`` for every traced step or request), over the
device time of its launches in the trace, in percent. None when the trace
holds no launch of it."""


def share(ctx, kernel: str):
    evs = ctx.trace.kernel_events(kernel)
    if not evs:
        return None
    seconds = sum(float(e["dur"]) for e in evs) / 1e6
    return 100.0 * ctx.least_seconds(kernel) / seconds
