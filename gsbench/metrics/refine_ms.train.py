"""Device time of one refine: the device events launched inside the
harness's ``gsbench.refine`` spans of the traced stretch, over the
refines in it. None when the stretch held no refine."""


def read(ctx):
    n = len(ctx.trace.spans.get("refine", []))
    evs = ctx.trace.events_in("refine")
    if not n or not evs:
        return None
    return sum(float(e["dur"]) for e in evs) / 1e3 / n
