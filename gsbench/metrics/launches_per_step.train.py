"""Device events a train step puts on the card: the kernels, copies and
fills launched inside the harness's ``gsbench.step`` spans and matched to
their launch, copy or fill call by correlation id, over the steps traced
(refines and metric fetches have their own spans)."""


def read(ctx):
    n = len(ctx.trace.spans.get("step", []))
    evs = ctx.trace.events_in("step")
    if not n or not evs:
        return None
    return len(evs) / n
