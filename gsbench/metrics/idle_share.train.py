"""The device's idle share of the train loop, in percent: 1 minus the
device's busy time a step over the untraced window's time a step
(train_step_ms of the same run). The busy time a step is the union of the
traced stretch's device events outside the harness's snapshots of the
state and outside the refine, over the steps traced, plus the refine's
own busy time over the steps of a refine period, as the window holds one
refine in that many steps. The profiler slows the host, so the traced
stretch's own wall time would overstate the share. None when nothing ran
on the device. Not clamped: a negative share, which says that the traced
busy time exceeds the untraced step, is reported as it is and warned of
on standard error."""

import sys


def read(ctx):
    tr = ctx.trace
    step = tr.busy_us([e for e in tr.device
                       if tr.span_of(e) not in ("snapshot", "refine")])
    per = step / 1e3 / ctx.iterations
    if per <= 0:
        return None
    refines = len(tr.spans.get("refine", []))
    if refines and ctx.refine_every:
        per += tr.busy_us(tr.events_in("refine")) / 1e3 / refines / ctx.refine_every
    share = 100.0 * (1.0 - per / ctx.step_ms)
    if share < 0:
        print(f"idle_share.train: traced busy {per!r} ms a step exceeds the "
              f"untraced step {ctx.step_ms!r} ms", file=sys.stderr)
    return share
