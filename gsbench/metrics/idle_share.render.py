"""The device's idle share of the render loop, in percent: 1 minus the
device's busy time a request (the union of the traced stretch's device
events, leaving out the harness's own snapshots of the state, over the
requests traced) over the untraced window's time a request (one over
render_fps of the same run). The profiler slows the host, so the traced
stretch's own wall time would overstate the share. None when nothing ran
on the device. Not clamped: a negative share, which says that the traced
busy time exceeds the untraced request, is reported as it is and warned
of on standard error."""

import sys


def read(ctx):
    tr = ctx.trace
    busy = tr.busy_us([e for e in tr.device if tr.span_of(e) != "snapshot"])
    per = busy / 1e3 / ctx.iterations
    if per <= 0:
        return None
    share = 100.0 * (1.0 - per / ctx.step_ms)
    if share < 0:
        print(f"idle_share.render: traced busy {per!r} ms a request exceeds "
              f"the untraced request {ctx.step_ms!r} ms", file=sys.stderr)
    return share
