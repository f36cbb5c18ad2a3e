"""Device-to-host copy time of one render request: the ``Memcpy DtoH``
device events launched inside the harness's ``gsbench.request`` spans
around ``Renderer.get_output_from_pose``, over the requests traced."""


def read(ctx):
    n = len(ctx.trace.spans.get("request", []))
    evs = [e for e in ctx.trace.events_in("request")
           if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    if not n or not evs:
        return None
    return sum(float(e["dur"]) for e in evs) / 1e3 / n
