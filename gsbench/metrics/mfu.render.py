"""A render request's share of the chip's float32 peak (67 TFLOP/s), in
percent: the operations of the traced requests (``gsbench/work/render.py``)
over their count, divided by the untraced window's time a request (one
over ``render_fps`` of the same run) times the peak."""


def read(ctx):
    works = ctx.work("render")
    if not works:
        return None
    flops = sum(w["flops"] for w in works) / len(works)
    return 100.0 * flops / (ctx.step_ms / 1e3 * ctx.f32_peak)
