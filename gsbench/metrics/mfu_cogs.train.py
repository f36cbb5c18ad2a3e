"""The co-gs train step's share of the chip's float32 peak (67 TFLOP/s,
H100 SXM, outside the tensor cores), in percent: the operations of the
traced steps (``gsbench/work/step_cogs.py``: the vanilla step's and the
depth terms', the planar fit's and the camera group's) over their count,
divided by the untraced window's time a step (``train_step_ms`` of the
same run) times the peak."""


def read(ctx):
    works = ctx.work("step_cogs")
    if not works:
        return None
    flops = sum(w["flops"] for w in works) / len(works)
    return 100.0 * flops / (ctx.step_ms / 1e3 * ctx.f32_peak)
