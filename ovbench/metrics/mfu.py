"""Share of the card's peak that the window's answered requests needed:
their forward passes' operations (ovbench/flops, at the published widths and
each request's true frames and tokens) over the window, over the peak of the
configuration's precision (bf16 989 TFLOP/s, or f32 67 TFLOP/s with TF32
off)."""

from ovbench import flops


def read(ctx) -> float | None:
    if not ctx.completed or ctx.peaks is None:
        return None
    work = sum(flops.request_flops(ctx.cfgs, r.work) for r in ctx.completed)
    peak = ctx.peaks["bf16" if ctx.precision == "bf16" else "fp32"]
    return 100.0 * work / ctx.window_s / peak
