"""Median latency of the requests answered in the window, from the client's
submit to the float audio in its hand (with the watermark, where the entry
marks).  Host clock."""

from ovbench.harness import percentile


def read(ctx) -> float | None:
    return percentile([1e3 * (r.t_done - r.t_submit) for r in ctx.completed], 50) if ctx.completed else None
