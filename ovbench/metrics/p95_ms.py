"""95th percentile of the latencies `p50_ms` takes the median of: the wait
an interactive user feels.  Host clock."""

from ovbench.harness import percentile


def read(ctx) -> float | None:
    return percentile([1e3 * (r.t_done - r.t_submit) for r in ctx.completed], 95) if ctx.completed else None
