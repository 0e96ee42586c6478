"""Share of the window the batcher's dispatch thread spent inside its
dispatch calls (packing, the noise draw, staging, the replay's enqueue): the
window's rise of ``METRICS`` ``busy_seconds`` over the window."""


def read(ctx) -> float | None:
    if ctx.counters is None or "busy_seconds" not in ctx.counters:
        return None
    return 100.0 * ctx.counters["busy_seconds"] / ctx.window_s
