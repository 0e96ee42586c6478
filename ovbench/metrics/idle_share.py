"""Share of the traced window in which no kernel ran on the card: one minus
the union of the kernel records' intervals over the window.  Read only
from a complete trace."""


def read(ctx) -> float | None:
    if ctx.trace is None or not ctx.trace.complete or ctx.trace.window() <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy() / ctx.trace.window())
