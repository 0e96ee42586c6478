"""Requests a dispatched group carried: requests answered in the window over
the window's rise of the batcher's ``batches`` counter (serve/batcher.py,
runtime/profiler.py::METRICS)."""


def read(ctx) -> float | None:
    batches = (ctx.counters or {}).get("batches", 0)
    return len(ctx.completed) / batches if batches else None
