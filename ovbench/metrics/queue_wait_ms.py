"""Mean wait of a request in the batcher's queue, from submit to the
dispatch of its group: the window's rise of ``METRICS`` ``queue_seconds``
over that of ``dispatched_requests`` (serve/batcher.py ``_dispatch``).  A
program without these counters reads nothing."""


def read(ctx) -> float | None:
    counters = ctx.counters or {}
    if not counters.get("dispatched_requests") or "queue_seconds" not in counters:
        return None
    return 1e3 * counters["queue_seconds"] / counters["dispatched_requests"]
