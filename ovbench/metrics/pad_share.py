"""Share of the dispatched groups' frames that are padding: one minus the
window's rise of ``METRICS`` ``true_frames`` (the requests' own) over that
of ``dispatched_frames`` (bucket × padded rows; serve/batcher.py
``_dispatch``).  It counts the padded shape, not the device's cost: K1 and
K4 exit early on rows of length 0.  A program without these counters reads
nothing."""


def read(ctx) -> float | None:
    counters = ctx.counters or {}
    if not counters.get("dispatched_frames") or "true_frames" not in counters:
        return None
    return 100.0 * (1.0 - counters["true_frames"] / counters["dispatched_frames"])
