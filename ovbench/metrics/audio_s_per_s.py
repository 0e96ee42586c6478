"""Seconds of audio answered in the window, a second of window: what an
hour of the card buys.  Host clock, client side."""


def read(ctx) -> float | None:
    return sum(r.audio_s for r in ctx.completed) / ctx.window_s if ctx.completed else None
