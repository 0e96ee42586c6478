"""Share of the card's bf16 peak that the window's answered MeloTTS requests
needed: their operations (ovbench/flops/melo.py: BERT to its layer 10, the
text encoder and duration predictors, the length regulation, the
transformer-coupling flow with its attention over the frames, the decoder;
at each request's true wordpieces, tokens and frames, the widths of the
configuration file) over the window, over 989 TFLOP/s.  ``mfu``'s reader
counts a WaveNet flow, which MeloTTS lacks."""

from ovbench.flops import melo

CELL = "melo-tts-interactive"


def read(ctx) -> float | None:
    if not ctx.completed or ctx.peaks is None:
        return None
    config = melo.cell_config(CELL)
    work = sum(melo.request(config, r.work) for r in ctx.completed)
    return 100.0 * work / ctx.window_s / ctx.peaks["bf16" if ctx.precision == "bf16" else "fp32"]
