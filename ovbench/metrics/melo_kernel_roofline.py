"""The hand-written kernels' share of their rooflines in a traced MeloTTS
run: the least time the card could take for K3's and K4's work (decoder
stages 0-1 and 2-4, at each traced request's true frames; ovbench/flops
``k3`` and ``k4`` through ovbench/flops/melo.py) over the device time of
those kernels' records.  Read only from a complete trace."""

from ovbench.flops import melo

KERNELS = {"mrf_cuda": ("mrf_stage_kernel",), "tail_cuda": ("tail_stage_kernel",)}


def read(ctx) -> float | None:
    return melo.roofline_share(ctx, "melo-tts-interactive", KERNELS)
