"""K3's share of its roofline in a traced MeloTTS run (csrc/mrf.cu at
MeloTTS's decoder stages 0-1, 256 and 128 channels): the least time its
work takes (ovbench/flops ``k3``, at each traced request's true frames,
through ovbench/flops/melo.py) over its records' device time.  Read only
from a complete trace."""

from ovbench.flops import melo

KERNELS = {"mrf_cuda": ("mrf_stage_kernel",)}


def read(ctx) -> float | None:
    return melo.roofline_share(ctx, "melo-tts-interactive", KERNELS)
