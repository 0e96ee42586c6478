"""K4's share of its roofline in a traced MeloTTS run (csrc/tail.cu at
MeloTTS's stages 2-4: upsample kernels 8 and 2, 64, 32 and 16 channels, the
last with conv_post): the least time its work takes (ovbench/flops ``k4``)
over its records' device time.  Read only from a complete trace."""

from ovbench.flops import melo

KERNELS = {"tail_cuda": ("tail_stage_kernel",)}


def read(ctx) -> float | None:
    return melo.roofline_share(ctx, "melo-tts-interactive", KERNELS)
