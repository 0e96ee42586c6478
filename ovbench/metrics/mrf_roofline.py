"""K3's share of its roofline in the traced run (decoder stages 0-1,
csrc/mrf.cu): the kernel with the most time above its bound."""

from ovbench.metrics.kernel_roofline import share

KERNELS = {"mrf_cuda": ("mrf_stage_kernel",)}


def read(ctx) -> float | None:
    return share(ctx, KERNELS)
