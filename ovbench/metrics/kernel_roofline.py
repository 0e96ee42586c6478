"""The hand-written kernels' share of their rooflines in the traced run: the
least time the card could take for the work of every request the trace
holds (ovbench/flops: K1-K5 at each request's true frames), over the device
time of those kernels' records.  Read only from a complete trace."""

from ovbench import flops

KERNELS = {  # the wrapper module's launches → the kernels' names in the trace
    "stft_cuda": ("stft_fft_kernel", "stft_dft_kernel"),
    "wn_cuda": ("wn_stack_kernel",),
    "coupling_cuda": ("coupling_kernel",),
    "mrf_cuda": ("mrf_stage_kernel",),
    "tail_cuda": ("tail_stage_kernel",),
}


def share(ctx, modules: dict) -> float | None:
    if ctx.trace is None or not ctx.trace.complete or ctx.peaks is None or not ctx.traced:
        return None
    bound = 0.0
    for r in ctx.traced:
        for module, (flop, nbytes) in flops.request_kernels(ctx.cfgs, r.work).items():
            if module in modules and flop:
                bound += flops.bound_s(module, flop, nbytes, ctx.peaks)
    spent = sum(ctx.trace.time_of(names) for names in modules.values())
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None


def read(ctx) -> float | None:
    return share(ctx, KERNELS)
