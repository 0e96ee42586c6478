"""The convert graph's receptive field (the port's part of
``openvoice_tpu/runtime/sequence_parallel.py``).

Every stage of the convert graph (posterior WaveNet, the coupling flow, the
HiFi-GAN decoder) is a finite-receptive-field convolution stack, so a chunk
of frames extended by `required_halo` frames on each side computes its
middle exactly as the whole sequence would.  `runtime/streaming.py` relies
on it.  The JAX module's sharded ``voice_conversion_sp`` (time split across
a mesh's devices, halos exchanged between neighbours) waits for the port's
distributed runtime.
"""

from __future__ import annotations

from openvoice_tpu_torch.config import SynthesizerConfig


def required_halo(cfg: SynthesizerConfig) -> int:
    """Total receptive-field halo (frames) of the convert graph, from config.

    Per dilated conv the one-sided halo is (k-1)/2 · dilation; stages add.
    The vocoder's sample-rate halos are divided back to frame units by the
    cumulative upsample factor and rounded up.
    """
    def wn(k, layers):
        return (k - 1) // 2 * layers  # dilation_rate 1 everywhere

    h = wn(cfg.enc_q_kernel_size, cfg.enc_q_layers)
    h += 2 * cfg.flow_n_flows * wn(cfg.flow_kernel_size, cfg.flow_wn_layers)
    # vocoder: conv_pre k7 pad 3 at frame rate, then per-stage resblock halos
    dec = 3.0
    up = 1
    for u in cfg.upsample_rates:
        up *= u
        stage = 0
        for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            stage = max(stage, sum((k - 1) // 2 * d + (k - 1) // 2 for d in dils))
        dec += stage / up
    dec += 3.0 / up  # conv_post k7
    return int(h + dec + 1)
