"""Sequence (context) parallelism for long-utterance conversion (the port of
``openvoice_tpu/runtime/sequence_parallel.py``).

Every stage of the convert graph (posterior WaveNet, the coupling flow, the
HiFi-GAN decoder) is a finite-receptive-field convolution stack, so a chunk
of frames extended by `required_halo` frames on each side computes its
middle exactly as the whole sequence would.  `runtime/streaming.py` relies
on it, and so does `voice_conversion_sp`: the time axis is split over a
mesh axis, each position receives `halo` frames from each neighbour once
(two exchanges for the whole graph; the ring's edges receive zeros, the
implicit zero padding of a "same" convolution at the sequence's ends), runs
the whole convert graph on its extended chunk, and keeps its middle.  The
frame mask is rebuilt from global positions, so every per-layer mask equals
the unsplit graph's, inside the halos too.
"""

from __future__ import annotations

import torch

from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.models.synthesizer import Synthesizer, voice_conversion_masked
from openvoice_tpu_torch.runtime.mesh import Comm, Mesh, Sharded, comms, spmd
from openvoice_tpu_torch.runtime.parallel import replicate


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


def _halo_exchange(x: torch.Tensor, comm: Comm, halo: int) -> torch.Tensor:
    """[B, T_loc, C] → [B, halo + T_loc + halo, C]: the left neighbour's last
    `halo` frames, then the right neighbour's first (zeros at the edges)."""
    left = comm.shift(x[:, -halo:].contiguous(), 1)
    right = comm.shift(x[:, :halo].contiguous(), -1)
    return torch.cat([left, x, right], dim=1)


def voice_conversion_sp(model: Synthesizer, spec: torch.Tensor, spec_lengths: torch.Tensor,
                        g_src: torch.Tensor, g_tgt: torch.Tensor, tau, noise: torch.Tensor, *,
                        mesh: Mesh, axis: str = "model", halo: int | None = None) -> Sharded:
    """Sequence-parallel tone conversion, in f32, the time axis split over
    `axis`.

    spec [B, T, n_freq], noise [B, T, inter] (whole, on any device; each
    position takes its frames): T must divide by the axis size, and T/n must
    be ≥ halo.  Returns audio [B, T·upsample, 1] `Sharded` along time on the
    same axis.  The weights are replicated once per device."""
    n = mesh.shape[axis]
    b, t = spec.shape[0], spec.shape[1]
    if t % n:
        raise ValueError(f"T={t} not divisible by {axis} axis size {n}")
    t_loc = t // n
    if halo is None:
        halo = required_halo(model.cfg)
    if t_loc < halo:
        raise ValueError(f"shard length {t_loc} < halo {halo}; use fewer shards")
    up = model.cfg.upsample_factor
    replicas = replicate(model, {mesh.devices[c] for c in mesh.local_coords()})
    table = comms(mesh, axis)

    def local(coord):
        dev, i = mesh.devices[coord], mesh.index(axis, coord)
        f32 = torch.float32
        frames = slice(i * t_loc, (i + 1) * t_loc)
        ext_spec = _halo_exchange(spec[:, frames].to(dev, f32), table[coord], halo)
        ext_noise = _halo_exchange(noise[:, frames].to(dev, f32), table[coord], halo)
        pos = i * t_loc - halo + torch.arange(t_loc + 2 * halo, device=dev)
        lengths = spec_lengths.to(dev)
        mask = ((pos[None, :] >= 0) & (pos[None, :] < lengths[:, None])).to(f32)[..., None]
        tau_d = tau.to(dev, f32) if torch.is_tensor(tau) else tau
        audio = voice_conversion_masked(replicas[dev], ext_spec, mask, g_src.to(dev, f32), g_tgt.to(dev, f32),
                                        tau_d, ext_noise)
        return audio[:, halo * up : (halo + t_loc) * up]

    with torch.no_grad():
        shards = spmd(mesh, local, uses=(table,))
    return Sharded(mesh, (None, axis, None), (b, t * up, 1), shards)
