"""Blockwise streaming conversion: constant device memory for audio of any
length (the port of ``openvoice_tpu/runtime/streaming.py``).

One-shot conversion holds the whole utterance's activations on the device,
O(T·upsample) samples inside the decoder.  Every stage of the convert graph
is a finite-receptive-field conv stack, so a chunk extended by
``halo ≥ required_halo(cfg)`` frames on each side converts exactly as the
whole utterance would: interior chunks see the same neighbour frames, edge
chunks the same zero padding, and each window's mask comes from global frame
positions.  The noise is sliced from one full-length array at the same
global positions, so the stochastic path is the same too.

Window starts are clamped to frame 0, so that every window's mask is a
prefix mask: the serving kernels rebuild their masks as ``pos < sum(mask)``
and cannot represent an invalid left margin.  A clamped window emits from
``offset = ci·chunk − start``.  Every window has one shape,
[B, halo + chunk + halo], so the device memory of a call does not grow with
the utterance; on the card with a `GraphCache` every window after the first
replays one CUDA graph (the JAX package compiles ``_run_chunk`` once).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from openvoice_tpu_torch.models.synthesizer import Synthesizer, voice_conversion_masked
from openvoice_tpu_torch.runtime.graphs import GraphCache, GraphKey
from openvoice_tpu_torch.runtime.profiler import trace
from openvoice_tpu_torch.runtime.sequence_parallel import required_halo


def chunk_body(model: Synthesizer, fast: bool, dec_cache: dict | None, spec: torch.Tensor,
               mask: torch.Tensor, g_src: torch.Tensor, g_tgt: torch.Tensor, tau: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
    """One window's conversion (the JAX package's ``_run_chunk``): spec
    [B, W, n_freq], its prefix mask [B, W, 1], tau [B, 1, 1] → audio
    [B, W·upsample, 1]."""
    return voice_conversion_masked(model, spec, mask, g_src, g_tgt, tau, noise, fast=fast, dec_cache=dec_cache)


@torch.inference_mode()
def voice_conversion_streaming(model: Synthesizer, spec, spec_lengths, g_src, g_tgt, tau: float, noise, *,
                               chunk_frames: int = 896, halo: int | None = None, fast: bool = False,
                               dec_cache: dict | None = None, graphs: GraphCache | None = None) -> np.ndarray:
    """Convert an arbitrarily long spectrogram in fixed-size chunks on the
    model's device.

    spec [B, T, n_freq], spec_lengths [B], noise [B, T, inter] (host arrays:
    the same standard-normal noise the one-shot path would use), g_src /
    g_tgt [B, 1, gin] → numpy audio [B, T·upsample, 1], equal to
    `voice_conversion` up to float round-off (in serving mode, up to bf16
    rounding: the kernels' tiles fall at other offsets in a window).

    `graphs` (the caller's, on the model's device): each window runs
    through it, as a replay of one graph per (batch, window, fast) on the
    card; without, each window runs eagerly."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    spec = np.asarray(spec, np.float32)
    noise = np.asarray(noise, np.float32)
    lengths = np.asarray(spec_lengths, np.int64)
    b, t, n_freq = spec.shape
    if halo is None:
        halo = required_halo(cfg)
    up = cfg.upsample_factor
    ext = chunk_frames + 2 * halo
    graphs = GraphCache(dev, enabled=False) if graphs is None else graphs
    key = GraphKey("stream_chunk", bucket=ext, batch=b, fast=fast, chunk_frames=chunk_frames)
    body = partial(chunk_body, model, fast, dec_cache)
    g_src = torch.as_tensor(g_src, dtype=torch.float32, device=dev)
    g_tgt = torch.as_tensor(g_tgt, dtype=torch.float32, device=dev)
    taus = np.full((b, 1, 1), tau, np.float32)

    pieces = []
    for ci in range(-(-t // chunk_frames)):
        start = max(ci * chunk_frames - halo, 0)
        offset = ci * chunk_frames - start  # ≤ halo; < halo only where clamped
        window = np.zeros((b, ext, n_freq), np.float32)
        nwin = np.zeros((b, ext, noise.shape[-1]), np.float32)
        hi = min(start + ext, t)
        window[:, : hi - start] = spec[:, start:hi]
        nwin[:, : hi - start] = noise[:, start:hi]
        mask = (start + np.arange(ext))[None, :] < lengths[:, None]  # always a prefix mask
        inputs = {"spec": window, "mask": mask.astype(np.float32)[..., None], "g_src": g_src, "g_tgt": g_tgt,
                  "tau": taus, "noise": nwin}

        def emitted(audio, offset=offset):  # a view of the window's output, copied out at once
            with trace("ov.readback"):
                return audio[:, offset * up:(offset + chunk_frames) * up, 0].to("cpu", copy=True).numpy()

        pieces.append(graphs.run(key, body, inputs, consume=emitted))
    return np.concatenate(pieces, axis=1)[:, : t * up, None]
