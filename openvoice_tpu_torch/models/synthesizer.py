"""The converter branch of the VITS-style synthesizer: posterior encoder,
coupling flow, HiFi-GAN decoder and tone-colour reference encoder
(reference: models.py:399-499; JAX: ``openvoice_tpu/models/synthesizer.py``).

`Synthesizer` is an ``nn.Module`` whose ``state_dict()`` carries the
reference's key names.  The graph functions below keep the JAX package's
[B, T, C] layout at their arguments and results, and run the modules in
PyTorch's [B, C, T] layout inside.  This is the f32 parity mode; the bf16
serving mode needs the fused kernels of a later slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.models.align import sequence_mask
from openvoice_tpu_torch.nn.conv import conv1d
from openvoice_tpu_torch.nn.flows import ResidualCouplingBlock
from openvoice_tpu_torch.nn.hifigan import Generator
from openvoice_tpu_torch.nn.ref_encoder import GRU_HIDDEN, ReferenceEncoder
from openvoice_tpu_torch.nn.wavenet import WN


class PosteriorEncoder(nn.Module):
    """spec → z = (m + noise·tau·exp(logs))·mask (models.py:178-221);
    attributes ``pre``, ``enc``, ``proj``."""

    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        h = cfg.hidden_channels
        self.inter = cfg.inter_channels
        self.pre = conv1d(cfg.spec_channels, h)
        self.enc = WN(h, cfg.enc_q_kernel_size, cfg.enc_q_layers, cfg.gin_channels)
        self.proj = conv1d(h, 2 * cfg.inter_channels)

    def forward(self, spec: torch.Tensor, mask: torch.Tensor, g: torch.Tensor | None,
                tau: float, noise: torch.Tensor):
        """spec [B, n_freq, T], mask [B, 1, T], g [B, gin, 1], noise
        [B, inter, T] → z, m, logs, each [B, inter, T]."""
        x = self.pre(spec) * mask
        x = self.enc(x, mask, g)
        stats = self.proj(x) * mask
        m, logs = stats[:, : self.inter], stats[:, self.inter :]
        z = (m + noise * tau * torch.exp(logs)) * mask
        return z, m, logs


class Synthesizer(nn.Module):
    """The converter (n_speakers == 0): ``enc_q``, ``flow``, ``dec``,
    ``ref_enc``.  The text path of the base-speaker TTS is not ported yet."""

    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        if cfg.n_speakers != 0:
            raise NotImplementedError("the base-speaker TTS (n_speakers > 0) is not ported yet")
        self.cfg = cfg
        self.enc_q = PosteriorEncoder(cfg)
        self.flow = ResidualCouplingBlock(
            cfg.inter_channels, cfg.hidden_channels, cfg.flow_kernel_size,
            cfg.flow_wn_layers, cfg.flow_n_flows, cfg.gin_channels,
        )
        self.dec = Generator(cfg)
        self.ref_enc = ReferenceEncoder(cfg.spec_channels, cfg.gin_channels)


def init_synthesizer(cfg: SynthesizerConfig, generator: torch.Generator) -> Synthesizer:
    """Random weights on the CPU with the distributions of the JAX
    ``init_synthesizer`` (its models/synthesizer.py:40-87, :174-280):

    * convs and linears: weight and bias uniform in ±1/√fan_in;
    * decoder upsamples and resblock convs: weight normal(0, 0.01), bias 0
      (commons.init_weights);
    * each coupling's ``post``: zeros, so a fresh flow is the identity;
    * LayerNorm: ones and zeros; GRU: uniform in ±1/√hidden.

    The draws differ from JAX's (another generator); tests that compare the
    two packages send JAX's weights through ``ckpt/from_jax.py`` instead.
    """
    model = Synthesizer(cfg)
    posts = {id(flow.post) for flow in model.flow.flows[::2]}
    decoder = {id(m) for m in model.dec.ups.modules()} | {id(m) for m in model.dec.resblocks.modules()}
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.GRU):
                s = 1.0 / math.sqrt(GRU_HIDDEN)
                for p in module.parameters():
                    p.uniform_(-s, s, generator=generator)
            elif id(module) in posts:
                module.weight.zero_()
                module.bias.zero_()
            elif id(module) in decoder and isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
                module.weight.normal_(0.0, 0.01, generator=generator)
                module.bias.zero_()
            elif isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                s = 1.0 / math.sqrt(module.weight[0].numel())  # fan_in = C_in/groups · kernel
                module.weight.uniform_(-s, s, generator=generator)
                if module.bias is not None:
                    module.bias.uniform_(-s, s, generator=generator)
    return model


def _bct(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] ↔ [B, C, T]."""
    return x.transpose(1, 2)


def posterior_encode(model: Synthesizer, spec: torch.Tensor, spec_mask: torch.Tensor,
                     g: torch.Tensor | None, tau: float, noise: torch.Tensor):
    """spec [B, T, n_freq], spec_mask [B, T, 1], g [B, 1, gin], noise
    [B, T, inter] → z, m, logs, each [B, T, inter]."""
    g_t = _bct(g) if g is not None else None
    z, m, logs = model.enc_q(_bct(spec), _bct(spec_mask), g_t, tau, _bct(noise))
    return _bct(z), _bct(m), _bct(logs)


def extract_tone_color(model: Synthesizer, spec: torch.Tensor,
                       lengths: torch.Tensor | None = None) -> torch.Tensor:
    """spec [B, T, n_freq] (+ true frame counts [B]) → [B, gin] speaker
    embedding (the ref_enc path, api.py:131)."""
    return model.ref_enc(spec, lengths)


def voice_conversion(model: Synthesizer, spec: torch.Tensor, spec_lengths: torch.Tensor,
                     g_src: torch.Tensor, g_tgt: torch.Tensor, tau: float,
                     noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tone-colour conversion (models.py:492-499).

    spec [B, T, n_freq], spec_lengths [B], g_src/g_tgt [B, 1, gin], noise
    [B, T, inter] → (audio [B, T·upsample, 1], y_mask [B, T, 1]).
    """
    y_mask = sequence_mask(spec_lengths, spec.shape[1])[..., None].to(spec.dtype)
    audio = voice_conversion_masked(model, spec, y_mask, g_src, g_tgt, tau, noise)
    return audio, y_mask


def voice_conversion_masked(model: Synthesizer, spec: torch.Tensor, y_mask: torch.Tensor,
                            g_src: torch.Tensor, g_tgt: torch.Tensor, tau: float,
                            noise: torch.Tensor) -> torch.Tensor:
    """Conversion body with an explicit frame mask [B, T, 1] → audio
    [B, T·upsample, 1].

    zero_g follows the reference exactly: in V2 the posterior encoder and
    the decoder see zeroed speaker vectors, and the flow always sees the real
    src/tgt embeddings (models.py:495-498).
    """
    cfg = model.cfg
    g_src, g_tgt = _bct(g_src), _bct(g_tgt)
    g_enc = torch.zeros_like(g_src) if cfg.zero_g else g_src
    g_dec = torch.zeros_like(g_tgt) if cfg.zero_g else g_tgt
    mask = _bct(y_mask)
    z, _, _ = model.enc_q(_bct(spec), mask, g_enc, tau, _bct(noise))
    z_p = model.flow(z, mask, g=g_src, reverse=False)
    z_hat = model.flow(z_p, mask, g=g_tgt, reverse=True)
    audio = model.dec(z_hat * mask, g=g_dec, x_mask=mask)
    return _bct(audio)
