"""The converter branch of the VITS-style synthesizer: posterior encoder,
coupling flow, HiFi-GAN decoder and tone-colour reference encoder
(reference: models.py:399-499; JAX: ``openvoice_tpu/models/synthesizer.py``).

`Synthesizer` is an ``nn.Module`` whose ``state_dict()`` carries the
reference's key names.  The graph functions below keep the JAX package's
[B, T, C] layout at their arguments and results, and run the modules in
PyTorch's [B, C, T] layout inside.  Two numeric modes share them: the f32
parity mode on stock layers, and the bf16 serving mode (``fast=True`` with a
`make_dec_cache`), where the posterior encoder's WaveNet, both directions of
the flow and every decoder stage each run as one hand-written kernel
(``ops/{wn,coupling,mrf,tail}_cuda.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.models.align import sequence_mask
from openvoice_tpu_torch.nn.conv import conv1d
from openvoice_tpu_torch.nn.flows import ResidualCouplingBlock
from openvoice_tpu_torch.nn.hifigan import (
    Generator, apply_generator, cast_copy, pack_generator_caches,
)
from openvoice_tpu_torch.nn.ref_encoder import GRU_HIDDEN, ReferenceEncoder
from openvoice_tpu_torch.nn.wavenet import WN, apply_wn
from openvoice_tpu_torch.ops.coupling_cuda import (
    coupling_block, coupling_g_stack, pack_coupling_block,
)
from openvoice_tpu_torch.ops.wn_cuda import stack_wn_params


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


def make_dec_cache(model: Synthesizer, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack, once, everything the kernel route of `voice_conversion` reads
    (the JAX package's ``make_dec_cache``), on the model's device:

    * the decoder's stages and the stock layers around them
      (`nn.hifigan.pack_generator_caches`: keys ``mrf{i}``, ``upmrf{i}``,
      ``tail``, ``stock``);
    * ``wn``: the posterior encoder's WaveNet stack;
    * ``coupling``: both directions of the flow, flips folded in;
    * ``enc_q`` / ``flow_cond``: copies in `dtype` of the stock layers that
      stay outside the kernels (pre, proj and the conditioning 1×1 convs).

    Pass it as ``dec_cache``.  Build it again when the weights change."""
    def cast(module):
        return cast_copy(module, dtype)

    cache = pack_generator_caches(model.dec, dtype)
    cache["dtype"] = dtype
    cache["wn"] = {"enc_q": stack_wn_params(model.enc_q.enc, dtype)}
    cache["coupling"] = {
        "fwd": pack_coupling_block(model.flow, reverse=False, dtype=dtype),
        "rev": pack_coupling_block(model.flow, reverse=True, dtype=dtype),
    }
    cache["enc_q"] = {"pre": cast(model.enc_q.pre), "proj": cast(model.enc_q.proj),
                      "cond": cast(model.enc_q.enc.cond_layer)}
    cache["flow_cond"] = [cast(flow.enc.cond_layer) for flow in model.flow.flows[::2]]
    return cache


def voice_conversion(model: Synthesizer, spec: torch.Tensor, spec_lengths: torch.Tensor,
                     g_src: torch.Tensor, g_tgt: torch.Tensor, tau: float,
                     noise: torch.Tensor, fast: bool = False,
                     dec_cache: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Tone-colour conversion (models.py:492-499).

    spec [B, T, n_freq], spec_lengths [B], g_src/g_tgt [B, 1, gin], noise
    [B, T, inter] → (audio [B, T·upsample, 1] float32, y_mask [B, T, 1]).

    fast=True is the serving mode: everything after the STFT runs in bf16,
    through the kernels, from ``dec_cache = make_dec_cache(model)``.
    fast=False is the f32 parity mode.
    """
    y_mask = sequence_mask(spec_lengths, spec.shape[1])[..., None].to(spec.dtype)
    audio = voice_conversion_masked(model, spec, y_mask, g_src, g_tgt, tau, noise,
                                    fast=fast, dec_cache=dec_cache)
    return audio, y_mask


def voice_conversion_masked(model: Synthesizer, spec: torch.Tensor, y_mask: torch.Tensor,
                            g_src: torch.Tensor, g_tgt: torch.Tensor, tau: float,
                            noise: torch.Tensor, fast: bool = False,
                            dec_cache: dict | None = None) -> torch.Tensor:
    """Conversion body with an explicit frame mask [B, T, 1] → audio
    [B, T·upsample, 1] float32.

    zero_g follows the reference exactly: in V2 the posterior encoder and
    the decoder see zeroed speaker vectors, and the flow always sees the real
    src/tgt embeddings (models.py:495-498).

    With a `dec_cache` the graph takes the kernel route in the cache's dtype:
    bf16 for fast=True, and float32 (a cache packed with dtype=float32, which
    only the plain versions on the CPU accept) to check the route's algebra
    exactly.
    """
    cfg = model.cfg
    if fast and dec_cache is None:
        raise ValueError("fast=True needs dec_cache=make_dec_cache(model)")
    if dec_cache is not None:
        dt = torch.bfloat16 if fast else spec.dtype
        if dec_cache["dtype"] != dt:
            raise TypeError(f"dec_cache holds {dec_cache['dtype']}, this call runs in {dt}")
        return _voice_conversion_packed(model, dec_cache, spec.to(dt), y_mask.to(dt), g_src.to(dt),
                                        g_tgt.to(dt), tau, noise.to(dt))
    g_src, g_tgt = _bct(g_src), _bct(g_tgt)
    g_enc = torch.zeros_like(g_src) if cfg.zero_g else g_src
    g_dec = torch.zeros_like(g_tgt) if cfg.zero_g else g_tgt
    mask = _bct(y_mask)
    z, _, _ = model.enc_q(_bct(spec), mask, g_enc, tau, _bct(noise))
    z_p = model.flow(z, mask, g=g_src, reverse=False)
    z_hat = model.flow(z_p, mask, g=g_tgt, reverse=True)
    audio = model.dec(z_hat * mask, g=g_dec, x_mask=mask)
    return _bct(audio)


def _voice_conversion_packed(model: Synthesizer, cache: dict, spec: torch.Tensor,
                             y_mask: torch.Tensor, g_src: torch.Tensor, g_tgt: torch.Tensor,
                             tau: float, noise: torch.Tensor) -> torch.Tensor:
    """The kernel route, everything in the cache's dtype and the JAX layout:
    the latents (`_latents_packed`), then the decoder."""
    z_hat = _latents_packed(model, cache, spec, y_mask, g_src, g_tgt, tau, noise)
    g_dec = torch.zeros_like(g_tgt) if model.cfg.zero_g else g_tgt
    audio = apply_generator(model.dec, z_hat * y_mask, g=g_dec, x_mask=y_mask, packed=cache)
    return audio.float()


def _latents_packed(model: Synthesizer, cache: dict, spec: torch.Tensor, y_mask: torch.Tensor,
                    g_src: torch.Tensor, g_tgt: torch.Tensor, tau: float,
                    noise: torch.Tensor) -> torch.Tensor:
    """The kernel route up to the decoder's input z_hat [B, T, inter]:
    posterior encoder (stock pre → WaveNet kernel → stock proj), then the flow
    forward with g_src and back with g_tgt (one kernel each)."""
    cfg = model.cfg
    g_enc = torch.zeros_like(g_src) if cfg.zero_g else g_src
    tau_t = torch.tensor(tau, dtype=spec.dtype, device=spec.device)
    lengths = (y_mask[:, :, 0] != 0).sum(dim=1, dtype=torch.int32)
    enc = cache["enc_q"]

    x = _bct(enc["pre"](_bct(spec))) * y_mask
    x = apply_wn(model.enc_q.enc, x, y_mask, g=g_enc, stacked=cache["wn"]["enc_q"], cond=enc["cond"])
    stats = _bct(enc["proj"](_bct(x))) * y_mask
    m, logs = stats[..., : cfg.inter_channels], stats[..., cfg.inter_channels :]
    z = ((m + noise * tau_t * torch.exp(logs)) * y_mask).contiguous()

    g_fwd = coupling_g_stack(model.flow, g_src, reverse=False, convs=cache["flow_cond"])
    g_rev = coupling_g_stack(model.flow, g_tgt, reverse=True, convs=cache["flow_cond"])
    z_p = coupling_block(z, lengths, cache["coupling"]["fwd"], g_fwd)
    return coupling_block(z_p, lengths, cache["coupling"]["rev"], g_rev)
