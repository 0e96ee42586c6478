"""The VITS-style synthesizer: posterior encoder, coupling flow and HiFi-GAN
decoder, with either the tone-colour reference encoder (the converter,
n_speakers == 0) or the text path of the base-speaker TTS (n_speakers > 0)
(reference: models.py:399-499; JAX: ``openvoice_tpu/models/synthesizer.py``).

`Synthesizer` is an ``nn.Module`` whose ``state_dict()`` carries the
reference's key names.  The graph functions below keep the JAX package's
[B, T, C] layout at their arguments and results, and run the modules in
PyTorch's [B, C, T] layout inside.  Two numeric modes share them: the f32
parity mode on stock layers, and the bf16 serving mode (``fast=True`` with a
`make_dec_cache`), where the posterior encoder's WaveNet, each direction of
the flow and every decoder stage run as one hand-written kernel each
(``ops/{wn,coupling,mrf,tail}_cuda.py``).  The TTS text encoder and duration
predictors stay f32 in both modes, as in the JAX package: only its decode
(reverse flow and decoder) runs in bf16.

A MeloTTS config (``cfg.is_melo``; melo/models.py SynthesizerTrn) adds tone
and language tables and BERT features to the text encoder, conditions it on
the speaker, and builds the flow of transformer couplings
(`nn.extras.TransformerCouplingBlock`), which the serving mode runs on stock
bf16 layers inside the decode graph, ahead of the decoder's kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.models.align import generate_path, sequence_mask
from openvoice_tpu_torch.nn.attention import Encoder, MultiHeadAttention
from openvoice_tpu_torch.nn.conv import conv1d
from openvoice_tpu_torch.nn.duration import (
    DurationPredictor, StochasticDurationPredictor, apply_duration_predictor, apply_sdp_reverse,
)
from openvoice_tpu_torch.nn.extras import TransformerCouplingBlock
from openvoice_tpu_torch.nn.flows import ConvFlow, ResidualCouplingBlock
from openvoice_tpu_torch.nn.hifigan import (
    Generator, apply_generator, cast_copy, pack_generator_caches,
)
from openvoice_tpu_torch.nn.ref_encoder import GRU_HIDDEN, ReferenceEncoder
from openvoice_tpu_torch.nn.wavenet import WN, apply_wn
from openvoice_tpu_torch.ops.coupling_cuda import (
    coupling_block, coupling_g_stack, pack_coupling_block,
)
from openvoice_tpu_torch.ops.wn_cuda import stack_wn_params
from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket


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


class TextEncoder(nn.Module):
    """Tokens → relative-attention encoder → (m_p, logs_p) (models.py:16-57);
    attributes ``emb``, ``encoder``, ``proj``.  MeloTTS's adds
    ``tone_emb``, ``language_emb``, ``bert_proj`` and ``ja_bert_proj`` (1×1
    convs of the BERT features) to the token embedding, and the encoder's
    ``spk_emb_linear`` (melo/models.py TextEncoder)."""

    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        h = cfg.hidden_channels
        self.hidden = h
        self.emb = nn.Embedding(cfg.n_vocab, h)
        if cfg.is_melo:
            self.tone_emb = nn.Embedding(cfg.num_tones, h)
            self.language_emb = nn.Embedding(cfg.num_languages, h)
            self.bert_proj = conv1d(cfg.bert_channels, h)
            self.ja_bert_proj = conv1d(cfg.ja_bert_channels, h)
        self.encoder = Encoder(h, cfg.filter_channels, cfg.n_heads, cfg.n_layers, cfg.kernel_size,
                               cfg.attn_window_size,
                               gin_channels=cfg.gin_channels if cfg.is_melo else 0)
        self.proj = conv1d(h, 2 * cfg.inter_channels)


class Synthesizer(nn.Module):
    """``enc_q``, ``flow``, ``dec``, and either ``ref_enc`` (the converter,
    n_speakers == 0) or the text path ``enc_p``, ``sdp``, ``dp``, ``emb_g``
    (the base-speaker TTS, n_speakers > 0), as the reference builds them
    (models.py:427-466)."""

    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        self.cfg = cfg
        self.enc_q = PosteriorEncoder(cfg)
        if cfg.is_melo:
            self.flow = TransformerCouplingBlock(
                cfg.inter_channels, cfg.hidden_channels, cfg.filter_channels, cfg.n_heads,
                cfg.n_layers_trans_flow, cfg.flow_kernel_size, cfg.flow_n_flows, cfg.gin_channels,
            )
        else:
            self.flow = ResidualCouplingBlock(
                cfg.inter_channels, cfg.hidden_channels, cfg.flow_kernel_size,
                cfg.flow_wn_layers, cfg.flow_n_flows, cfg.gin_channels,
            )
        self.dec = Generator(cfg)
        if cfg.n_speakers == 0:
            self.ref_enc = ReferenceEncoder(cfg.spec_channels, cfg.gin_channels)
        else:
            self.enc_p = TextEncoder(cfg)
            self.sdp = StochasticDurationPredictor(cfg.hidden_channels, cfg.sdp_kernel_size,
                                                   gin_channels=cfg.gin_channels)
            self.dp = DurationPredictor(cfg.hidden_channels, cfg.dp_filter_channels, cfg.dp_kernel_size,
                                        cfg.gin_channels)
            self.emb_g = nn.Embedding(cfg.n_speakers, cfg.gin_channels)


def init_synthesizer(cfg: SynthesizerConfig, generator: torch.Generator) -> Synthesizer:
    """Random weights on the CPU with the distributions of the JAX
    ``init_synthesizer`` (its models/synthesizer.py:40-87, :174-280):

    * convs and linears: weight and bias uniform in ±1/√fan_in;
    * decoder upsamples and resblock convs: weight normal(0, 0.01), bias 0
      (commons.init_weights);
    * each coupling's ``post`` and each spline flow's ``proj``: zeros, so a
      fresh flow is the identity;
    * LayerNorm: ones and zeros; GRU: uniform in ±1/√hidden;
    * text path: token embedding normal(0, 1/√hidden), relative-position
      embeddings normal(0, 1/√dk), speaker table normal(0, 1).

    The draws differ from JAX's (another generator); tests that compare the
    two packages send JAX's weights through ``ckpt/from_jax.py`` instead.
    """
    model = Synthesizer(cfg)
    posts = {id(flow.post) for flow in model.flow.flows[::2]}
    posts |= {id(m.proj) for m in model.modules() if isinstance(m, ConvFlow)}
    decoder = {id(m) for m in model.dec.ups.modules()} | {id(m) for m in model.dec.resblocks.modules()}
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                std = 1.0 if module is getattr(model, "emb_g", None) else cfg.hidden_channels ** -0.5
                module.weight.normal_(0.0, std, generator=generator)
            elif isinstance(module, MultiHeadAttention):
                for p in (module.emb_rel_k, module.emb_rel_v):
                    p.normal_(0.0, module.k_channels ** -0.5, generator=generator)
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
      stay outside the kernels (pre, proj and the conditioning 1×1 convs);
    * for a transformer-coupling flow (MeloTTS) instead of ``coupling`` and
      ``flow_cond``: ``flow``, a copy of the block in `dtype`.

    Pass it as ``dec_cache``.  Build it again when the weights change."""
    def cast(module):
        return cast_copy(module, dtype)

    cache = pack_generator_caches(model.dec, dtype)
    cache["dtype"] = dtype
    cache["wn"] = {"enc_q": stack_wn_params(model.enc_q.enc, dtype)}
    cache["enc_q"] = {"pre": cast(model.enc_q.pre), "proj": cast(model.enc_q.proj),
                      "cond": cast(model.enc_q.enc.cond_layer)}
    if isinstance(model.flow, TransformerCouplingBlock):
        # no kernel takes a transformer coupling: a copy in `dtype` of the
        # whole block, which the TTS decode runs on stock layers
        cache["flow"] = cast(model.flow)
        return cache
    cache["coupling"] = {
        "fwd": pack_coupling_block(model.flow, reverse=False, dtype=dtype),
        "rev": pack_coupling_block(model.flow, reverse=True, dtype=dtype),
    }
    cache["flow_cond"] = [cast(flow.enc.cond_layer) for flow in model.flow.flows[::2]]
    return cache


def voice_conversion(model: Synthesizer, spec: torch.Tensor, spec_lengths: torch.Tensor,
                     g_src: torch.Tensor, g_tgt: torch.Tensor, tau: float,
                     noise: torch.Tensor, fast: bool = False,
                     dec_cache: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Tone-colour conversion (models.py:492-499).

    spec [B, T, n_freq], spec_lengths [B], g_src/g_tgt [B, 1, gin], tau a
    float or one per row [B, 1, 1], noise [B, T, inter] → (audio
    [B, T·upsample, 1] float32, y_mask [B, T, 1]).

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
    if "coupling" not in cache:
        raise ValueError("the conversion's kernel route needs a WaveNet coupling flow")
    g_enc = torch.zeros_like(g_src) if cfg.zero_g else g_src
    tau_t = torch.as_tensor(tau, dtype=spec.dtype, device=spec.device)  # a float, or [B, 1, 1]
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


# ---------------------------------------------------------------------------
# Base-speaker TTS (models.py:467-490)
# ---------------------------------------------------------------------------

class TTSEncodeOut(NamedTuple):
    """What the text side of TTS hands the decode (the JAX package's)."""

    m_p: torch.Tensor     # [B, T_x, inter]
    logs_p: torch.Tensor  # [B, T_x, inter]
    x_mask: torch.Tensor  # [B, T_x, 1]
    w_ceil: torch.Tensor  # [B, T_x] integral durations (float)
    g: torch.Tensor | None  # [B, 1, gin]


def text_encode(model: Synthesizer, tokens: torch.Tensor, token_lengths: torch.Tensor,
                tones: torch.Tensor | None = None, languages: torch.Tensor | None = None,
                ja_bert: torch.Tensor | None = None, g: torch.Tensor | None = None):
    """tokens [B, T_x] int, token_lengths [B] → (h [B, T_x, hidden], m_p,
    logs_p [B, T_x, inter], x_mask [B, T_x, 1]), all float32.

    MeloTTS's encoder (``cfg.is_melo``) also takes tones and languages
    [B, T_x] int, ja_bert [B, T_x, ja_bert_channels] (each phone's BERT
    feature) and g [B, 1, gin], the speaker it is conditioned on; its
    ``bert`` input is zeros for English, so ``bert_proj`` gives its bias
    alone, which is what the 1×1 conv of zeros gives."""
    enc = model.enc_p
    x_mask = sequence_mask(token_lengths, tokens.shape[1])[..., None].float()
    h = enc.emb(tokens.long())
    if model.cfg.is_melo:
        h = (h + enc.tone_emb(tones.long()) + enc.language_emb(languages.long()) + enc.bert_proj.bias
             + _bct(enc.ja_bert_proj(_bct(ja_bert))))
    h = h * math.sqrt(enc.hidden)
    g_enc = _bct(g) if g is not None and model.cfg.is_melo else None
    h = enc.encoder(_bct(h * x_mask), _bct(x_mask), g_enc)
    stats = _bct(enc.proj(h)) * x_mask
    inter = model.cfg.inter_channels
    return _bct(h), stats[..., :inter], stats[..., inter:], x_mask


def log_durations(model: Synthesizer, h: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None,
                  noise_w: torch.Tensor, noise_scale_w: float = 0.6, sdp_ratio: float = 0.2) -> torch.Tensor:
    """The duration predictors' blend → logw [B, T_x, 1]: the stochastic one
    on noise_w [B, T_x, 2], weighted sdp_ratio, and the deterministic one."""
    logw_sdp = apply_sdp_reverse(model.sdp, h, x_mask, noise_w, g=g, noise_scale=noise_scale_w)
    logw_dp = apply_duration_predictor(model.dp, h, x_mask, g=g)
    return logw_sdp * sdp_ratio + logw_dp * (1.0 - sdp_ratio)


def tts_encode(model: Synthesizer, tokens: torch.Tensor, token_lengths: torch.Tensor,
               sid: torch.Tensor | None, noise_w: torch.Tensor, noise_scale_w: float = 0.6,
               length_scale: float = 1.0, sdp_ratio: float = 0.2, tones: torch.Tensor | None = None,
               languages: torch.Tensor | None = None, ja_bert: torch.Tensor | None = None) -> TTSEncodeOut:
    """Text encoder and duration predictors → integral durations (the first
    half of models.py:467-482), f32 in both modes.

    tokens [B, T_x] int, noise_w [B, T_x, 2] standard normal (the JAX
    package's ``noise_w``; the caller draws it so that a seed gives the same
    draws in both packages); tones, languages and ja_bert as `text_encode`
    takes them (MeloTTS)."""
    g = model.emb_g(sid.long())[:, None, :] if sid is not None else None  # [B, 1, gin]
    h, m_p, logs_p, x_mask = text_encode(model, tokens, token_lengths, tones, languages, ja_bert, g)
    logw = log_durations(model, h, x_mask, g, noise_w, noise_scale_w, sdp_ratio)
    w = torch.exp(logw) * x_mask * length_scale
    return TTSEncodeOut(m_p=m_p, logs_p=logs_p, x_mask=x_mask, w_ceil=torch.ceil(w)[..., 0], g=g)


def tts_latents(model: Synthesizer, enc: TTSEncodeOut, max_frames: int, noise: torch.Tensor,
                noise_scale: float = 0.667, fast: bool = False, dec_cache: dict | None = None):
    """Length-regulate and run the flow in reverse (models.py:479-488) →
    (z [B, max_frames, inter], y_mask [B, max_frames, 1] float32, y_lengths
    [B] int32, g), z and g in the route's dtype: float32 on stock layers
    without a cache, else the cache's dtype through the K2 route (bf16 for
    fast=True), or a transformer-coupling flow's stock layers in it."""
    if fast and dec_cache is None:
        raise ValueError("fast=True needs dec_cache=make_dec_cache(model)")
    y_lengths = torch.clamp(enc.w_ceil.sum(dim=-1), 1, max_frames).to(torch.int32)
    y_mask = sequence_mask(y_lengths, max_frames)[..., None].to(enc.m_p.dtype)
    attn = generate_path(enc.w_ceil, y_mask * enc.x_mask.transpose(1, 2))  # [B, T_y, T_x]
    z_p = attn @ enc.m_p + noise * torch.exp(attn @ enc.logs_p) * noise_scale
    g = enc.g
    if dec_cache is None:
        z = model.flow(_bct(z_p), _bct(y_mask), g=_bct(g) if g is not None else None, reverse=True)
        return _bct(z), y_mask, y_lengths, g
    dt = torch.bfloat16 if fast else z_p.dtype
    if dec_cache["dtype"] != dt:
        raise TypeError(f"dec_cache holds {dec_cache['dtype']}, this call runs in {dt}")
    if "flow" in dec_cache:  # a transformer-coupling flow, on stock layers in the cache's dtype
        g = g.to(dt) if g is not None else None
        z = dec_cache["flow"](_bct(z_p.to(dt)), _bct(y_mask.to(dt)), g=_bct(g) if g is not None else None,
                              reverse=True)
        return _bct(z), y_mask, y_lengths, g
    z_p = (z_p * y_mask).to(dt).contiguous()
    rev = dec_cache["coupling"]["rev"]
    if g is not None:
        g = g.to(dt)
        g_rev = coupling_g_stack(model.flow, g, reverse=True, convs=dec_cache["flow_cond"])
    else:  # no conditioning at all: the WaveNets add nothing
        g_rev = z_p.new_zeros(z_p.shape[0], *rev["b_in"].shape)
    return coupling_block(z_p, y_lengths, rev, g_rev), y_mask, y_lengths, g


def tts_decode(model: Synthesizer, enc: TTSEncodeOut, max_frames: int, noise: torch.Tensor,
               noise_scale: float = 0.667, fast: bool = False,
               dec_cache: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Length-regulate, reverse flow and decode, padded to `max_frames` (the
    second half of models.py:479-490).

    noise [B, max_frames, inter] standard normal → (audio [B, max_frames·
    upsample, 1] float32, y_mask [B, max_frames, 1] float32).  fast=True is
    the serving mode: the reverse flow (K2) and the decoder (K3, K4) run in
    bf16 from ``dec_cache = make_dec_cache(model)``; fast=False is the f32
    parity mode.  As in `voice_conversion_masked`, a float32 cache sends the
    f32 graph down the kernel route's plain versions.  y_mask stays float32:
    callers sum it into lengths, and bf16 counts are wrong past 256."""
    z, y_mask, _, g = tts_latents(model, enc, max_frames, noise, noise_scale, fast, dec_cache)
    if dec_cache is None:
        mask = _bct(y_mask)
        audio = model.dec(_bct(z) * mask, g=_bct(g) if g is not None else None, x_mask=mask)
        return _bct(audio), y_mask
    m = y_mask.to(z.dtype)
    return apply_generator(model.dec, z * m, g=g, x_mask=m, packed=dec_cache).float(), y_mask


def tts_decode_convert(model: Synthesizer, enc: TTSEncodeOut, max_frames: int, noise_dec: torch.Tensor,
                       conv_model: Synthesizer, g_src: torch.Tensor, g_tgt: torch.Tensor, tau,
                       noise_conv: torch.Tensor, noise_scale: float = 0.667, fast: bool = False,
                       tts_dec_cache: dict | None = None,
                       conv_dec_cache: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """TTS decode → STFT → tone conversion with the base audio kept on the
    device (the served TTS-then-convert chain, reference
    openvoice_app.py:131-141; the JAX package's ``tts_decode_convert``).

    Each row's true length (y_frames · upsample) drives a per-row reflect
    STFT (`audio.stft.masked_linear_spectrogram`, the STFT kernel on the
    card) whose framing matches the host `convert()` path; this needs
    ``cfg.upsample_factor == conv_cfg.hop_length`` so that base frames map
    1:1 to conversion frames (true for the shipped config pair).  Nothing is
    read back to the host: the lengths stay on the device.

    noise_dec [B, max_frames, inter] and noise_conv [B, max_frames,
    conv inter] standard normal → (converted audio [B, max_frames·up, 1]
    float32, y_mask [B, max_frames, 1] float32)."""
    from openvoice_tpu_torch.audio.stft import masked_linear_spectrogram

    cfg, conv_cfg = model.cfg, conv_model.cfg
    if cfg.upsample_factor != conv_cfg.hop_length:
        raise ValueError("fused tts→convert needs TTS upsample == converter hop "
                         f"({cfg.upsample_factor} vs {conv_cfg.hop_length})")
    audio, y_mask = tts_decode(model, enc, max_frames, noise_dec, noise_scale=noise_scale, fast=fast,
                               dec_cache=tts_dec_cache)
    y_frames = y_mask[..., 0].sum(dim=-1).to(torch.int32)
    spec = masked_linear_spectrogram(audio[..., 0], y_frames * cfg.upsample_factor, conv_cfg.filter_length,
                                     conv_cfg.hop_length, conv_cfg.win_length)  # [B, max_frames, n_freq]
    conv_audio, _ = voice_conversion(conv_model, spec, y_frames, g_src, g_tgt, tau, noise_conv, fast=fast,
                                     dec_cache=conv_dec_cache)
    return conv_audio, y_mask


def tts_synthesize_convert(model: Synthesizer, tokens: torch.Tensor, token_lengths: torch.Tensor,
                           sid: torch.Tensor, noise_w: torch.Tensor, max_frames: int, noise_dec: torch.Tensor,
                           conv_model: Synthesizer, g_src: torch.Tensor, g_tgt: torch.Tensor, tau,
                           noise_conv: torch.Tensor, noise_scale: float = 0.667, noise_scale_w: float = 0.6,
                           length_scale: float = 1.0, sdp_ratio: float = 0.2, fast: bool = False,
                           tts_dec_cache: dict | None = None, conv_dec_cache: dict | None = None):
    """Text → cloned audio with no host round trip: encode, durations,
    decode, STFT and conversion, the output length capped at `max_frames`
    (the reference's own ``max_len`` truncation, models.py:467,489; the JAX
    package's ``tts_synthesize_convert``).

    Returns (conv_audio [B, max_frames·up, 1], y_frames [B] int32 decoded
    frames, total [B] int32 uncapped duration sums): rows with total >
    max_frames were truncated, and the caller re-runs them through the
    two-stage path."""
    enc = tts_encode(model, tokens, token_lengths, sid, noise_w, noise_scale_w=noise_scale_w,
                     length_scale=length_scale, sdp_ratio=sdp_ratio)
    total = enc.w_ceil.sum(dim=-1).to(torch.int32)  # [B] uncapped
    audio, y_mask = tts_decode_convert(model, enc, max_frames, noise_dec, conv_model, g_src, g_tgt, tau,
                                       noise_conv, noise_scale=noise_scale, fast=fast,
                                       tts_dec_cache=tts_dec_cache, conv_dec_cache=conv_dec_cache)
    return audio, y_mask[..., 0].sum(dim=-1).to(torch.int32), total


def infer(model: Synthesizer, tokens: torch.Tensor, token_lengths: torch.Tensor,
          sid: torch.Tensor | None, seed: int, noise_scale: float = 0.667, length_scale: float = 1.0,
          noise_scale_w: float = 0.6, sdp_ratio: float = 0.2,
          max_frames: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Two-stage TTS with a host round trip for the output length (the split
    at models.py:479): → (audio [B, max_frames·upsample] numpy, true sample
    counts [B]).  Both noises come from numpy generators spawned from `seed`
    (the JAX ``infer`` draws its duration noise with ``jax.random`` instead,
    so the two agree given the same noise arrays, not the same seed)."""
    rng_w, rng_y = (np.random.default_rng(ss) for ss in np.random.SeedSequence(seed).spawn(2))
    dev = tokens.device
    noise_w = rng_w.standard_normal((tokens.shape[0], tokens.shape[1], 2)).astype(np.float32)
    enc = tts_encode(model, tokens, token_lengths, sid, torch.from_numpy(noise_w).to(dev),
                     noise_scale_w=noise_scale_w, length_scale=length_scale, sdp_ratio=sdp_ratio)
    if max_frames is None:
        max_frames = round_up_to_bucket(max(int(enc.w_ceil.sum(dim=-1).max()), 1))
    noise = rng_y.standard_normal((tokens.shape[0], max_frames, model.cfg.inter_channels)).astype(np.float32)
    audio, y_mask = tts_decode(model, enc, max_frames, torch.from_numpy(noise).to(dev), noise_scale=noise_scale)
    y_lengths = y_mask[..., 0].sum(dim=-1).to(torch.int64).cpu().numpy()
    return audio[..., 0].cpu().numpy(), y_lengths * model.cfg.upsample_factor
