"""The plain f32 reference of the benchmark's two configurations: OpenVoice's
tone-colour converter (V2, and V1 with its speaker-conditioned decoder) and
its V1 base-speaker TTS (reference repository: openvoice/models.py:399-499,
api.py:42-201, mel_processing.py:40-75).

Everything runs one request at a time at its true length, with no bucket,
no batch and no mask: the program's padding, batching and masks are
checked against the unpadded computation.  Convolutions and matrix products
run in float32 with TF32 off (`precision`).  Departures from the reference
repository: the spectrogram is ``torch.stft`` (its own is too, through
``spectrogram_torch``); the speaker embeddings are inputs (the cells draw
them from the seed), so the reference encoder holds its parameters and is
never run.

`stored("bf16")` gives the reference's twin in the program's serving
precision; `precision("tf32")` and `stored("fp8")` give the control of the
benchmark's comparison: the same computation in the precision below the one
a cell states (TF32 products for float32, fp8 storage for bfloat16).
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ovbench.reference.layers import (
    DurationPredictor, Encoder, Generator, ResidualCouplingBlock, StochasticDurationPredictor, WN, conv1d,
    generate_path,
)


@dataclasses.dataclass(frozen=True)
class Config:
    """The widths of one synthesizer, as a configuration file states them."""

    n_vocab: int = 0
    spec_channels: int = 513
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    n_speakers: int = 0
    gin_channels: int = 256
    zero_g: bool = False
    enc_q_kernel_size: int = 5
    enc_q_layers: int = 16
    flow_kernel_size: int = 5
    flow_wn_layers: int = 4
    flow_n_flows: int = 4
    sdp_kernel_size: int = 3
    dp_filter_channels: int = 256
    dp_kernel_size: int = 3
    attn_window_size: int = 4
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    add_blank: bool = True

    @staticmethod
    def from_dict(d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(Config)}
        kw = {k: v for k, v in d.items() if k in known}
        for k in ("resblock_kernel_sizes", "upsample_rates", "upsample_kernel_sizes"):
            if k in kw:
                kw[k] = tuple(kw[k])
        if "resblock_dilation_sizes" in kw:
            kw["resblock_dilation_sizes"] = tuple(tuple(x) for x in kw["resblock_dilation_sizes"])
        return Config(**kw)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_rates)


class PosteriorEncoder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.pre = conv1d(cfg.spec_channels, cfg.hidden_channels)
        self.enc = WN(cfg.hidden_channels, cfg.enc_q_kernel_size, cfg.enc_q_layers, cfg.gin_channels)
        self.proj = conv1d(cfg.hidden_channels, 2 * cfg.inter_channels)


class TextEncoder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.emb = nn.Embedding(cfg.n_vocab, cfg.hidden_channels)
        self.encoder = Encoder(cfg.hidden_channels, cfg.filter_channels, cfg.n_heads, cfg.n_layers,
                               cfg.kernel_size, cfg.attn_window_size)
        self.proj = conv1d(cfg.hidden_channels, 2 * cfg.inter_channels)


class ReferenceEncoder(nn.Module):
    """The tone-colour encoder's parameters (models.py:301-364): held so
    that the state dict is the checkpoint's; not run (see the module's
    docstring)."""

    def __init__(self, spec_channels: int, gin_channels: int):
        super().__init__()
        filters = (1, 32, 32, 64, 64, 128, 128)
        freq = spec_channels
        for _ in range(len(filters) - 1):
            freq = (freq - 1) // 2 + 1
        self.layernorm = nn.LayerNorm(spec_channels)
        self.convs = nn.ModuleList(nn.Conv2d(filters[i], filters[i + 1], 3, 2, 1) for i in range(len(filters) - 1))
        self.gru = nn.GRU(filters[-1] * freq, 128, batch_first=True)
        self.proj = nn.Linear(128, gin_channels)


class Synthesizer(nn.Module):
    """``enc_q``, ``flow``, ``dec``, and ``ref_enc`` (a converter) or the
    text path ``enc_p``, ``sdp``, ``dp``, ``emb_g`` (a TTS), under the
    checkpoints' key names."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.enc_q = PosteriorEncoder(cfg)
        self.flow = ResidualCouplingBlock(cfg.inter_channels, cfg.hidden_channels, cfg.flow_kernel_size,
                                          cfg.flow_wn_layers, cfg.flow_n_flows, cfg.gin_channels)
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


# -- precision ---------------------------------------------------------------------

@contextmanager
def precision(kind: str = "f32"):
    """Within: float32 products with TF32 off (``"f32"``, the reference),
    or on (``"tf32"``, the control of a float32 cell)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = kind == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale a tensor (its largest magnitude
    to e4m3's largest, 448), back in x's dtype."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype)) / scale


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x through bfloat16, back in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


ROUNDING = {"bf16": bf16_round, "fp8": fp8_round}


class _Stored(torch.overrides.TorchFunctionMode):
    """Every floating result of an operation rounded through a narrower
    type, views and copies of layout excepted: each intermediate is stored
    in that type, while each operation computes in float32."""

    LAYOUT = {"__getitem__", "transpose", "t", "reshape", "view", "permute", "flip", "contiguous", "unsqueeze",
              "squeeze", "expand", "split", "chunk", "narrow", "clone", "to", "float", "detach", "size", "dim",
              "numel", "__len__", "__iter__", "unbind", "select", "cpu", "numpy", "item", "tolist"}

    def __init__(self, rounding):
        super().__init__()
        self.rounding = rounding

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.is_floating_point() and getattr(func, "__name__", "") not in self.LAYOUT:
            return self.rounding(out)   # the mode is off while it handles a call
        return out


@contextmanager
def stored(kind: str | None, models: Sequence[nn.Module] = ()):
    """Within: a stage computed with its weights and every intermediate
    stored in `kind` (``"bf16"``: the reference's twin in the program's
    serving precision; ``"fp8"``: the control of a bf16 stage), each
    operation in float32.  The parameters of `models` are rounded in place:
    give it a model of its own.  ``None``: float32 throughout."""
    if kind is None:
        yield
        return
    rounding = ROUNDING[kind]
    with torch.no_grad():
        for m in models:
            for p in m.parameters():
                p.copy_(rounding(p))
    with _Stored(rounding):
        yield


# -- the computations --------------------------------------------------------------

def spectrogram(audio: torch.Tensor, cfg: Config) -> torch.Tensor:
    """1-D float32 audio → [n_frames, n_freq] magnitudes: reflect-pad
    (n_fft − hop)/2 each side, periodic Hann window, no centring,
    sqrt(re² + im² + 1e-6) (mel_processing.py:54-74)."""
    pad = (cfg.filter_length - cfg.hop_length) // 2
    y = torch.nn.functional.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    window = torch.hann_window(cfg.win_length, periodic=True, device=audio.device, dtype=audio.dtype)
    spec = torch.stft(y, cfg.filter_length, cfg.hop_length, cfg.win_length, window=window, center=False,
                      onesided=True, return_complex=True)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6).t()


def convert(model: Synthesizer, spec: torch.Tensor, g_src: torch.Tensor, g_tgt: torch.Tensor, tau: float,
            noise: torch.Tensor) -> torch.Tensor:
    """Tone-colour conversion (models.py:492-499) of one clip: spec
    [T, n_freq], g_src / g_tgt [gin], noise [T, inter] standard normal →
    audio [T · upsample].  A V2 converter (zero_g) feeds zeros to the
    posterior encoder and the decoder."""
    cfg = model.cfg
    x = spec.t()[None]                                   # [1, n_freq, T]
    mask = torch.ones(1, 1, x.shape[2], device=x.device)
    gs, gt = g_src.reshape(1, -1, 1), g_tgt.reshape(1, -1, 1)
    g_enc = torch.zeros_like(gs) if cfg.zero_g else gs
    g_dec = torch.zeros_like(gt) if cfg.zero_g else gt
    enc = model.enc_q
    h = enc.enc(enc.pre(x), mask, g_enc)
    stats = enc.proj(h)
    m, logs = stats[:, : cfg.inter_channels], stats[:, cfg.inter_channels:]
    z = m + noise.t()[None] * tau * torch.exp(logs)
    z_p = model.flow(z, mask, g=gs)
    z_hat = model.flow(z_p, mask, g=gt, reverse=True)
    return model.dec(z_hat, g=g_dec)[0, 0]


def tts_durations(model: Synthesizer, tokens: torch.Tensor, sid: int, noise_w: torch.Tensor,
                  length_scale: float = 1.0, noise_scale_w: float = 0.6, sdp_ratio: float = 0.2):
    """The text side of one sentence (models.py:467-478): tokens [T_x] →
    (m_p, logs_p [T_x, inter], w [T_x] durations before the ceiling, g
    [gin]).  noise_w [T_x, 2] standard normal."""
    cfg = model.cfg
    x = model.enc_p.emb(tokens.long())[None] * math.sqrt(cfg.hidden_channels)  # [1, T_x, H]
    x = x.transpose(1, 2)
    mask = torch.ones(1, 1, x.shape[2], device=x.device)
    h = model.enc_p.encoder(x, mask)
    stats = model.enc_p.proj(h)
    m_p, logs_p = stats[0, : cfg.inter_channels].t(), stats[0, cfg.inter_channels:].t()
    g = model.emb_g.weight[sid].reshape(1, -1, 1)
    logw_sdp = model.sdp.reverse(h, mask, noise_w.t()[None], g, noise_scale_w)
    logw_dp = model.dp(h, mask, g)
    logw = logw_sdp * sdp_ratio + logw_dp * (1.0 - sdp_ratio)
    return m_p, logs_p, (torch.exp(logw) * length_scale)[0, 0], g.reshape(-1)


def tts_latents(m_p: torch.Tensor, logs_p: torch.Tensor, w_ceil: torch.Tensor, noise: torch.Tensor,
                noise_scale: float = 0.667) -> torch.Tensor:
    """Length regulation (models.py:479-487) of one sentence: integral
    durations w_ceil [T_x], noise [T_y, inter] with T_y = Σ w_ceil → z_p
    [T_y, inter]."""
    t_y = int(w_ceil.sum())
    attn = generate_path(w_ceil[None], torch.ones(1, t_y, w_ceil.shape[0], device=w_ceil.device))[0]
    return attn @ m_p + noise * torch.exp(attn @ logs_p) * noise_scale


def tts_decode(model: Synthesizer, z_p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The flow in reverse and the decoder (models.py:488-490) of one
    sentence's z_p [T_y, inter] → audio [T_y · upsample]."""
    mask = torch.ones(1, 1, z_p.shape[0], device=z_p.device)
    gg = g.reshape(1, -1, 1)
    z = model.flow(z_p.t()[None], mask, g=gg, reverse=True)
    return model.dec(z, g=gg)[0, 0]


def np_audio(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()
