"""The plain f32 modules of the benchmark's reference: a frozen copy of the
stock-layer modules that OpenVoice's synthesizer is built from (reference
repository: openvoice/modules.py, attentions.py, models.py, commons.py).

The classes below are copied verbatim from the PyTorch port's f32 parity
modules as they stood when the benchmark was written, so that their
``state_dict()`` keys are the reference checkpoints' keys.  Departures from
the port's modules, all by omission:

* no kernel route: `WN`, `ResidualCouplingBlock` and `Generator` have only
  their stock-layer ``forward`` (the port's ``apply_wn``,
  ``apply_generator`` and packed caches are not here);
* the training pieces (the duration predictor's NLL, the VITS2 options) are
  left out; `Encoder` keeps its speaker input, which the V1 text encoder
  does not use.

Nothing here imports the port: later changes to the port do not move the
yardstick.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ovbench.reference.transforms import piecewise_rational_quadratic_transform


def conv1d(cin: int, cout: int, kernel_size: int = 1, dilation: int = 1,
           bias: bool = True) -> nn.Conv1d:
    """"Same"-length Conv1d: padding (k·d − d)/2 (commons.get_padding)."""
    return nn.Conv1d(
        cin, cout, kernel_size, dilation=dilation,
        padding=(kernel_size * dilation - dilation) // 2, bias=bias,
    )


def conv_transpose1d(cin: int, cout: int, kernel_size: int, stride: int) -> nn.ConvTranspose1d:
    """HiFi-GAN upsample: ConvTranspose1d with padding (k − u)/2
    (models.py:257-266), so T_out = T·u when k − u is even."""
    return nn.ConvTranspose1d(cin, cout, kernel_size, stride, padding=(kernel_size - stride) // 2)


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, C, T] (modules.py:17-29), with
    the reference's parameter names ``gamma`` and ``beta``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.transpose(1, -1), self.gamma.shape, self.gamma, self.beta, self.eps)
        return x.transpose(1, -1)


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """lengths: [B] → bool [B, max_length]."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Durations → monotonic alignment matrix (commons.py:128-142).

    duration [B, T_x] (integral frame counts per token), mask [B, T_y, T_x]
    → [B, T_y, T_x] in mask's dtype, 1 where frame t_y is produced by token
    t_x: token t_x owns frames [cum[t_x − 1], cum[t_x])."""
    t_y = mask.shape[1]
    cum = torch.cumsum(duration, dim=-1)  # [B, T_x]
    pos = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    path = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)  # [B, T_x, T_y]
    path = path - F.pad(path, (0, 0, 1, 0))[:, :-1]
    return path.transpose(1, 2) * mask


class WN(nn.Module):
    """Attributes follow the reference's state-dict keys: ``in_layers.N``,
    ``res_skip_layers.N``, ``cond_layer``."""

    def __init__(self, hidden: int, kernel_size: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.hidden = hidden
        # dilation_rate is 1 in every OpenVoice config (models.py:438-448)
        self.in_layers = nn.ModuleList(
            conv1d(hidden, 2 * hidden, kernel_size) for _ in range(n_layers)
        )
        self.res_skip_layers = nn.ModuleList(
            conv1d(hidden, 2 * hidden if i < n_layers - 1 else hidden)
            for i in range(n_layers)
        )
        self.cond_layer = conv1d(gin_channels, 2 * hidden * n_layers) if gin_channels else None

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, H, T], x_mask: [B, 1, T], g: [B, gin, 1] or None → [B, H, T]."""
        h = self.hidden
        # the conditioning is projected once for all layers and sliced per
        # layer (modules.py:156-160)
        g_all = self.cond_layer(g) if g is not None and self.cond_layer is not None else None
        output = torch.zeros_like(x)
        last = len(self.in_layers) - 1
        for i, (in_layer, rs_layer) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            x_in = in_layer(x)
            if g_all is not None:
                x_in = x_in + g_all[:, i * 2 * h : (i + 1) * 2 * h]
            acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
            res_skip = rs_layer(acts)
            if i < last:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip  # the last layer is skip-only
        return output * x_mask


def flip_flow(x: torch.Tensor) -> torch.Tensor:
    """Reverse the channel axis of [B, C, T] (its own inverse)."""
    return torch.flip(x, dims=(1,))


class Flip(nn.Module):
    """Parameter-free; holds the odd slots of ``flows`` as in the reference."""

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False) -> torch.Tensor:
        return flip_flow(x)


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling: x1 ← (x1 ± m(x0)) · mask.  Attributes follow
    the reference's state-dict keys: ``pre``, ``enc``, ``post``."""

    def __init__(self, channels: int, hidden: int, kernel_size: int, n_layers: int,
                 gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = conv1d(self.half, hidden)
        self.enc = WN(hidden, kernel_size, n_layers, gin_channels)
        self.post = conv1d(hidden, self.half)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False) -> torch.Tensor:
        x0, x1 = x[:, : self.half], x[:, self.half :]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingBlock(nn.Module):
    """n_flows × [coupling + flip]; ``flows.{0,2,4,6}`` are the couplings."""

    def __init__(self, channels: int, hidden: int, kernel_size: int, n_layers: int,
                 n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        flows: list[nn.Module] = []
        for _ in range(n_flows):
            flows.append(ResidualCouplingLayer(channels, hidden, kernel_size, n_layers, gin_channels))
            flows.append(Flip())
        self.flows = nn.ModuleList(flows)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False) -> torch.Tensor:
        """x: [B, C, T], x_mask: [B, 1, T], g: [B, gin, 1]; reverse runs the
        chain backwards."""
        for flow in (reversed(self.flows) if reverse else self.flows):
            x = flow(x, x_mask, g=g, reverse=reverse)
        return x


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack (modules.py:84-130): per layer a
    depthwise conv of dilation k**i → LayerNorm → GELU → 1×1 → LayerNorm →
    GELU → residual.  Attributes ``convs_sep``, ``convs_1x1``, ``norms_1``,
    ``norms_2``."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int):
        super().__init__()
        self.convs_sep = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, groups=channels, dilation=kernel_size ** i,
                      padding=(kernel_size * kernel_size ** i - kernel_size ** i) // 2)
            for i in range(n_layers))
        self.convs_1x1 = nn.ModuleList(conv1d(channels, channels) for _ in range(n_layers))
        self.norms_1 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))
        self.norms_2 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, C, T], x_mask [B, 1, T], g [B, C, T] or None → [B, C, T]."""
        if g is not None:
            x = x + g
        for sep, pw, norm1, norm2 in zip(self.convs_sep, self.convs_1x1, self.norms_1, self.norms_2):
            y = F.gelu(norm1(sep(x * x_mask)))
            y = F.gelu(norm2(pw(y)))
            x = x + y
        return x * x_mask


def log_flow(x: torch.Tensor, x_mask: torch.Tensor, reverse: bool = False):
    """log (forward, with its log-determinant [B]) or exp (reverse)."""
    if not reverse:
        y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
        return y, torch.sum(-y, dim=(1, 2))
    return torch.exp(x) * x_mask


class ElementwiseAffine(nn.Module):
    """y = m + exp(logs)·x per channel (modules.py:375-399); ``m`` and
    ``logs`` are [C, 1] as in the reference."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, reverse: bool = False):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            return y, torch.sum(self.logs * x_mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class ConvFlow(nn.Module):
    """Spline coupling (modules.py:459-516): half the channels condition a
    rational-quadratic spline of the other half.  Attributes ``pre``,
    ``convs`` (DDSConv), ``proj``."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int, n_layers: int,
                 num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = conv1d(self.half, filter_channels)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = conv1d(filter_channels, self.half * (num_bins * 3 - 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False):
        """x [B, C, T] → y (reverse) or (y, logdet [B]) (forward)."""
        x0, x1 = x[:, : self.half], x[:, self.half :]
        h = self.convs(self.pre(x0), x_mask, g=g)
        h = self.proj(h) * x_mask  # [B, half·(3K−1), T]
        b, _, t = x.shape
        h = h.reshape(b, self.half, 3 * self.num_bins - 1, t).permute(0, 1, 3, 2)  # [B, half, T, 3K−1]
        k, denom = self.num_bins, math.sqrt(self.filter_channels)
        x1, logabsdet = piecewise_rational_quadratic_transform(
            x1, h[..., :k] / denom, h[..., k : 2 * k] / denom, h[..., 2 * k :],
            inverse=reverse, tails="linear", tail_bound=self.tail_bound)
        y = torch.cat([x0, x1], dim=1) * x_mask
        if reverse:
            return y
        return y, torch.sum(logabsdet * x_mask, dim=(1, 2))


LRELU_SLOPE = 0.1


def _masked(x: torch.Tensor, x_mask: torch.Tensor | None) -> torch.Tensor:
    return x if x_mask is None else x * x_mask


class ResBlock1(nn.Module):
    """3× (lrelu → dilated conv → lrelu → conv) with residual; attributes
    ``convs1.N`` / ``convs2.N`` as in the reference."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList(conv1d(channels, channels, kernel_size, dilation=d) for d in dilations)
        self.convs2 = nn.ModuleList(conv1d(channels, channels, kernel_size) for _ in dilations)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = _masked(F.leaky_relu(x, LRELU_SLOPE), x_mask)
            xt = _masked(F.leaky_relu(c1(xt), LRELU_SLOPE), x_mask)
            x = c2(xt) + x
        return _masked(x, x_mask)


class Generator(nn.Module):
    """conv_pre → speaker cond → per stage [lrelu → upsample → MRF mean] →
    lrelu(0.01) → conv_post → tanh.  Attributes follow the reference's
    state-dict keys: ``conv_pre``, ``ups.N``, ``resblocks.N``,
    ``conv_post``, ``cond``."""

    def __init__(self, cfg):
        super().__init__()
        ch = cfg.upsample_initial_channel
        self.upsample_rates = tuple(cfg.upsample_rates)
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        self.conv_pre = conv1d(cfg.inter_channels, ch, 7)
        ups, resblocks = [], []
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cout = ch // 2 ** (i + 1)
            ups.append(conv_transpose1d(ch // 2**i, cout, k, u))
            for k_rb, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                resblocks.append(block(cout, k_rb, dils))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        self.conv_post = conv1d(cout, 1, 7, bias=False)
        self.cond = conv1d(cfg.gin_channels, ch) if cfg.gin_channels else None

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None,
                x_mask: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, inter, T], g: [B, gin, 1], x_mask: [B, 1, T] →
        audio [B, 1, T·prod(upsample_rates)]."""
        x = self.conv_pre(x)
        if g is not None and self.cond is not None:
            x = x + self.cond(g)
        x = _masked(x, x_mask)
        for i, (up, u) in enumerate(zip(self.ups, self.upsample_rates)):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            if x_mask is not None:
                x_mask = torch.repeat_interleave(x_mask, u, dim=2)
                x = x * x_mask
            branches = self.resblocks[i * self.num_kernels : (i + 1) * self.num_kernels]
            acc = None
            for rb in branches:
                y = rb(x, x_mask)
                acc = y if acc is None else acc + y
            x = acc / self.num_kernels
        # the final activation uses torch's default slope 0.01 (models.py:287)
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)


def _rel_to_abs_indices(t: int, window: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """idx[t, s] = clip(s − t + w, 0, 2w); valid[t, s] = |s − t| ≤ w."""
    pos = torch.arange(t, device=device)
    rel = pos[None, :] - pos[:, None]  # s − t
    return torch.clamp(rel + window, 0, 2 * window), rel.abs() <= window


def _band_indices(t: int, window: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """src[t, r] = t + r − w clipped into [0, T); valid where it was in range."""
    src = torch.arange(t, device=device)[:, None] + torch.arange(2 * window + 1, device=device)[None, :] - window
    return torch.clamp(src, 0, t - 1), (src >= 0) & (src < t)


class MultiHeadAttention(nn.Module):
    """Multi-head attention; attributes ``conv_q``, ``conv_k``, ``conv_v``,
    ``conv_o`` (1×1 convs) and, with a `window_size`, the relative keys and
    values ``emb_rel_k`` / ``emb_rel_v`` [1, 2w+1, dk] shared by the heads,
    as in the reference.  `proximal_bias` adds −log1p(|t − s|) to the
    self-attention scores (attentions.py:398-407), an option of the
    reference's Decoder stack."""

    def __init__(self, channels: int, n_heads: int, window_size: int | None = None, proximal_bias: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.window_size = window_size
        self.proximal_bias = proximal_bias
        self.k_channels = channels // n_heads
        self.conv_q = conv1d(channels, channels)
        self.conv_k = conv1d(channels, channels)
        self.conv_v = conv1d(channels, channels)
        self.conv_o = conv1d(channels, channels)
        if window_size is not None:
            std = self.k_channels ** -0.5
            self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, self.k_channels) * std)
            self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, self.k_channels) * std)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor | None, c: torch.Tensor | None = None) -> torch.Tensor:
        """x (queries) [B, C, T], c (keys and values; default x) [B, C, S],
        attn_mask [B, 1, T, S] (0 where masked) → [B, C, T]."""
        c = x if c is None else c
        b, ch, t = x.shape
        s = c.shape[2]
        h, dk, w = self.n_heads, self.k_channels, self.window_size

        def split(z, length):  # [B, C, L] → [B, H, L, dk]: C splits as (H, dk)
            return z.reshape(b, h, dk, length).transpose(2, 3)

        q, k, v = split(self.conv_q(x), t), split(self.conv_k(c), s), split(self.conv_v(c), s)
        q = q * (1.0 / math.sqrt(dk))
        scores = q @ k.transpose(2, 3)
        if w is not None:
            if s != t:
                raise ValueError("relative attention is self-attention only")
            idx, valid = _rel_to_abs_indices(t, w, x.device)
            q_rel = q @ self.emb_rel_k[0].t()  # [B, H, T, 2w+1]
            rel = torch.gather(q_rel, 3, idx.expand(b, h, t, t))
            scores = scores + torch.where(valid, rel, rel.new_zeros(()))
        if self.proximal_bias:
            if s != t:
                raise ValueError("the proximal bias is self-attention only")
            pos = torch.arange(t, device=x.device, dtype=torch.float32)
            scores = scores - torch.log1p((pos[None, :] - pos[:, None]).abs()).to(scores.dtype)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        p = torch.softmax(scores, dim=-1)
        out = p @ v
        if w is not None:
            src, band_valid = _band_indices(t, w, x.device)
            p_band = torch.gather(p, 3, src.expand(b, h, t, 2 * w + 1))
            p_band = torch.where(band_valid, p_band, p_band.new_zeros(()))
            out = out + p_band @ self.emb_rel_v[0]
        return self.conv_o(out.transpose(2, 3).reshape(b, ch, t))


class FFN(nn.Module):
    """Conv FFN with the reference's asymmetric "same" padding, (k−1)//2 left
    and k//2 right, or with `causal` (the Decoder stack's) k−1 left
    (attentions.py:424-465); attributes ``conv_1``, ``conv_2``."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int, kernel_size: int,
                 causal: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.causal = causal
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, kernel_size)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        if k == 1:
            return x
        return F.pad(x, (k - 1, 0) if self.causal else ((k - 1) // 2, k // 2))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv_1(self._pad(x * x_mask)))
        return self.conv_2(self._pad(x * x_mask)) * x_mask


class Encoder(nn.Module):
    """n_layers × [relative attention → LayerNorm(x + y) → FFN → LayerNorm(x + y)]
    (attentions.py:104-121); attributes ``attn_layers``, ``norm_layers_1``,
    ``ffn_layers``, ``norm_layers_2``.  With `gin_channels` (the VITS2 flow
    encoder, attentions.py:63-75) a speaker embedding projected by
    ``spk_emb_linear`` is added before layer `cond_layer_idx`."""

    def __init__(self, hidden: int, filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, window_size: int = 4, gin_channels: int = 0, cond_layer_idx: int = 2):
        super().__init__()
        self.attn_layers = nn.ModuleList(MultiHeadAttention(hidden, n_heads, window_size) for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(FFN(hidden, hidden, filter_channels, kernel_size) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.cond_layer_idx = cond_layer_idx
        self.spk_emb_linear = nn.Linear(gin_channels, hidden) if gin_channels else None

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, C, T], x_mask [B, 1, T], g [B, gin, 1] → [B, C, T]."""
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)  # [B, 1, T, T]
        x = x * x_mask
        for i, (attn, norm1, ffn, norm2) in enumerate(zip(self.attn_layers, self.norm_layers_1,
                                                          self.ffn_layers, self.norm_layers_2)):
            if g is not None and i == self.cond_layer_idx:
                x = (x + self.spk_emb_linear(g.transpose(1, 2)).transpose(1, 2)) * x_mask
            x = norm1(x + attn(x, attn_mask))
            x = norm2(x + ffn(x, x_mask))
        return x * x_mask


class DurationPredictor(nn.Module):
    """conv → ReLU → LayerNorm, twice, then a 1×1 projection; attributes
    ``conv_1``, ``norm_1``, ``conv_2``, ``norm_2``, ``proj``, ``cond``."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int, gin_channels: int = 0):
        super().__init__()
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.norm_1 = LayerNorm(filter_channels)
        self.conv_2 = nn.Conv1d(filter_channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.norm_2 = LayerNorm(filter_channels)
        self.proj = conv1d(filter_channels, 1)
        self.cond = conv1d(gin_channels, in_channels) if gin_channels else None

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, C, T], x_mask [B, 1, T], g [B, gin, 1] → logw [B, 1, T]."""
        if g is not None and self.cond is not None:
            x = x + self.cond(g)
        x = self.norm_1(torch.relu(self.conv_1(x * x_mask)))
        x = self.norm_2(torch.relu(self.conv_2(x * x_mask)))
        return self.proj(x * x_mask) * x_mask


def _flow_chain(channels: int, kernel_size: int, n_flows: int) -> nn.ModuleList:
    """[ElementwiseAffine, n_flows × (ConvFlow, Flip)], the reference's layout."""
    flows: list[nn.Module] = [ElementwiseAffine(2)]
    for _ in range(n_flows):
        flows += [ConvFlow(2, channels, kernel_size, n_layers=3), Flip()]
    return nn.ModuleList(flows)


class StochasticDurationPredictor(nn.Module):
    """Attributes follow the reference (models.py:103-142): ``pre``,
    ``proj``, ``convs``, ``flows``, ``post_pre``, ``post_proj``,
    ``post_convs``, ``post_flows``, ``cond``.  The reference sets its filter
    width to the input width (models.py:105)."""

    def __init__(self, in_channels: int, kernel_size: int, n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        filt = in_channels
        self.pre = conv1d(in_channels, filt)
        self.proj = conv1d(filt, filt)
        self.convs = DDSConv(filt, kernel_size, 3)
        self.flows = _flow_chain(filt, kernel_size, n_flows)
        self.post_pre = conv1d(1, filt)
        self.post_proj = conv1d(filt, filt)
        self.post_convs = DDSConv(filt, kernel_size, 3)
        self.post_flows = _flow_chain(filt, kernel_size, 4)
        self.cond = conv1d(gin_channels, filt) if gin_channels else None

    def context(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
        x = self.pre(x)
        if g is not None and self.cond is not None:
            x = x + self.cond(g)
        return self.proj(self.convs(x, x_mask)) * x_mask

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor, noise: torch.Tensor,
                g: torch.Tensor | None = None, noise_scale: float = 1.0) -> torch.Tensor:
        """x [B, C, T], x_mask [B, 1, T], noise [B, 2, T] → logw [B, 1, T]."""
        ctx = self.context(x, x_mask, g)
        z = noise * noise_scale
        conv_flows = list(self.flows[1::2])
        for cf in reversed(conv_flows[1:]):
            z = cf(flip_flow(z), x_mask, g=ctx, reverse=True)
        z = self.flows[0](flip_flow(z), x_mask, reverse=True)
        return z[:, 0:1]

