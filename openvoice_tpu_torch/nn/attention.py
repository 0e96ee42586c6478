"""Transformer encoder with windowed relative-position attention, the text
encoder's stack (reference: attentions.py:37-465; JAX:
``openvoice_tpu/nn/attention.py``).

The relative logits are the banded form of the JAX package:

    scores[t, s] += q[t] · E_k[s − t + w]   for |s − t| ≤ w, else 0
    out[t]      += Σ_r p[t, t + r − w] · E_v[r]   (0 where t + r − w is out of range)

computed as one [B, H, T, 2w+1] product and a gather.  The reference zero-pads
the embeddings outside the window, so out-of-window relative logits are
exactly 0.  Masked scores are set to −1e4, not −inf, as in the reference.

Plain ``torch`` products throughout: the JAX package computes attention
outside any Pallas kernel.  Modules run in [B, C, T]; their attributes follow
the reference's state-dict keys.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from openvoice_tpu_torch.nn.conv import LayerNorm, conv1d


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


def apply_encoder(encoder: Encoder, x: torch.Tensor, x_mask: torch.Tensor,
                  g: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX layout: x [B, T, C], x_mask [B, T, 1], g [B, 1, gin] → [B, T, C]."""
    g_t = g.transpose(1, 2) if g is not None else None
    return encoder(x.transpose(1, 2), x_mask.transpose(1, 2), g_t).transpose(1, 2)
