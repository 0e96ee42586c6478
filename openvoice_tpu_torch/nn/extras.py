"""Auxiliary blocks of the reference's inventory (the port of
``openvoice_tpu/nn/extras.py``): `ConvReluNorm` (modules.py:32-81), the
VITS2-style `TransformerCouplingLayer` (modules.py:519-581) and its block
`TransformerCouplingBlock`, and the attention `Decoder` stack
(attentions.py:124-207).

MeloTTS (OpenVoice V2's base speaker, melo/models.py TransformerCouplingBlock)
builds its flow of `TransformerCouplingBlock`; `ConvReluNorm` and `Decoder`
are working components that no released config instantiates, kept as the
JAX package keeps them.  Modules run in [B, C, T]; their attributes follow
the reference's state-dict keys.  ``ckpt/from_jax.py::extras_from_jax``
fills them from the JAX package's parameter pytrees.
"""

from __future__ import annotations

import torch
from torch import nn

from openvoice_tpu_torch.models.align import subsequent_mask
from openvoice_tpu_torch.nn.attention import FFN, Encoder, MultiHeadAttention
from openvoice_tpu_torch.nn.conv import LayerNorm, conv1d
from openvoice_tpu_torch.nn.flows import Flip


class ConvReluNorm(nn.Module):
    """n_layers × [conv (k, "same") → LayerNorm → ReLU], then a residual
    1×1 projection initialised to zero, so the block starts as the identity;
    attributes ``conv_layers``, ``norm_layers``, ``proj``."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, kernel_size: int, n_layers: int):
        super().__init__()
        if n_layers <= 1:
            raise ValueError("ConvReluNorm needs more than one layer")
        self.conv_layers = nn.ModuleList(
            nn.Conv1d(in_channels if i == 0 else hidden_channels, hidden_channels, kernel_size,
                      padding=kernel_size // 2) for i in range(n_layers))
        self.norm_layers = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.proj = conv1d(hidden_channels, out_channels)
        with torch.no_grad():
            self.proj.weight.zero_()
            self.proj.bias.zero_()

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        """x [B, C_in, T], x_mask [B, 1, T] → [B, C_out, T]."""
        x_org = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = torch.relu(norm(conv(x * x_mask)))
        return (x_org + self.proj(x)) * x_mask


class TransformerCouplingLayer(nn.Module):
    """Mean-only affine coupling with a relative-attention context network;
    attributes ``pre``, ``enc`` (an `Encoder`, speaker-conditioned before
    layer 2 when `gin_channels` is set), ``post`` (zero at init: the
    coupling starts as the identity)."""

    def __init__(self, channels: int, hidden_channels: int, filter_channels: int, kernel_size: int,
                 n_layers: int, n_heads: int, window_size: int = 4, gin_channels: int = 0):
        super().__init__()
        if channels % 2:
            raise ValueError("a coupling splits an even channel count")
        self.half = channels // 2
        self.pre = conv1d(self.half, hidden_channels)
        self.enc = Encoder(hidden_channels, filter_channels, n_heads, n_layers, kernel_size, window_size,
                           gin_channels=gin_channels, cond_layer_idx=2)
        self.post = conv1d(hidden_channels, self.half)
        with torch.no_grad():
            self.post.weight.zero_()
            self.post.bias.zero_()

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False):
        """x [B, C, T], x_mask [B, 1, T], g [B, gin, 1] → (y, logdet [B],
        zero for a mean-only coupling) forward, y in reverse."""
        if g is not None:
            if self.enc.spk_emb_linear is None:
                raise ValueError("a conditioned coupling needs gin_channels at construction")
            if len(self.enc.attn_layers) < 3:
                raise ValueError("the conditioning enters before layer 2: n_layers must be at least 3")
        x0, x1 = x[:, : self.half], x[:, self.half :]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g)
        m = self.post(h) * x_mask
        if reverse:
            return torch.cat([x0, (x1 - m) * x_mask], dim=1)
        return torch.cat([x0, (m + x1) * x_mask], dim=1), x.new_zeros(x.shape[0])


class TransformerCouplingBlock(nn.Module):
    """n_flows × [mean-only `TransformerCouplingLayer` + flip]
    (melo/models.py TransformerCouplingBlock, without shared parameters);
    ``flows.{0,2,4,6}`` are the couplings, each with its own context
    encoder.  The stock layers run it in both modes: no kernel takes it."""

    def __init__(self, channels: int, hidden_channels: int, filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        flows: list[nn.Module] = []
        for _ in range(n_flows):
            flows.append(TransformerCouplingLayer(channels, hidden_channels, filter_channels, kernel_size,
                                                  n_layers, n_heads, gin_channels=gin_channels))
            flows.append(Flip())
        self.flows = nn.ModuleList(flows)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False) -> torch.Tensor:
        """x [B, C, T], x_mask [B, 1, T], g [B, gin, 1] → [B, C, T]; reverse
        runs the chain backwards (the TTS's direction)."""
        for flow in (reversed(self.flows) if reverse else self.flows):
            out = flow(x, x_mask, g=g, reverse=reverse)
            x = out if reverse or isinstance(flow, Flip) else out[0]
        return x


class Decoder(nn.Module):
    """n_layers × [causal self-attention → LayerNorm(x + y) → attention over
    the encoder output → LayerNorm(x + y) → causal FFN → LayerNorm(x + y)];
    attributes ``self_attn_layers``, ``norm_layers_0``,
    ``encdec_attn_layers``, ``norm_layers_1``, ``ffn_layers``,
    ``norm_layers_2`` (attentions.py:124-207)."""

    def __init__(self, hidden: int, filter_channels: int, n_heads: int, kernel_size: int, n_layers: int,
                 proximal_bias: bool = False):
        super().__init__()
        self.self_attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden, n_heads, proximal_bias=proximal_bias) for _ in range(n_layers))
        self.norm_layers_0 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.encdec_attn_layers = nn.ModuleList(MultiHeadAttention(hidden, n_heads) for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden, hidden, filter_channels, kernel_size, causal=True) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, h: torch.Tensor, h_mask: torch.Tensor) -> torch.Tensor:
        """x [B, C, T] decoder input, x_mask [B, 1, T], h [B, C, S] encoder
        output, h_mask [B, 1, S] → [B, C, T]."""
        t = x.shape[2]
        self_mask = subsequent_mask(t, x.device).to(x.dtype) * (x_mask.unsqueeze(-1) * x_mask.unsqueeze(2))
        cross_mask = x_mask.unsqueeze(-1) * h_mask.unsqueeze(2)  # [B, 1, T, S]
        x = x * x_mask
        for layers in zip(self.self_attn_layers, self.norm_layers_0, self.encdec_attn_layers, self.norm_layers_1,
                          self.ffn_layers, self.norm_layers_2):
            self_attn, norm0, cross_attn, norm1, ffn, norm2 = layers
            x = norm0(x + self_attn(x, self_mask))
            x = norm1(x + cross_attn(x, cross_mask, c=h))
            x = norm2(x + ffn(x, x_mask))
        return x * x_mask


def _bct(x: torch.Tensor | None) -> torch.Tensor | None:
    return None if x is None else x.transpose(1, 2)


def apply_conv_relu_norm(block: ConvReluNorm, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
    """The JAX layout: x [B, T, C], x_mask [B, T, 1] → [B, T, C_out]."""
    return _bct(block(_bct(x), _bct(x_mask)))


def apply_transformer_coupling_layer(layer: TransformerCouplingLayer, x: torch.Tensor, x_mask: torch.Tensor,
                                     g: torch.Tensor | None = None, reverse: bool = False):
    """The JAX layout: x [B, T, C], x_mask [B, T, 1], g [B, 1, gin] → (y,
    logdet) forward, y in reverse."""
    out = layer(_bct(x), _bct(x_mask), _bct(g), reverse=reverse)
    return _bct(out) if reverse else (_bct(out[0]), out[1])


def apply_decoder(decoder: Decoder, x: torch.Tensor, x_mask: torch.Tensor, h: torch.Tensor,
                  h_mask: torch.Tensor) -> torch.Tensor:
    """The JAX layout: x [B, T, C], x_mask [B, T, 1], h [B, S, C], h_mask
    [B, S, 1] → [B, T, C]."""
    return _bct(decoder(_bct(x), _bct(x_mask), _bct(h), _bct(h_mask)))
