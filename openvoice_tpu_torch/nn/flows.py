"""Normalizing-flow building blocks (reference: modules.py:84-516,
models.py:367-397; JAX: ``openvoice_tpu/nn/flows.py``): the converter's
mean-only residual couplings and channel flips, and the stochastic duration
predictor's pieces (DDSConv, the elementwise affine and log flows, and the
spline coupling `ConvFlow`).

These are the plain stock-layer modules (the f32 parity mode).  The serving
mode runs each direction of the coupling block as one kernel, from weights
packed off these modules (``ops/coupling_cuda.py``, the port of the Pallas
kernel ``ops/coupling_pallas.py::fused_coupling_block``).  The duration
predictor's flows stay f32 in both modes, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from openvoice_tpu_torch.nn.conv import LayerNorm, conv1d
from openvoice_tpu_torch.nn.transforms import piecewise_rational_quadratic_transform
from openvoice_tpu_torch.nn.wavenet import WN


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


def apply_coupling_block(block: ResidualCouplingBlock, x: torch.Tensor, x_mask: torch.Tensor,
                         g: torch.Tensor | None = None, reverse: bool = False) -> torch.Tensor:
    """The JAX layout: x [B, T, C], x_mask [B, T, 1], g [B, 1, gin] → [B, T, C]."""
    g_t = g.transpose(1, 2) if g is not None else None
    return block(x.transpose(1, 2), x_mask.transpose(1, 2), g_t, reverse=reverse).transpose(1, 2)


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
