"""The converter's normalizing flow: mean-only residual couplings and channel
flips (reference: modules.py:363-456, models.py:367-397; JAX:
``openvoice_tpu/nn/flows.py``).

These are the plain stock-layer modules (the f32 parity mode).  The serving
mode runs each direction of the block as one kernel, from weights packed off
these modules (``ops/coupling_cuda.py``, the port of the Pallas kernel
``ops/coupling_pallas.py::fused_coupling_block``).
"""

from __future__ import annotations

import torch
from torch import nn

from openvoice_tpu_torch.nn.conv import conv1d
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
