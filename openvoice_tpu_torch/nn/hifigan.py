"""HiFi-GAN generator (reference: models.py:224-298, modules.py:221-360;
JAX: ``openvoice_tpu/nn/hifigan.py``).

Plain f32 version.  With ``x_mask`` a bucket-padded batch decodes exactly
as the true-length one: the reference decodes at the true length, where
every conv sees zeros past the end, and re-zeroing the padded positions
after each conv (conv biases break zero propagation) reproduces that.  The
JAX serving mode runs stages 0-1 as ``ops/mrf_pallas.py::fused_mrf_stage``
and stages 2-3 as ``ops/mrf_pallas.py::fused_tail_stage``; the port does
not have those kernels yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.nn.conv import conv1d, conv_transpose1d

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


class ResBlock2(nn.Module):
    """2× (lrelu → dilated conv) with residual; attributes ``convs.N``."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList(conv1d(channels, channels, kernel_size, dilation=d) for d in dilations)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None) -> torch.Tensor:
        for c in self.convs:
            x = c(_masked(F.leaky_relu(x, LRELU_SLOPE), x_mask)) + x
        return _masked(x, x_mask)


class Generator(nn.Module):
    """conv_pre → speaker cond → per stage [lrelu → upsample → MRF mean] →
    lrelu(0.01) → conv_post → tanh.  Attributes follow the reference's
    state-dict keys: ``conv_pre``, ``ups.N``, ``resblocks.N``,
    ``conv_post``, ``cond``."""

    def __init__(self, cfg: SynthesizerConfig):
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


def apply_generator(gen: Generator, x: torch.Tensor, g: torch.Tensor | None = None,
                    x_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX layout: x [B, T, inter], g [B, 1, gin], x_mask [B, T, 1] →
    audio [B, T·upsample, 1]."""
    g_t = g.transpose(1, 2) if g is not None else None
    m_t = x_mask.transpose(1, 2) if x_mask is not None else None
    return gen(x.transpose(1, 2), g_t, m_t).transpose(1, 2)
