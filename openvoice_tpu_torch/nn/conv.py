"""Convolution layers of the port, with the padding conventions of the
reference (modules.py, models.py) built in, and the reference's
channel-first LayerNorm.

The JAX package writes these as functions over [B, T, C] tensors with
[K, C_in, C_out] kernels (``openvoice_tpu/nn/conv.py``).  The port keeps
PyTorch's own layers and layouts inside: [B, C, T] activations and the
reference's [C_out, C_in, K] weights, so a module's ``state_dict()`` is the
reference's.  The [B, T, C] layout of the JAX package appears only at the
public functions of ``nn/`` and ``models/`` (``apply_*``), which transpose
once on the way in and once on the way out.

These are stock PyTorch layers: in the JAX package XLA, not a Pallas
kernel, computes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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


def conv2d(cin: int, cout: int) -> nn.Conv2d:
    """Reference-encoder Conv2d: 3×3, stride 2, padding 1 (models.py:317-326)."""
    return nn.Conv2d(cin, cout, kernel_size=3, stride=2, padding=1)


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
