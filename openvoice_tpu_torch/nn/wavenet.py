"""WaveNet residual-gated stack, the inner block of the posterior encoder and
of every coupling layer (reference: modules.py:133-210; JAX:
``openvoice_tpu/nn/wavenet.py``).

`WN` is the plain stack of stock layers (the f32 parity mode).  With
pre-packed weights `apply_wn` runs the whole stack as one kernel instead
(``ops/wn_cuda.py``, the port of the Pallas kernel
``ops/wn_pallas.py::fused_wn_stack``): that is the serving mode's route.
"""

from __future__ import annotations

import torch
from torch import nn

from openvoice_tpu_torch.nn.conv import conv1d
from openvoice_tpu_torch.ops.wn_cuda import wn_stack


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


def apply_wn(wn: WN, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None,
             stacked: dict | None = None, cond: nn.Module | None = None) -> torch.Tensor:
    """The JAX layout: x [B, T, H], x_mask [B, T, 1], g [B, 1, gin] → [B, T, H].

    `stacked` is the stack packed once by ``ops.wn_cuda.stack_wn_params``
    (``models.synthesizer.make_dec_cache``).  When it is given in x's dtype,
    which in the serving mode is bf16, the stack runs as one kernel; the
    conditioning is still projected once outside it, by `cond` (a copy of
    ``wn.cond_layer`` in x's dtype) or by ``wn.cond_layer`` itself."""
    if stacked is not None and stacked["w_in"].dtype == x.dtype:
        n_layers = len(wn.in_layers)
        cond = cond if cond is not None else wn.cond_layer
        if g is not None and cond is not None:
            g_all = cond(g.transpose(1, 2)).reshape(x.shape[0], n_layers, 2 * wn.hidden)
        else:
            g_all = x.new_zeros(x.shape[0], n_layers, 2 * wn.hidden)
        lengths = (x_mask[:, :, 0] != 0).sum(dim=1, dtype=torch.int32)
        return wn_stack((x * x_mask).contiguous(), lengths, stacked, g_all.contiguous())
    g_t = g.transpose(1, 2) if g is not None else None
    return wn(x.transpose(1, 2), x_mask.transpose(1, 2), g_t).transpose(1, 2)
