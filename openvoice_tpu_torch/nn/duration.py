"""Duration predictors of the base-speaker TTS (reference: models.py:60-180;
JAX: ``openvoice_tpu/nn/duration.py``).

* `DurationPredictor`: the deterministic conv regressor (models.py:60-100).
* `StochasticDurationPredictor.reverse`: the inference path (models.py:172-180):
  reversed spline flows map noise to log-durations.  The reverse chain runs
  conv-flows 3, 2 and 1, each after a flip, skips conv-flow 0 exactly as the
  reference does ("remove a useless vflow"), then a flip and the elementwise
  affine.

The noise is the caller's ([B, T, 2] in the JAX layout), so a seed gives
the same draws in both packages.  The training path (``apply_sdp_forward``)
waits for the training slice; the posterior modules it needs are built here
so that a reference checkpoint loads by name.
"""

from __future__ import annotations

import torch
from torch import nn

from openvoice_tpu_torch.nn.conv import LayerNorm, conv1d
from openvoice_tpu_torch.nn.flows import ConvFlow, DDSConv, ElementwiseAffine, Flip, flip_flow


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


def apply_duration_predictor(dp: DurationPredictor, x: torch.Tensor, x_mask: torch.Tensor,
                             g: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX layout: x [B, T, C], x_mask [B, T, 1], g [B, 1, gin] → [B, T, 1]."""
    g_t = g.transpose(1, 2) if g is not None else None
    return dp(x.transpose(1, 2), x_mask.transpose(1, 2), g_t).transpose(1, 2)


def apply_sdp_reverse(sdp: StochasticDurationPredictor, x: torch.Tensor, x_mask: torch.Tensor,
                      noise: torch.Tensor, g: torch.Tensor | None = None,
                      noise_scale: float = 1.0) -> torch.Tensor:
    """The JAX layout: x [B, T, C], x_mask [B, T, 1], noise [B, T, 2],
    g [B, 1, gin] → logw [B, T, 1]."""
    g_t = g.transpose(1, 2) if g is not None else None
    logw = sdp.reverse(x.transpose(1, 2), x_mask.transpose(1, 2), noise.transpose(1, 2), g_t, noise_scale)
    return logw.transpose(1, 2)
