"""HiFi-GAN/VITS discriminators for adversarial converter training (the
port of ``openvoice_tpu/training/discriminator.py``).

A multi-scale (waveform) discriminator and a bank of period discriminators
(periods 2, 3, 5, 7, 11), trained with the LSGAN objectives of
``training/losses.py``.  Plain kernels, no weight norm, as in the JAX
package.  PyTorch layouts inside: a period discriminator folds the waveform
into NCHW [B, 1, T/p, p] and runs (5, 1)-kernel Conv2d stacks; the scale
discriminator runs grouped Conv1d on [B, 1, T].  Logits flatten in the JAX
package's order (height, then width).  Feature maps stay in PyTorch's
layout: the losses reduce over every element, so the layout does not enter
them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
PERIODS: tuple[int, ...] = (2, 3, 5, 7, 11)

# DiscriminatorP conv ladder: out channels; kernel (5, 1), stride (3, 1)
_P_CHANNELS = (32, 128, 512, 1024)
# DiscriminatorS ladder: (out, kernel, stride, groups, padding)
_S_LADDER = (
    (128, 15, 1, 1, 7),
    (128, 41, 2, 4, 20),
    (256, 41, 2, 16, 20),
    (512, 41, 4, 16, 20),
    (1024, 41, 4, 16, 20),
    (1024, 41, 1, 16, 20),
    (1024, 5, 1, 1, 2),
)


class PeriodDiscriminator(nn.Module):
    """``convs.N`` (5, 1)-kernel Conv2d, stride (3, 1) but for the last, and
    ``post`` (3, 1) to one channel."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = (1, *_P_CHANNELS, 1024)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, (5, 1), stride=(3, 1) if i < len(_P_CHANNELS) else (1, 1), padding=(2, 0))
            for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:]))
        )
        self.post = nn.Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, audio: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """audio [B, T] → (logits [B, T'·p], feature maps [B, C, H, p])."""
        b, t = audio.shape
        pad = (-t) % self.period
        if pad:
            # F.pad's reflect mode takes a 3-D input; a one-sample signal has
            # nothing to reflect and pads with zeros, as the JAX package does
            mode = "reflect" if t > 1 else "constant"
            audio = F.pad(audio[:, None], (0, pad), mode=mode)[:, 0]
        x = audio.reshape(b, 1, (t + pad) // self.period, self.period)
        fmaps = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmaps.append(x)
        x = self.post(x)
        fmaps.append(x)
        return x.reshape(b, -1), fmaps


class ScaleDiscriminator(nn.Module):
    """``convs.N`` grouped Conv1d on the `_S_LADDER`, and ``post`` (k 3)."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 1
        for cout, k, s, g, p in _S_LADDER:
            convs.append(nn.Conv1d(cin, cout, k, stride=s, groups=g, padding=p))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.post = nn.Conv1d(cin, 1, 3, padding=1)

    def forward(self, audio: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """audio [B, T] → (logits [B, T'], feature maps [B, C, T'])."""
        x = audio[:, None]
        fmaps = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmaps.append(x)
        x = self.post(x)
        fmaps.append(x)
        return x.reshape(x.shape[0], -1), fmaps


class Discriminators(nn.Module):
    """``scale`` and ``periods.N`` (periods `PERIODS`), as the JAX pytree's
    ``{"scale", "periods"}``."""

    def __init__(self):
        super().__init__()
        self.scale = ScaleDiscriminator()
        self.periods = nn.ModuleList(PeriodDiscriminator(p) for p in PERIODS)

    def forward(self, audio: torch.Tensor) -> tuple[list[torch.Tensor], list[list[torch.Tensor]]]:
        """Every sub-discriminator on audio [B, T]: the scale one first, then
        the periods in order → (logits, feature maps), one entry each."""
        logits, fmaps = [], []
        for d in (self.scale, *self.periods):
            lo, f = d(audio)
            logits.append(lo)
            fmaps.append(f)
        return logits, fmaps


def init_discriminators(generator: torch.Generator) -> Discriminators:
    """Random weights on the CPU with the distributions of the JAX
    ``init_discriminators``: every weight normal(0, 0.01), every bias 0.
    The draws differ from JAX's; tests that compare the two packages send
    JAX's weights through ``ckpt/from_jax.py::discriminators_from_jax``."""
    disc = Discriminators()
    with torch.no_grad():
        for module in disc.modules():
            if isinstance(module, (nn.Conv1d, nn.Conv2d)):
                module.weight.normal_(0.0, 0.01, generator=generator)
                module.bias.zero_()
    return disc
