"""Tone-colour (speaker-embedding) reference encoder (reference:
models.py:301-364; JAX: ``openvoice_tpu/nn/ref_encoder.py``).

Spectrogram [B, T, n_freq] → LayerNorm → 6× strided Conv2d+ReLU → GRU over
time → hidden state at each clip's true last step → Linear.  Length-aware as
in the JAX package: a batch of clips padded to one bucket runs at once, the
padded frames are re-zeroed after every conv, and the GRU state is read at
each clip's last valid step, so each row equals the clip run alone.
"""

from __future__ import annotations

import torch
from torch import nn

from openvoice_tpu_torch.models.align import sequence_mask
from openvoice_tpu_torch.nn.conv import conv2d

_FILTERS = (1, 32, 32, 64, 64, 128, 128)
GRU_HIDDEN = 128


def reduced_length(length, n_convs: int = len(_FILTERS) - 1):
    """Length after the stride-2 conv stack: L → (L − 1)//2 + 1 per layer
    (k=3, s=2, p=1).  Works on ints and on integer tensors."""
    for _ in range(n_convs):
        length = (length - 1) // 2 + 1
    return length


class ReferenceEncoder(nn.Module):
    """Attributes follow the reference's state-dict keys: ``layernorm``,
    ``convs.N``, ``gru``, ``proj``."""

    def __init__(self, spec_channels: int, gin_channels: int):
        super().__init__()
        self.layernorm = nn.LayerNorm(spec_channels)
        self.convs = nn.ModuleList(conv2d(_FILTERS[i], _FILTERS[i + 1]) for i in range(len(_FILTERS) - 1))
        self.gru = nn.GRU(_FILTERS[-1] * reduced_length(spec_channels), GRU_HIDDEN, batch_first=True)
        self.proj = nn.Linear(GRU_HIDDEN, gin_channels)

    def forward(self, spec: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """spec: [B, T, n_freq] linear magnitudes (+ true frame counts [B]) →
        [B, gin]."""
        x = self.layernorm(spec)
        cur_len = lengths
        if cur_len is not None:
            x = x * sequence_mask(cur_len, x.shape[1]).to(x.dtype)[..., None]
        x = x.unsqueeze(1)  # [B, 1, T, F]: time is H, frequency is W
        for conv in self.convs:
            x = torch.relu(conv(x))
            if cur_len is not None:
                cur_len = reduced_length(cur_len, 1)
                x = x * sequence_mask(cur_len, x.shape[2]).to(x.dtype)[:, None, :, None]
        b, c, t, f = x.shape
        # [B, C, T', F'] → [B, T', C·F'], the reference's view (models.py:352-354)
        x = x.transpose(1, 2).reshape(b, t, c * f)
        hs, _ = self.gru(x)  # [B, T', H]
        if cur_len is None:
            h = hs[:, -1]
        else:
            idx = torch.clamp(cur_len - 1, 0, t - 1).long()
            h = hs[torch.arange(b, device=hs.device), idx]
        return self.proj(h)
