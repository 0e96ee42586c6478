"""Masking and monotonic-alignment helpers (reference: commons.py:121-142;
JAX: ``openvoice_tpu/models/align.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """lengths: [B] → bool [B, max_length]."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Durations → monotonic alignment matrix (commons.py:128-142).

    duration [B, T_x] (integral frame counts per token), mask [B, T_y, T_x]
    → [B, T_y, T_x] in mask's dtype, 1 where frame t_y is produced by token
    t_x: token t_x owns frames [cum[t_x − 1], cum[t_x])."""
    t_y = mask.shape[1]
    cum = torch.cumsum(duration, dim=-1)  # [B, T_x]
    pos = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    path = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)  # [B, T_x, T_y]
    path = path - F.pad(path, (0, 0, 1, 0))[:, :-1]
    return path.transpose(1, 2) * mask


def subsequent_mask(length: int, device=None) -> torch.Tensor:
    """Causal [1, 1, T, T] lower-triangular float mask (commons.py:95-97)."""
    return torch.tril(torch.ones(length, length, device=device))[None, None]


def rand_gumbel(shape, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """Overflow-protected Gumbel samples (commons.py:37-41): uniforms are
    squeezed into [1e-5, 0.99999] before the double log."""
    u = torch.rand(shape, generator=generator, device=device) * 0.99998 + 0.00001
    return -torch.log(-torch.log(u))


def timing_signal_1d(length: int, channels: int, min_timescale: float = 1.0,
                     max_timescale: float = 1.0e4, device=None) -> torch.Tensor:
    """Sinusoidal positional signal [1, length, channels] (commons.py:67-81,
    channels last as in the JAX package): the first half of the channels is
    sin, the second half cos, and an odd channel count pads one zero."""
    f32 = torch.float32
    position = torch.arange(length, dtype=f32, device=device)
    num_timescales = channels // 2
    log_inc = (torch.log(torch.tensor(max_timescale, dtype=f32) / torch.tensor(min_timescale, dtype=f32))
               / max(num_timescales - 1, 1))
    inv_timescales = min_timescale * torch.exp(torch.arange(num_timescales, dtype=f32, device=device)
                                               * -log_inc.to(device))
    scaled = position[None, :] * inv_timescales[:, None]  # [C/2, T]
    signal = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=0)
    signal = F.pad(signal, (0, 0, 0, channels % 2))
    return signal.t()[None]


def add_timing_signal_1d(x: torch.Tensor, min_timescale: float = 1.0, max_timescale: float = 1.0e4) -> torch.Tensor:
    """x [B, T, C] + sinusoidal positions (commons.py:84-87)."""
    return x + timing_signal_1d(x.shape[1], x.shape[2], min_timescale, max_timescale, x.device).to(x.dtype)


def cat_timing_signal_1d(x: torch.Tensor, min_timescale: float = 1.0, max_timescale: float = 1.0e4) -> torch.Tensor:
    """x [B, T, C] with sinusoidal positions concatenated on the channels
    (commons.py:90-92)."""
    sig = timing_signal_1d(x.shape[1], x.shape[2], min_timescale, max_timescale, x.device)
    return torch.cat([x, sig.expand(x.shape).to(x.dtype)], dim=-1)
