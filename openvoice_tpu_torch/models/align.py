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
