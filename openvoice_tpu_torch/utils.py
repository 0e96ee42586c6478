"""Watermark bit packing (the port's copy of ``openvoice_tpu/utils.py``;
reference utils.py:46-75 semantics)."""

from __future__ import annotations

import numpy as np


def string_to_bits(string: str, pad_len: int = 8) -> np.ndarray:
    """Message → [pad_len, 8] bit matrix; unused rows carry a marker bit in
    column 2 (utils.py:59 — '32 bits per chunk' framing depends on it)."""
    bit_rows = [[int(b) for b in bin(ord(c))[2:].zfill(8)] for c in string]
    arr = np.array(bit_rows, dtype=np.int64) if bit_rows else np.zeros((0, 8), np.int64)
    full = np.zeros((pad_len, 8), dtype=arr.dtype)
    full[:, 2] = 1
    n = min(pad_len, len(arr))
    full[:n] = arr[:n]
    return full


def bits_to_string(bits_array: np.ndarray) -> str:
    chars = []
    for row in np.asarray(bits_array):
        value = int("".join(str(int(b)) for b in row), 2)
        chars.append(chr(value))
    return "".join(chars)
