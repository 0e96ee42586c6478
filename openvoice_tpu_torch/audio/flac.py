"""FLAC decode/encode through the in-repo codec (``audio/native_src/flac.cc``, a
from-scratch implementation of the FLAC bitstream with no system library),
the port of ``openvoice_tpu/audio/flac.py``: where the native library builds,
FLAC works."""

from __future__ import annotations

import numpy as np

from openvoice_tpu_torch.audio.native import _load, as_float_p, decode_file, frames_channels


def available() -> bool:
    """True once the native library is built (a failed build raises)."""
    return _load() is not None


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file → (float32 samples [T] or [T, C], sample_rate)."""
    lib = _load()
    return decode_file(lib.ovt_flac_decode, lib.ovt_free, path, "flac")


def write_flac(path: str, audio: np.ndarray, sr: int) -> None:
    """Encode float32 samples ([T] mono or [T, C], values in [-1, 1]) as
    16-bit FLAC: decoding returns the PCM16 quantisation of the input
    exactly."""
    lib = _load()
    audio, frames, ch = frames_channels(audio)
    rc = lib.ovt_flac_encode(path.encode(), as_float_p(audio), frames, int(sr), ch)
    if rc < 0:
        raise ValueError(f"flac encode failed for {path} (code {rc})")
