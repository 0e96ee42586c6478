"""MP3 decode/encode through the native codec (``native/src/mp3.cc``: mpg123
decode, lame encode, both dlopen'd), the port of
``openvoice_tpu/audio/mp3.py``.

The library is the port's own build (`_native_build`); a missing system
libmpg123 makes `read_mp3` raise, a missing libmp3lame makes
`encoder_available` False, as in the JAX package.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from openvoice_tpu_torch.audio.native import _load, as_float_p, decode_file, frames_channels


def read_mp3(path: str) -> tuple[np.ndarray, int]:
    """Decode an MP3 file → (float32 samples [T] or [T, C], sample_rate)."""
    lib = _load()
    return decode_file(lib.ovt_mp3_decode, lib.ovt_free, path, "mp3")


_ENCODER_OK: bool | None = None


def encoder_available() -> bool:
    """True when the system libmp3lame resolves at run time (probed with a
    one-frame encode; the encoder answers -3 without it)."""
    global _ENCODER_OK
    if _ENCODER_OK is None:
        lib = _load()
        probe = np.zeros(1152, np.float32)
        fd, path = tempfile.mkstemp(suffix=".mp3")
        os.close(fd)
        try:
            _ENCODER_OK = lib.ovt_mp3_encode(path.encode(), as_float_p(probe), len(probe), 22050, 1, 128) == 0
        finally:
            os.unlink(path)
    return _ENCODER_OK


# MPEG Layer III CBR bitrate tables (kbps).  The sample rate fixes the table:
# MPEG-1 at 32/44.1/48 kHz, MPEG-2(.5) below; lame clamps a request outside
# it (192 kbps at 22.05 kHz encodes at 160), so the clamp is explicit here.
_MPEG1_KBPS = (32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320)
_MPEG2_KBPS = (8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160)


def effective_kbps(sr: int, kbps: int) -> int:
    """The CBR bitrate lame uses for `sr`: the largest table entry ≤ the
    request (the table's minimum when the request is below it)."""
    if kbps <= 0:
        raise ValueError(f"kbps must be positive, got {kbps}")
    table = _MPEG1_KBPS if sr >= 32000 else _MPEG2_KBPS
    fits = [b for b in table if b <= kbps]
    return fits[-1] if fits else table[0]


def write_mp3(path: str, audio: np.ndarray, sr: int, kbps: int = 128) -> int:
    """Encode float32 samples ([T] mono or [T, C], values in [-1, 1]) to a
    CBR mp3 (lame quality 2, no resampling).  Returns the effective kbps."""
    lib = _load()
    eff = effective_kbps(int(sr), int(kbps))
    audio, frames, ch = frames_channels(audio)
    rc = lib.ovt_mp3_encode(path.encode(), as_float_p(audio), frames, int(sr), ch, eff)
    if rc < 0:
        raise ValueError(f"mp3 encode failed for {path} (code {rc})")
    return eff
