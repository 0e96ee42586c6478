"""Decode of any format the system ffmpeg reads (m4a, aac, mp4, wma, webm,
mka, …) and AAC-in-m4a encode, through ``libovt_ffdec``
(``audio/native_src/ffdec.cc``), the port of ``openvoice_tpu/audio/ffdec.py``.

The library is built only where ffmpeg's headers and libraries are found
(`_native_build.ffmpeg_found`); elsewhere `available()` is False and
`read_any` raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from openvoice_tpu_torch.audio import _native_build
from openvoice_tpu_torch.audio.native import DECODE_ARGTYPES, as_float_p, decode_file, frames_channels

_LIB: ctypes.CDLL | None = None
# the library mallocs its buffers with the C allocator: free them through libc
_libc = ctypes.CDLL(None)
_libc.free.argtypes = [ctypes.c_void_p]


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _native_build.load("ovt_ffdec")
        if lib is None:
            raise RuntimeError("ffmpeg-backed codec not built (ffmpeg's avformat/avcodec/avutil/swresample "
                               "headers or libraries are absent); use wav/mp3/ogg/flac inputs instead")
        lib.ovt_ff_decode.restype = ctypes.c_int64
        lib.ovt_ff_decode.argtypes = DECODE_ARGTYPES
        lib.ovt_ff_encode_m4a.restype = ctypes.c_int
        lib.ovt_ff_encode_m4a.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def read_any(path: str) -> tuple[np.ndarray, int]:
    """Decode any ffmpeg-supported audio file → (float32 [T] or [T, C],
    sample_rate)."""
    return decode_file(_load().ovt_ff_decode, _libc.free, path, "ffmpeg")


def write_m4a(path: str, audio: np.ndarray, sr: int, kbps: int = 128) -> None:
    """Encode float32 samples ([T] mono or [T, C], values in [-1, 1]) as AAC
    in an mp4/m4a container (ffmpeg's native aac encoder)."""
    lib = _load()
    audio, frames, ch = frames_channels(audio)
    rc = lib.ovt_ff_encode_m4a(path.encode(), as_float_p(audio), frames, int(sr), ch, int(kbps))
    if rc < 0:
        raise ValueError(f"m4a encode failed for {path} (code {rc})")
