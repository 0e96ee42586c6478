"""Ogg/Vorbis decode/encode through the native codec (``native/src/vorbis.cc``
over the dlopen'd system libvorbisfile / libogg + libvorbis + libvorbisenc),
the port of ``openvoice_tpu/audio/ogg.py``."""

from __future__ import annotations

import ctypes
import os
import tempfile

import numpy as np

from openvoice_tpu_torch.audio.native import _load, as_float_p, decode_file, frames_channels

_AVAILABLE: bool | None = None


def available() -> bool:
    """True when the system vorbis libraries resolve (probed with a tiny
    encode, then a decode: libvorbisfile is packaged apart from the
    encoder's libraries)."""
    global _AVAILABLE
    if _AVAILABLE is None:
        lib = _load()
        probe = np.zeros(2048, np.float32)
        fd, path = tempfile.mkstemp(suffix=".ogg")
        os.close(fd)
        try:
            if lib.ovt_ogg_encode(path.encode(), as_float_p(probe), len(probe), 22050, 1, ctypes.c_float(0.4)) == 0:
                arr, sr = read_ogg(path)
                _AVAILABLE = sr == 22050 and len(arr) == len(probe)
            else:
                _AVAILABLE = False
        except ValueError:
            _AVAILABLE = False
        finally:
            os.unlink(path)
    return _AVAILABLE


def read_ogg(path: str) -> tuple[np.ndarray, int]:
    """Decode an Ogg/Vorbis file → (float32 samples [T] or [T, C], rate)."""
    lib = _load()
    return decode_file(lib.ovt_ogg_decode, lib.ovt_free, path, "ogg")


def write_ogg(path: str, audio: np.ndarray, sr: int, quality: float = 0.4) -> None:
    """Encode float32 samples ([T] mono or [T, C], values in [-1, 1]) to
    Ogg/Vorbis at VBR `quality` in [-0.1, 1.0] (0.4 ≈ 128 kbps stereo)."""
    lib = _load()
    audio, frames, ch = frames_channels(audio)
    rc = lib.ovt_ogg_encode(path.encode(), as_float_p(audio), frames, int(sr), ch, ctypes.c_float(quality))
    if rc < 0:
        raise ValueError(f"ogg encode failed for {path} (code {rc})")
