"""ctypes bindings for the native audio runtime ``libovt_audio`` (the port of
``openvoice_tpu/audio/native.py``): WAV read/write, the polyphase resampler,
the energy VAD and the threaded prefetch loader.

The library is the port's own build of ``audio/native_src`` (`_native_build`),
made at first use; the Python implementations in ``audio/io.py`` and
``pipeline/se_extractor.py`` stay the reference semantics.  The decode
helpers here are shared by the codec bindings (``mp3``, ``ogg``, ``flac``,
``ffdec``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from openvoice_tpu_torch.audio import _native_build

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
# (path, float** out, int* sample_rate, int* channels) → frames or error
DECODE_ARGTYPES = [ctypes.c_char_p, ctypes.POINTER(_FLOAT_P), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]

_LIB: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    """``libovt_audio`` with every entry point's signature declared (built
    at first use; a failed build raises)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _native_build.load("ovt_audio")
    lib.ovt_free.argtypes = [ctypes.c_void_p]
    lib.ovt_wav_read.restype = ctypes.c_int64
    lib.ovt_wav_read.argtypes = DECODE_ARGTYPES
    lib.ovt_wav_write.restype = ctypes.c_int64
    lib.ovt_wav_write.argtypes = [ctypes.c_char_p, _FLOAT_P, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    for codec in ("mp3", "ogg", "flac"):
        fn = getattr(lib, f"ovt_{codec}_decode")
        fn.restype = ctypes.c_int64
        fn.argtypes = DECODE_ARGTYPES
        getattr(lib, f"ovt_{codec}_encode").restype = ctypes.c_int
    lib.ovt_mp3_encode.argtypes = [ctypes.c_char_p, _FLOAT_P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int]
    lib.ovt_ogg_encode.argtypes = [ctypes.c_char_p, _FLOAT_P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float]
    lib.ovt_flac_encode.argtypes = [ctypes.c_char_p, _FLOAT_P, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.ovt_resample.restype = ctypes.c_int64
    lib.ovt_resample.argtypes = [_FLOAT_P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_FLOAT_P)]
    lib.ovt_energy_vad.restype = ctypes.c_int64
    lib.ovt_energy_vad.argtypes = [_FLOAT_P, ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                   ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.ovt_loader_create.restype = ctypes.c_void_p
    lib.ovt_loader_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ovt_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.ovt_loader_submit.restype = ctypes.c_int64
    lib.ovt_loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ovt_loader_next.restype = ctypes.c_int64
    lib.ovt_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_FLOAT_P), ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int64)]
    _LIB = lib
    return lib


def available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    return _load() is not None


def _take(free, buf, count: int) -> np.ndarray:
    try:
        return np.ctypeslib.as_array(buf, shape=(count,)).copy()
    finally:
        free(ctypes.cast(buf, ctypes.c_void_p))


def as_float_p(audio: np.ndarray):
    return audio.ctypes.data_as(_FLOAT_P)


def decode_file(fn, free, path: str, what: str) -> tuple[np.ndarray, int]:
    """Call a ``(path, &buf, &sr, &channels)`` decoder → (float32 samples
    [T] or [T, C], sample_rate); a negative return raises ValueError."""
    buf = _FLOAT_P()
    sr = ctypes.c_int(0)
    n_ch = ctypes.c_int(0)
    n = fn(path.encode(), ctypes.byref(buf), ctypes.byref(sr), ctypes.byref(n_ch))
    if n < 0:
        raise ValueError(f"{what} decode failed for {path} (code {n})")
    arr = _take(free, buf, int(n) * max(1, n_ch.value))
    if n_ch.value > 1:
        arr = arr.reshape(-1, n_ch.value)
    return arr.astype(np.float32), sr.value


def frames_channels(audio: np.ndarray) -> tuple[np.ndarray, int, int]:
    """Contiguous float32 samples, their frame count and channel count."""
    audio = np.ascontiguousarray(audio, np.float32)
    return audio, audio.shape[0], 1 if audio.ndim == 1 else int(audio.shape[1])


def wav_read(path: str) -> tuple[np.ndarray, int]:
    lib = _load()
    return decode_file(lib.ovt_wav_read, lib.ovt_free, path, "native wav")


def wav_write(path: str, audio: np.ndarray, sr: int) -> None:
    lib = _load()
    audio, frames, ch = frames_channels(audio)
    rc = lib.ovt_wav_write(path.encode(), as_float_p(audio), frames, sr, ch)
    if rc < 0:
        raise ValueError(f"native wav write failed ({rc}) for {path}")


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    lib = _load()
    audio = np.ascontiguousarray(audio, np.float32)
    buf = _FLOAT_P()
    n = lib.ovt_resample(as_float_p(audio), len(audio), sr_in, sr_out, ctypes.byref(buf))
    if n < 0:
        raise ValueError(f"native resample failed ({n})")
    return _take(lib.ovt_free, buf, int(n))


def energy_vad(audio: np.ndarray, sr: int, frame_ms: float = 30.0, min_speech_s: float = 0.1,
               min_silence_s: float = 1.0, threshold_db: float = -40.0,
               max_segments: int = 4096) -> list[tuple[int, int]]:
    lib = _load()
    audio = np.ascontiguousarray(audio, np.float32)
    seg = (ctypes.c_int64 * (2 * max_segments))()
    n = lib.ovt_energy_vad(as_float_p(audio), len(audio), sr, frame_ms, min_speech_s, min_silence_s,
                           threshold_db, seg, max_segments)
    return [(int(seg[2 * i]), int(seg[2 * i + 1])) for i in range(int(n))]


class PrefetchLoader:
    """Threaded decode + resample pipeline delivering clips in submit order."""

    def __init__(self, n_threads: int = 2, target_sr: int = 22050, capacity: int = 16):
        self._lib = _load()
        self._handle = self._lib.ovt_loader_create(n_threads, target_sr, capacity)
        self._submitted = 0
        self._delivered = 0

    def submit(self, path: str) -> int:
        t = self._lib.ovt_loader_submit(self._handle, path.encode())
        if t < 0:
            raise RuntimeError("loader is shutting down")
        self._submitted += 1
        return int(t)

    def next(self) -> tuple[int, np.ndarray | None]:
        """(ticket, clip) in submission order; clip=None on a decode error."""
        if self._delivered >= self._submitted:
            raise IndexError("no pending clips")
        buf = _FLOAT_P()
        n = ctypes.c_int64(0)
        ticket = ctypes.c_int64(0)
        rc = self._lib.ovt_loader_next(self._handle, ctypes.byref(buf), ctypes.byref(n), ctypes.byref(ticket))
        self._delivered += 1
        if rc == -2:
            return int(ticket.value), None
        return int(rc), _take(self._lib.ovt_free, buf, int(n.value))

    def close(self) -> None:
        if self._handle:
            self._lib.ovt_loader_destroy(self._handle)
            self._handle = None
