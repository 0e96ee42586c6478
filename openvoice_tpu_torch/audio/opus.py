"""Raw Opus encode/decode through the system libopus over ctypes (the port of
``openvoice_tpu/audio/opus.py``).

libopus has no container layer, so `opus_roundtrip` passes raw packets in
memory, as a transport stack does.  Opus takes 8/12/16/24/48 kHz only, so a
22.05 kHz clip is resampled to 24 kHz first and back after the decode; a
measurement through `opus_roundtrip` includes that pair.
"""

from __future__ import annotations

import ctypes

import numpy as np

from openvoice_tpu_torch.audio.io import resample

_LIB: ctypes.CDLL | None = None
_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE_REQUEST = 4002
_NATIVE_RATES = (8000, 12000, 16000, 24000, 48000)


def _load() -> ctypes.CDLL | None:
    global _LIB
    if _LIB is not None:
        return _LIB
    for name in ("libopus.so.0", "libopus.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.opus_encoder_create.restype = ctypes.c_void_p
        lib.opus_encoder_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.opus_encoder_ctl.restype = ctypes.c_int
        # variadic: the fixed arguments are declared so the handle keeps its
        # 64 bits; the one variadic argument (the bitrate) passes as an int
        lib.opus_encoder_ctl.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.opus_encode_float.restype = ctypes.c_int
        lib.opus_encode_float.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
        lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
        lib.opus_decoder_create.restype = ctypes.c_void_p
        lib.opus_decoder_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.opus_decode_float.restype = ctypes.c_int
        lib.opus_decode_float.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
        lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib
    return None


def available() -> bool:
    return _load() is not None


def opus_roundtrip(audio: np.ndarray, sr: int, kbps: int = 32) -> np.ndarray:
    """Mono float32 waveform → Opus packets (20 ms frames at `kbps`) →
    decode, at the input rate and trimmed to the input length (with the
    sr ↔ 24 kHz resample pair where sr is not an Opus rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libopus not available on this system")
    audio = np.ascontiguousarray(audio, np.float32)
    n_in = len(audio)
    opus_sr = sr if sr in _NATIVE_RATES else 24000
    work = np.ascontiguousarray(resample(audio, sr, opus_sr), np.float32) if opus_sr != sr else audio

    err = ctypes.c_int(0)
    enc = lib.opus_encoder_create(opus_sr, 1, _OPUS_APPLICATION_AUDIO, ctypes.byref(err))
    if not enc or err.value != 0:
        raise RuntimeError(f"opus_encoder_create failed ({err.value})")
    dec = lib.opus_decoder_create(opus_sr, 1, ctypes.byref(err))
    if not dec or err.value != 0:
        lib.opus_encoder_destroy(enc)
        raise RuntimeError(f"opus_decoder_create failed ({err.value})")
    try:
        rc = lib.opus_encoder_ctl(enc, _OPUS_SET_BITRATE_REQUEST, kbps * 1000)
        if rc != 0:
            # ignored, every measurement at `kbps` would measure the default
            raise RuntimeError(f"OPUS_SET_BITRATE({kbps} kbps) failed ({rc})")
        frame = opus_sr // 50  # 20 ms
        n_frames = (len(work) + frame - 1) // frame
        padded = np.zeros(n_frames * frame, np.float32)
        padded[: len(work)] = work
        packet = (ctypes.c_ubyte * 4000)()
        out = np.zeros_like(padded)
        pcm_out = (ctypes.c_float * frame)()
        for i in range(n_frames):
            chunk = padded[i * frame : (i + 1) * frame]
            nb = lib.opus_encode_float(enc, chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frame,
                                       packet, len(packet))
            if nb < 0:
                raise RuntimeError(f"opus_encode_float failed ({nb})")
            nd = lib.opus_decode_float(dec, packet, nb, pcm_out, frame, 0)
            if nd != frame:
                raise RuntimeError(f"opus_decode_float returned {nd}, wanted {frame}")
            out[i * frame : (i + 1) * frame] = np.frombuffer(pcm_out, np.float32)
        out = out[: len(work)]
    finally:
        lib.opus_encoder_destroy(enc)
        lib.opus_decoder_destroy(dec)
    if opus_sr != sr:
        out = np.ascontiguousarray(resample(out, opus_sr, sr), np.float32)
    return out[:n_in]
