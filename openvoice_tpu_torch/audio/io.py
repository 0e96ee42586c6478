"""Host-side audio I/O (the port's copy of the WAV part of
``openvoice_tpu/audio/io.py``).

A pure-numpy RIFF/WAVE codec (PCM 8/16/24/32-bit and IEEE float) plus a
polyphase resampler.  All functions return float32 mono in [-1, 1] at the
requested rate, matching ``librosa.load(path, sr=...)`` semantics used
throughout the reference API.  `load_audio` decodes the other containers
through the native codecs, as the JAX package does: mp3 and Ogg/Vorbis over
the system mpg123 / libvorbisfile, FLAC with the in-repo decoder, and
m4a/aac/mp4/wma/webm/mka through ffmpeg (``audio/{mp3,ogg,flac,ffdec}.py``).
"""

from __future__ import annotations

import math
import os
import struct

import numpy as np
from scipy.signal import resample_poly


# ---------------------------------------------------------------------------
# WAV codec
# ---------------------------------------------------------------------------

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def wav_num_samples(path: str, target_sr: int | None = None) -> int:
    """Per-channel sample count from the WAV header alone (no decode).

    With target_sr, returns the length the file would have after
    load_audio(path, sr=target_sr) resampling (ceil, matching resample()).
    """
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        sr = n_ch = bits = None
        data_bytes = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[:4]
            (csz,) = struct.unpack("<I", hdr[4:])
            if cid == b"fmt ":
                body = f.read(csz + (csz & 1))
                _, n_ch, sr, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
            else:
                if cid == b"data":
                    data_bytes = csz
                f.seek(csz + (csz & 1), 1)
            if sr is not None and data_bytes is not None:
                break
    if sr is None or data_bytes is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    n = data_bytes // (n_ch * bits // 8)
    if target_sr is None or target_sr == sr:
        return n
    return -(-n * target_sr // sr)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file → (float32 samples [T] or [T, C], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (csz,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + csz]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + csz + (csz & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    wformat, n_ch, sr, _byte_rate, _block_align, bits = fmt
    if wformat == _WAVE_FORMAT_EXTENSIBLE:
        # true format tag = first 2 bytes of the SubFormat GUID (fmt body offset 24)
        if len(fmt_body) >= 26:
            wformat = struct.unpack_from("<H", fmt_body, 24)[0]
        else:
            wformat = _WAVE_FORMAT_PCM

    if wformat == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    elif wformat == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAVE format tag 0x{wformat:04x}")

    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch)
    return x, sr


def encode_wav_bytes(audio: np.ndarray, sr: int, subtype: str = "pcm16") -> bytes:
    """Mono/stereo float audio → complete WAV file bytes."""
    audio = np.asarray(audio)
    n_ch = 1 if audio.ndim == 1 else audio.shape[1]
    if subtype == "pcm16":
        clipped = np.clip(audio, -1.0, 1.0)
        payload = np.round(clipped * 32767.0).astype("<i2").tobytes()
        bits, wformat = 16, _WAVE_FORMAT_PCM
    elif subtype == "float32":
        payload = audio.astype("<f4").tobytes()
        bits, wformat = 32, _WAVE_FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"unsupported subtype {subtype}")
    byte_rate = sr * n_ch * bits // 8
    block_align = n_ch * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, wformat, n_ch, sr, byte_rate, block_align, bits)
    hdr += b"data" + struct.pack("<I", len(payload))
    return hdr + payload


def write_wav(path: str, audio: np.ndarray, sr: int, subtype: str = "pcm16") -> None:
    """Write mono/stereo float audio as WAV (default PCM16, soundfile's default)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_wav_bytes(audio, sr, subtype))


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------

def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample (kaiser-windowed), float32 in/out."""
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    out = resample_poly(audio.astype(np.float64), up, down)
    return out.astype(np.float32)


def load_audio(path: str, sr: int | None = None, mono: bool = True) -> tuple[np.ndarray, int]:
    """librosa.load-compatible entry: decode by extension (.mp3, .ogg/.oga,
    .flac, .m4a/.aac/.mp4/.wma/.webm/.mka; any other extension reads as WAV)
    → mono mixdown → resample."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mp3":
        from openvoice_tpu_torch.audio.mp3 import read_mp3 as read
    elif ext in (".ogg", ".oga"):
        from openvoice_tpu_torch.audio.ogg import read_ogg as read
    elif ext == ".flac":
        from openvoice_tpu_torch.audio.flac import read_flac as read
    elif ext in (".m4a", ".aac", ".mp4", ".wma", ".webm", ".mka"):
        from openvoice_tpu_torch.audio.ffdec import read_any as read
    else:
        read = read_wav
    audio, file_sr = read(path)
    if mono and audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sr is not None and sr != file_sr:
        audio = resample(audio, file_sr, sr)
        file_sr = sr
    return audio.astype(np.float32), file_sr
