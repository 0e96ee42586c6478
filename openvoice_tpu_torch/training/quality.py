"""Cloning-quality metrics (the port of ``openvoice_tpu/training/quality.py``):
SE-cosine speaker similarity and mel-cepstral distortion.

* **SE cosine**: converted audio re-embedded through the model's OWN
  reference encoder (``ToneColorConverter._se_from_audio_batch``: the STFT
  kernel on the card, then ref_enc) against the target speaker embedding.
* **MCD**: frame-aligned mel-cepstral distortion between two waveforms
  (conversion keeps content frame for frame, so no DTW): the classic
  10/ln10·√2·‖Δc‖ over cepstra 1..D (c0, the energy, excluded).

The spectrogram of `mel_cepstra` is `audio.stft.linear_spectrogram`: the
STFT kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from openvoice_tpu_torch.api import resolve_device
from openvoice_tpu_torch.audio.mel import mel_filterbank
from openvoice_tpu_torch.audio.stft import linear_spectrogram


def _dct_ii_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II basis [n_out, n_in]."""
    k = np.arange(n_out)[:, None]
    i = np.arange(n_in)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n_in))
    m *= np.sqrt(2.0 / n_in)
    m[0] *= np.sqrt(0.5)
    return m.astype(np.float64)


def mel_cepstra(audio: np.ndarray, sr: int, *, n_fft: int = 1024, hop: int = 256, n_mels: int = 80,
                n_mcc: int = 13, device: str | torch.device | None = None) -> np.ndarray:
    """[T] waveform → [frames, n_mcc] mel-cepstra (c0 included at col 0).
    `device` as in `api.resolve_device`: the card unless the caller asks
    for the CPU."""
    y = torch.from_numpy(np.ascontiguousarray(audio, np.float32))[None].to(resolve_device(device))
    spec = linear_spectrogram(y, n_fft, hop, n_fft)[0].cpu().numpy()  # [n_freq, frames]
    fb = mel_filterbank(sr, n_fft, n_mels, 0.0, None)
    logmel = np.log(np.clip(fb @ spec, 1e-5, None))  # [n_mels, frames]
    return (_dct_ii_matrix(n_mels, n_mcc) @ logmel).T  # [frames, n_mcc]


def mcd(a: np.ndarray, b: np.ndarray, sr: int, **kw) -> float:
    """Frame-aligned mel-cepstral distortion in dB between waveforms
    (trailing length mismatch is truncated; c0 excluded per convention).
    `kw` goes to `mel_cepstra`, `device` included."""
    ca = mel_cepstra(a, sr, **kw)
    cb = mel_cepstra(b, sr, **kw)
    n = min(len(ca), len(cb))
    if n == 0:
        raise ValueError("audio too short for one analysis frame")
    d = ca[:n, 1:] - cb[:n, 1:]
    per_frame = np.sqrt(2.0 * np.sum(d * d, axis=1))
    return float((10.0 / np.log(10.0)) * per_frame.mean())


def se_cosine(converter, audio: np.ndarray, target_se: np.ndarray) -> float:
    """Cosine similarity between `audio`'s tone-colour embedding (through
    the converter's own reference encoder, on its device) and a target SE.
    `converter` is an ``api.ToneColorConverter`` with any weights: the
    metric is relative to that model's embedding space."""
    se = converter._se_from_audio_batch([np.asarray(audio, np.float32)])
    return cosine(se, target_se)


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(a @ b / (na * nb))
