"""Mel filterbank and mel spectrogram (librosa-Slaney compatible; the
port's copy of ``openvoice_tpu/audio/mel.py``).

The reference builds its mel basis with ``librosa.filters.mel`` and applies it
as a product followed by log dynamic-range compression
(mel_processing.py:122-133).  The Slaney-scale filterbank is computed once in
numpy (Slaney mel scale, slaney area normalisation); the product and the log
run in float32 on the tensor's device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=8)
def mel_filterbank(sampling_rate: int, n_fft: int, num_mels: int, fmin: float,
                   fmax: float | None) -> np.ndarray:
    """[num_mels, n_fft//2+1] Slaney-normalised triangular filterbank.  The
    returned array is shared between callers: do not write to it."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, n_freq)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), num_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : num_mels + 2] - mel_pts[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def spec_to_mel(spec: torch.Tensor, sampling_rate: int, n_fft: int, num_mels: int = 80,
                fmin: float = 0.0, fmax: float | None = None) -> torch.Tensor:
    """[B, n_freq, T] linear magnitudes → [B, num_mels, T] log-mels, with the
    reference's compression log(clamp(x, 1e-5)) (mel_processing.py:8-14)."""
    basis = torch.from_numpy(mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)).to(spec.device)
    mel = torch.matmul(basis, spec.float())
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int, hop: int,
                    win_length: int, fmin: float = 0.0, fmax: float | None = None) -> torch.Tensor:
    """Audio [B, T] → log-mels [B, num_mels, frames] (mel_processing.py:136-183):
    `audio.stft.linear_spectrogram` (the STFT kernel on a CUDA tensor), then
    `spec_to_mel`."""
    from openvoice_tpu_torch.audio.stft import linear_spectrogram

    spec = linear_spectrogram(y, n_fft, hop, win_length)
    return spec_to_mel(spec, sampling_rate, n_fft, num_mels, fmin, fmax)
