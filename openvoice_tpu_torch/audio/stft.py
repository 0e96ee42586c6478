"""Linear-magnitude spectrogram front end of the PyTorch port.

Reference semantics (mel_processing.py:40-75, `spectrogram_torch`):
reflect-pad ``(n_fft - hop)/2`` each side, periodic Hann window,
``center=False``, one-sided, magnitude ``sqrt(re² + im² + 1e-6)``.

The spectrogram is a framed product with a windowed real-DFT basis, as in the
JAX package (``openvoice_tpu/audio/stft.py``).  `stft_magnitude_plain` is
the plain PyTorch version of that product; on the GPU the same function runs
as the hand-written FFT or DFT kernel in ``openvoice_tpu_torch/csrc/stft.cu``,
reached through `openvoice_tpu_torch.ops.stft_cuda.stft_magnitude`.  All in
float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# samples a partial sum of the product takes: the plain version, like the DFT
# kernel (DFT_CHUNK in csrc/stft.cu), sums each bin a chunk at a time and adds
# the chunks' sums, which keeps a 4096-term f32 sum's rounding near a 256-term
# one's and inside the 1e-4 bar against float64 (chip_smoke.py prints both
# versions' distance from numpy float64 at each size)
SUM_CHUNK = 256


@lru_cache(maxsize=8)
def stft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT basis, shape [n_fft, 2 * (n_fft//2 + 1)].

    Column block 0 holds cos (real) rows, block 1 holds -sin (imag) rows so
    that ``frames @ basis`` yields [re | im] matching torch.stft's convention
    (X_k = sum_n x_n e^{-2πi kn/N}).  The Hann window is periodic and
    zero-padded centred to n_fft when win_length < n_fft, as torch.stft does.
    The returned array is shared between callers: do not write to it.
    """
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_freq)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * stft_window(n_fft, win_length)[:, None]
    return basis.astype(np.float32)


def stft_window(n_fft: int, win_length: int) -> np.ndarray:
    """The periodic Hann window of `stft_basis` in float64, [n_fft]:
    zero-padded and centred when win_length < n_fft."""
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    if win_length == n_fft:
        return win
    pad_l = (n_fft - win_length) // 2
    w = np.zeros(n_fft)
    w[pad_l : pad_l + win_length] = win
    return w


def _reflect_pad_1d(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``pad`` on both sides (torch 'reflect')."""
    if pad == 0:
        return y
    left = y[..., 1 : pad + 1].flip(-1)
    right = y[..., -pad - 1 : -1].flip(-1)
    return torch.cat([left, y, right], dim=-1)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[..., T] → [..., n_frames, n_fft] frames starting at multiples of hop
    (a strided view: no copy)."""
    return y.unfold(-1, n_fft, hop)


def stft_magnitude_plain(padded_audio: torch.Tensor, n_fft: int, hop: int,
                         win_length: int) -> torch.Tensor:
    """[B, L] pre-reflect-padded f32 audio → [B, n_frames, n_fft//2+1]
    magnitudes: frames @ windowed basis, summed `SUM_CHUNK` samples at a
    time, then sqrt(re² + im² + 1e-6)."""
    frames = frame_signal(padded_audio, n_fft, hop)
    basis = torch.from_numpy(stft_basis(n_fft, win_length)).to(padded_audio.device)
    proj = torch.matmul(frames[..., :SUM_CHUNK], basis[:SUM_CHUNK])
    for n0 in range(SUM_CHUNK, n_fft, SUM_CHUNK):
        proj = proj + torch.matmul(frames[..., n0:n0 + SUM_CHUNK], basis[n0:n0 + SUM_CHUNK])
    n_freq = n_fft // 2 + 1
    re, im = proj[..., :n_freq], proj[..., n_freq:]
    return torch.sqrt(re * re + im * im + 1e-6)


def host_spectrogram(padded_audio: np.ndarray, n_fft: int, hop: int,
                     win_length: int) -> np.ndarray:
    """Pure-numpy (float64 rfft) magnitude spectrogram of an ALREADY
    reflect-padded 1-D signal — same framing and `sqrt(|.|² + 1e-6)`
    semantics as the device path, computed independently of it."""
    win = np.hanning(win_length + 1)[:-1].astype(np.float64)
    if win_length < n_fft:
        pad_l = (n_fft - win_length) // 2
        win = np.pad(win, (pad_l, n_fft - win_length - pad_l))
    n_frames = (len(padded_audio) - n_fft) // hop + 1
    frames = np.lib.stride_tricks.sliding_window_view(
        np.asarray(padded_audio, np.float64), n_fft
    )[::hop][:n_frames]
    spec = np.fft.rfft(frames * win, axis=-1)
    return np.sqrt(np.abs(spec) ** 2 + 1e-6).astype(np.float32)


def reflect_frames_signal(audio: torch.Tensor, sample_lengths: torch.Tensor, n_fft: int,
                          hop: int) -> torch.Tensor:
    """Each row's reflect-padded signal, gathered on the device: audio
    [B, T] (zero beyond each row's ``sample_lengths[b]``, T a multiple of
    hop) → [B, (T//hop - 1)·hop + n_fft], whose frames at multiples of hop
    are the T//hop frames of `masked_linear_spectrogram`.

    Position p (in samples of the row, from -(n_fft-hop)/2) reads sample
    ``lm1 - |lm1 - |p||`` with ``lm1 = max(L-1, 1)``, clipped to [0, T-1]:
    torch's reflect pad for pads < L, and the JAX package's clamp for the
    degenerate rows (length 0, 1, or shorter than the pad).  The lengths
    stay on the device: one index gather, no host read."""
    b, t = audio.shape
    pad = (n_fft - hop) // 2
    n_frames = t // hop
    pos = torch.arange((n_frames - 1) * hop + n_fft, device=audio.device) - pad  # [L]
    lm1 = torch.clamp(sample_lengths.to(device=audio.device, dtype=torch.int64) - 1, min=1)[:, None]
    idx = torch.clamp(lm1 - (lm1 - pos.abs()[None, :]).abs(), 0, t - 1)  # [B, L]
    return torch.gather(audio.float(), 1, idx).contiguous()


def masked_linear_spectrogram(audio: torch.Tensor, sample_lengths: torch.Tensor, n_fft: int,
                              hop: int, win_length: int) -> torch.Tensor:
    """Per-row reflect-padded magnitude spectrogram of device-resident audio
    with per-row true lengths (the JAX package's ``masked_linear_spectrogram``):
    the in-graph counterpart of the host `_spec_from_audio` + STFT pair, for
    the fused TTS → convert chains, where each row's audio ends at another
    sample.

    audio [B, T] zero-padded beyond each row's ``sample_lengths[b]``, T a
    multiple of hop → [B, T//hop, n_fft//2+1] float32.  Frames past a row's
    true frame count are garbage and must be masked downstream (spec
    lengths), as in every padded-bucket consumer.  The magnitudes come from
    `openvoice_tpu_torch.ops.stft_cuda.stft_magnitude` on the gathered
    signal (`reflect_frames_signal`): the STFT kernel on a CUDA tensor, its
    plain version `stft_magnitude_plain` on a CPU one."""
    from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude  # here: stft_cuda imports this module

    signal = reflect_frames_signal(audio, sample_lengths, n_fft, hop)
    return stft_magnitude(signal, n_fft, hop, win_length)


def linear_spectrogram(y: torch.Tensor, n_fft: int = 1024, hop: int = 256, win_length: int = 1024,
                       pad_signal: bool = True) -> torch.Tensor:
    """Reference-semantics linear spectrogram (the JAX package's
    ``linear_spectrogram``): y [B, T] audio in [-1, 1] → [B, n_freq,
    n_frames] float32 magnitudes (the reference layout, enc_q's input).

    With `pad_signal` each row is reflect-padded by (n_fft − hop)/2 on both
    sides first.  The magnitudes come from
    `openvoice_tpu_torch.ops.stft_cuda.stft_magnitude`: the STFT kernel on a
    CUDA tensor, its plain version `stft_magnitude_plain` on a CPU one."""
    from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude  # here: stft_cuda imports this module

    y = y.float()
    if pad_signal:
        y = _reflect_pad_1d(y, (n_fft - hop) // 2)
    return stft_magnitude(y.contiguous(), n_fft, hop, win_length).transpose(1, 2)
