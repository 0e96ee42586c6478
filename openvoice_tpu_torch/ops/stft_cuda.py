"""K5: the magnitude STFT as a hand-written CUDA kernel (``csrc/stft.cu``).

Replaces ``openvoice_tpu/ops/stft_pallas.py::stft_magnitude_pallas``.  The
wrapper takes pre-reflect-padded audio [B, L] and returns magnitudes
[B, frames, n_fft//2+1], all float32.  A CUDA tensor goes to the kernel; a
CPU tensor goes to the plain version
(`openvoice_tpu_torch.audio.stft.stft_magnitude_plain`).  Nothing falls back:
a failed build or launch raises.

``launches`` counts the kernel's launches; it is raised where the kernel is
launched and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from openvoice_tpu_torch.audio.stft import stft_basis, stft_magnitude_plain
from openvoice_tpu_torch.ops import _nvcc

launches = 0

_BASIS: dict[tuple[int, int, torch.device], torch.Tensor] = {}
_FRAMES_PER_BLOCK = 64  # BM in csrc/stft.cu
_GRID_MAX_YZ = 65535


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("stft")
    fn = lib.stft_magnitude_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib


def _device_basis(n_fft: int, win: int, device: torch.device) -> torch.Tensor:
    key = (n_fft, win, device)
    basis = _BASIS.get(key)
    if basis is None:
        basis = torch.from_numpy(stft_basis(n_fft, win)).to(device)
        _BASIS[key] = basis
    return basis


def stft_magnitude(padded_audio: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """[B, L] reflect-padded float32 audio → [B, (L - n_fft)//hop + 1,
    n_fft//2 + 1] float32 magnitudes sqrt(re² + im² + 1e-6)."""
    global launches
    if padded_audio.dim() != 2:
        raise ValueError(f"stft_magnitude takes [B, L] audio, got shape {tuple(padded_audio.shape)}")
    if padded_audio.dtype != torch.float32:
        raise TypeError(f"stft_magnitude takes float32 audio, got {padded_audio.dtype}")
    if not padded_audio.is_contiguous():
        raise ValueError("stft_magnitude takes contiguous audio")
    if not 0 < win <= n_fft or hop <= 0:
        raise ValueError(f"bad STFT sizes n_fft={n_fft} hop={hop} win={win}")
    batch, length = padded_audio.shape
    if length < n_fft or batch == 0:
        raise ValueError(f"audio [{batch}, {length}] holds no {n_fft}-sample frame")
    if padded_audio.device.type == "cpu":
        return stft_magnitude_plain(padded_audio, n_fft, hop, win)
    if padded_audio.device.type != "cuda":
        raise ValueError(f"stft_magnitude runs on cuda or cpu, not {padded_audio.device}")

    frames = (length - n_fft) // hop + 1
    n_freq = n_fft // 2 + 1
    # the kernel takes int sizes and offsets in 64 bits; the grid is
    # (bin tiles, frame tiles, batch)
    if length >= 2**31 or batch > _GRID_MAX_YZ or frames > _FRAMES_PER_BLOCK * _GRID_MAX_YZ:
        raise ValueError(f"audio [{batch}, {length}] exceeds the kernel's launch grid")
    device = padded_audio.device
    basis = _device_basis(n_fft, win, device)
    out = torch.empty((batch, frames, n_freq), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().stft_magnitude_f32(
        padded_audio.data_ptr(), basis.data_ptr(), out.data_ptr(),
        batch, length, frames, n_fft, hop, n_freq, device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"stft kernel launch failed with CUDA error {err}")
    launches += 1
    return out
