"""K5: the magnitude STFT as hand-written CUDA kernels (``csrc/stft.cu``):
a four-step FFT with one warp per frame for n_fft in `FFT_SIZES` (512, 1024,
the size of every shipped configuration, and 2048), and a direct DFT for
every other n_fft (`route` says which).

Replaces ``openvoice_tpu/ops/stft_pallas.py::stft_magnitude_pallas`` and the
XLA basis product the JAX package takes for the sizes its Pallas kernel does
not (``openvoice_tpu/api.py::_spec_btf``).  The wrapper takes
pre-reflect-padded audio [B, L] and returns magnitudes
[B, frames, n_fft//2+1], all float32.  A CUDA tensor goes to a kernel; a CPU
tensor goes to the plain version
(`openvoice_tpu_torch.audio.stft.stft_magnitude_plain`).  Nothing falls back:
a failed build or launch raises, on either route.

``launches`` counts the launches of both kernels; it is raised where a
kernel is launched and nowhere else (`ops.count_launch`: a
launch recorded into a CUDA graph counts at each replay).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from openvoice_tpu_torch.audio.stft import stft_magnitude_plain, stft_window
from openvoice_tpu_torch.ops import count_launch, _nvcc

launches = 0

R1 = 32                        # R1 in csrc/stft.cu: a warp's lanes; n_fft = R1 · R2
FFT_SIZES = (512, 1024, 2048)  # the n_fft values the FFT has an instance for (R2 16, 32, 64)
DFT_BINS = 256                 # DFT_THREADS in csrc/stft.cu: bins a block
_GRID_MAX_YZ = 65535

_TABLES: dict[tuple, tuple] = {}


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("stft")
    lib.stft_magnitude_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.stft_magnitude_f32.restype = ctypes.c_int
    lib.stft_dft_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.stft_dft_f32.restype = ctypes.c_int
    return lib


def route(n_fft: int) -> str:
    """Which kernel computes `n_fft` on the card: "fft" for the sizes in
    `FFT_SIZES`, "dft" for every other."""
    return "fft" if n_fft in FFT_SIZES else "dft"


def fft_tables(n_fft: int, win: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """What the kernel's instance for `n_fft` = R1·R2 reads beside the audio,
    computed in float64 and rounded once to float32:

      window  [n_fft]          the window of `stft_basis`
      twiddle [R2, R1, 2]      (k2, n1) → exp(−2πi·n1·k2 / n_fft) as (re, im)
      roots   [2, M/2]         exp(−2πi·j / M), j < M/2, M = max(R1, R2): the
                               roots of both small FFTs, real then imaginary
    """
    if route(n_fft) != "fft":
        raise ValueError(f"the FFT has instances for n_fft in {FFT_SIZES}, not n_fft={n_fft}")
    r2 = n_fft // R1
    k2, n1 = np.meshgrid(np.arange(r2), np.arange(R1), indexing="ij")
    ang = -2.0 * np.pi * n1 * k2 / n_fft
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    m = max(R1, r2)
    j = -2.0 * np.pi * np.arange(m // 2) / m
    roots = np.stack([np.cos(j), np.sin(j)])
    return (stft_window(n_fft, win).astype(np.float32), twiddle.astype(np.float32),
            roots.astype(np.float32))


def dft_tables(n_fft: int, win: int) -> tuple[np.ndarray, np.ndarray]:
    """What the DFT kernel reads beside the audio, computed in float64 and
    rounded once to float32:

      window [n_fft]     the window of `stft_basis`
      table  [n_fft, 2]  j → exp(−2πi·j / n_fft) as (re, im); bin f takes
                         sample n's root at j = (n·f) mod n_fft
    """
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    table = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    return stft_window(n_fft, win).astype(np.float32), table.astype(np.float32)


def _device_tables(n_fft: int, win: int, device: torch.device) -> tuple:
    """The route's tables on `device` (the FFT's roots stay on the host: they
    are kernel parameters), made once per size."""
    key = (n_fft, win, device)
    tables = _TABLES.get(key)
    if tables is None:
        if route(n_fft) == "fft":
            window, twiddle, roots = fft_tables(n_fft, win)
            tables = (torch.from_numpy(window).to(device), torch.from_numpy(twiddle).to(device),
                      (ctypes.c_float * roots.size)(*roots.ravel().tolist()))
        else:
            tables = tuple(torch.from_numpy(a).to(device) for a in dft_tables(n_fft, win))
        _TABLES[key] = tables
    return tables


def stft_magnitude(padded_audio: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """[B, L] reflect-padded float32 audio → [B, (L - n_fft)//hop + 1,
    n_fft//2 + 1] float32 magnitudes sqrt(re² + im² + 1e-6)."""
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
    # the kernels take int sizes and offsets in 64 bits; the grid is (frame
    # groups, batch), for the DFT (frame groups, bin groups, batch)
    if length >= 2**31 or batch > _GRID_MAX_YZ or -(-(n_fft // 2 + 1) // DFT_BINS) > _GRID_MAX_YZ:
        raise ValueError(f"audio [{batch}, {length}] at n_fft={n_fft} exceeds the kernels' launch grid")
    device = padded_audio.device
    tables = _device_tables(n_fft, win, device)
    out = torch.empty((batch, frames, n_fft // 2 + 1), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _library()
    if route(n_fft) == "fft":
        window, twiddle, roots = tables
        err = lib.stft_magnitude_f32(
            padded_audio.data_ptr(), window.data_ptr(), twiddle.data_ptr(), ctypes.addressof(roots),
            out.data_ptr(), batch, length, frames, n_fft, hop, device.index or 0, stream,
        )
    else:
        window, table = tables
        err = lib.stft_dft_f32(padded_audio.data_ptr(), window.data_ptr(), table.data_ptr(), out.data_ptr(),
                               batch, length, frames, n_fft, hop, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"stft {route(n_fft)} kernel launch failed with CUDA error {err}")
    count_launch(__name__)
    return out
