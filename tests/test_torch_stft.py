"""The port's STFT front end against the JAX package's: the plain magnitude
STFT against the Pallas kernel (interpret mode) and the XLA spectrogram, the
host spectrogram, the reflect pad, and the K5 wrapper's contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu.audio import stft as jstft
from openvoice_tpu.ops.stft_pallas import stft_magnitude_pallas
from openvoice_tpu_torch.audio import stft as tstft
from openvoice_tpu_torch.ops import stft_cuda
from tests._torch_port import t


def _padded(x: np.ndarray) -> np.ndarray:
    return np.asarray(jstft._reflect_pad_1d(jnp.asarray(x), (1024 - 256) // 2))


@pytest.mark.parametrize("t_samples,win,batch", [(5000, 1024, 2), (40961, 1024, 2), (9000, 800, 1)])
def test_plain_stft_matches_pallas_and_xla(t_samples, win, batch):
    rng = np.random.default_rng(t_samples)
    x = (rng.standard_normal((batch, t_samples)) * 0.3).astype(np.float32)
    padded = _padded(x)
    ref_xla = np.asarray(jstft.linear_spectrogram(jnp.asarray(x), 1024, 256, win)).transpose(0, 2, 1)
    ref_pallas = np.asarray(stft_magnitude_pallas(jnp.asarray(padded), 1024, 256, win, interpret=True))
    out = tstft.stft_magnitude_plain(t(padded), 1024, 256, win).numpy()
    assert out.shape == ref_xla.shape == ref_pallas.shape
    np.testing.assert_allclose(out, ref_pallas, atol=1e-4)
    np.testing.assert_allclose(out, ref_xla, atol=1e-4)
    # on a CPU tensor the K5 wrapper is the plain version, launching nothing
    before = stft_cuda.launches
    np.testing.assert_array_equal(stft_cuda.stft_magnitude(t(padded), 1024, 256, win).numpy(), out)
    assert stft_cuda.launches == before


@pytest.mark.parametrize("win", [1024, 800])
def test_basis_host_spectrogram_and_pad_match_jax(win):
    np.testing.assert_array_equal(tstft.stft_basis(1024, win), jstft.stft_basis(1024, win))
    x = (np.random.default_rng(win).standard_normal((2, 3000)) * 0.3).astype(np.float32)
    padded = _padded(x)
    np.testing.assert_array_equal(tstft._reflect_pad_1d(t(x), 384).numpy(), padded)
    np.testing.assert_allclose(
        tstft.host_spectrogram(padded[0], 1024, 256, win),
        jstft.host_spectrogram(padded[0], 1024, 256, win), atol=1e-6)
    np.testing.assert_allclose(
        tstft.host_spectrogram(padded[0], 1024, 256, win),
        tstft.stft_magnitude_plain(t(padded), 1024, 256, win)[0].numpy(), atol=1e-4)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(3000), ValueError),                        # not [B, L]
    (torch.zeros(1, 3000, dtype=torch.float64), TypeError),  # not float32
    (torch.zeros(3000, 2).t(), ValueError),                 # not contiguous
    (torch.zeros(1, 500), ValueError),                      # shorter than a frame
])
def test_stft_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        stft_cuda.stft_magnitude(bad, 1024, 256, 1024)



def _four_step(frames: np.ndarray, window: np.ndarray, twiddle: np.ndarray, roots: np.ndarray) -> np.ndarray:
    """csrc/stft.cu's algorithm in numpy on its float32 tables, for
    n_fft = R1·R2: n = n1 + R1·n2, an R2-point DFT over n2, the per-lane
    twiddles, an R1-point DFT over n1; bin f = k2 + R2·k1.  Returns the
    one-sided spectrum [..., n_fft/2 + 1]."""
    r2, r1 = twiddle.shape[:2]
    m = 2 * roots.shape[1]
    w = roots[0].astype(np.float64) + 1j * roots[1]
    w_full = np.concatenate([w, -w])                       # W_M^j for j = 0..M-1

    def dft(r):                                            # [k, n] → W_r^(k·n) = W_M^(k·n·M/r)
        return w_full[(np.arange(r)[:, None] * np.arange(r)[None, :] * (m // r)) % m]

    x = (frames * window).reshape(*frames.shape[:-1], r2, r1)  # [..., n2, n1]
    y = np.einsum("kn,...nm->...km", dft(r2), x)           # [..., k2, n1]
    z = y * (twiddle[..., 0] + 1j * twiddle[..., 1])        # twiddle is [k2, n1]
    big = np.einsum("kn,...jn->...kj", dft(r1), z)         # [..., k1, k2]
    return big.reshape(*frames.shape[:-1], r1 * r2)[..., : r1 * r2 // 2 + 1]


@pytest.mark.parametrize("n_fft,win", [(1024, 1024), (1024, 800), (512, 512), (512, 400), (2048, 2048),
                                       (2048, 1600)],
                         ids=["1024", "800", "n512", "n512-w400", "n2048", "n2048-w1600"])
def test_fft_tables_give_the_spectrum(n_fft, win):
    """The tables the K5 wrapper hands the kernel's instance for n_fft,
    against numpy in float64: the window is `stft_basis`'s, the twiddles are
    the roots of unity, and the windowed frames give the plain version's and
    the Pallas kernel's magnitudes through numpy.fft.rfft and through the
    kernel's four steps."""
    r1, r2 = 32, n_fft // 32
    hop = n_fft // 4
    window, twiddle, roots = stft_cuda.fft_tables(n_fft, win)
    assert window.dtype == twiddle.dtype == roots.dtype == np.float32
    m = max(r1, r2)
    assert window.shape == (n_fft,) and twiddle.shape == (r2, r1, 2) and roots.shape == (2, m // 2)
    ref_window = np.hanning(win + 1)[:-1]
    ref_window = np.pad(ref_window, ((n_fft - win) // 2, n_fft - win - (n_fft - win) // 2))
    np.testing.assert_allclose(window, ref_window, atol=6e-8, rtol=0)
    k2, n1 = np.meshgrid(np.arange(r2), np.arange(r1), indexing="ij")
    ref_twiddle = np.exp(-2j * np.pi * n1 * k2 / n_fft)
    np.testing.assert_allclose(twiddle[..., 0] + 1j * twiddle[..., 1], ref_twiddle, atol=6e-8, rtol=0)
    np.testing.assert_allclose(roots[0] + 1j * roots[1], np.exp(-2j * np.pi * np.arange(m // 2) / m),
                               atol=6e-8, rtol=0)

    rng = np.random.default_rng(win + n_fft)
    x = (rng.standard_normal((2, 7000)) * 0.3).astype(np.float32)
    padded = np.asarray(jstft._reflect_pad_1d(jnp.asarray(x), (n_fft - hop) // 2))
    frames = tstft.frame_signal(t(padded), n_fft, hop).numpy().astype(np.float64)
    plain = tstft.stft_magnitude_plain(t(padded), n_fft, hop, win).numpy()
    pallas = np.asarray(stft_magnitude_pallas(jnp.asarray(padded), n_fft, hop, win, interpret=True))
    for spec in (np.fft.rfft(frames * window, axis=-1), _four_step(frames, window, twiddle, roots)):
        mag = np.sqrt(np.abs(spec) ** 2 + 1e-6)
        np.testing.assert_allclose(mag, plain, atol=1e-4)
        np.testing.assert_allclose(mag, pallas, atol=1e-4)


def test_fft_sizes_outside_the_kernel_are_refused():
    for n_fft in (1000, 768, 4096):
        with pytest.raises(ValueError, match=f"n_fft={n_fft}"):
            stft_cuda.check_fft_size(n_fft)
        with pytest.raises(ValueError, match=f"n_fft={n_fft}"):
            stft_cuda.fft_tables(n_fft, n_fft)
    for n_fft in (512, 1024, 2048):
        stft_cuda.check_fft_size(n_fft)
    # on the CPU the plain version takes any size, as the tiny configurations need
    assert stft_cuda.stft_magnitude(torch.zeros(1, 600), 256, 64, 256).shape == (1, 6, 129)


@pytest.mark.cuda
def test_unsupported_n_fft_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = stft_cuda.launches
    with pytest.raises(ValueError, match="n_fft=768"):
        stft_cuda.stft_magnitude(torch.zeros(1, 4096, device="cuda"), 768, 256, 768)
    assert stft_cuda.launches == before
