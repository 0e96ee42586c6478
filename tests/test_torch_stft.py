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
    """The FFT takes n_fft 512, 1024 and 2048 and refuses to make tables for
    any other size; the wrapper sends those to the DFT kernel, whose tables
    take any size, so that no n_fft raises."""
    for n_fft in (512, 1024, 2048):
        assert stft_cuda.route(n_fft) == "fft"
        stft_cuda.fft_tables(n_fft, n_fft)
    for n_fft in (2, 3, 256, 768, 1000, 4096, 1023):
        assert stft_cuda.route(n_fft) == "dft"
        with pytest.raises(ValueError, match=f"n_fft={n_fft}"):
            stft_cuda.fft_tables(n_fft, n_fft)
        window, table = stft_cuda.dft_tables(n_fft, n_fft)
        assert window.shape == (n_fft,) and table.shape == (n_fft, 2) and table.dtype == np.float32
    # on the CPU the wrapper is the plain version at any size
    assert stft_cuda.stft_magnitude(torch.zeros(1, 600), 256, 64, 256).shape == (1, 6, 129)
    assert stft_cuda.stft_magnitude(torch.zeros(1, 3000), 1000, 250, 1000).shape == (1, 9, 501)


def _dft(frames: np.ndarray, window: np.ndarray, table: np.ndarray, chunk: int) -> np.ndarray:
    """csrc/stft.cu's DFT kernel in numpy, in float32 on its float32 tables:
    bin f of sample n takes the root at the integer index (n·f) mod n_fft,
    and each bin is summed a chunk of samples at a time, each chunk's
    partial sum added to the total.  Returns the one-sided spectrum."""
    n_fft = window.shape[0]
    n, f = np.arange(n_fft)[:, None], np.arange(n_fft // 2 + 1)[None, :]
    roots = table[(n * f) % n_fft]                            # [n, f, 2], exact integer index
    x = (frames.astype(np.float32) * window).astype(np.float32)
    re = np.zeros((*frames.shape[:-1], f.shape[1]), np.float32)
    im = np.zeros_like(re)
    for n0 in range(0, n_fft, chunk):
        re += x[..., n0:n0 + chunk] @ roots[n0:n0 + chunk, :, 0]
        im += x[..., n0:n0 + chunk] @ roots[n0:n0 + chunk, :, 1]
    return re.astype(np.float64) + 1j * im


@pytest.mark.parametrize("n_fft,hop,pallas", [(768, 256, True), (256, 128, True), (1000, 250, False),
                                              (4096, 1024, False)], ids=["768", "256", "1000", "4096"])
def test_dft_tables_give_the_spectrum(n_fft, hop, pallas):
    """The DFT kernel's table and integer index, modelled in float32, give
    numpy.fft.rfft's magnitudes in float64, the plain version's and (where
    its hop divides n_fft into whole 128-sample chunks, or in interpret mode)
    the Pallas kernel's, at the 1e-4 bar."""
    window, table = stft_cuda.dft_tables(n_fft, n_fft)
    np.testing.assert_allclose(table[:, 0] + 1j * table[:, 1], np.exp(-2j * np.pi * np.arange(n_fft) / n_fft),
                               atol=6e-8, rtol=0)
    rng = np.random.default_rng(n_fft)
    x = (rng.standard_normal((2, 6 * n_fft)) * 0.3).astype(np.float32)
    padded = np.asarray(jstft._reflect_pad_1d(jnp.asarray(x), (n_fft - hop) // 2))
    frames = tstft.frame_signal(t(padded), n_fft, hop).numpy()
    model = np.sqrt(np.abs(_dft(frames, window, table, tstft.SUM_CHUNK)) ** 2 + 1e-6)
    rfft = np.sqrt(np.abs(np.fft.rfft(frames.astype(np.float64) * window, axis=-1)) ** 2 + 1e-6)
    plain = tstft.stft_magnitude_plain(t(padded), n_fft, hop, n_fft).numpy()
    np.testing.assert_allclose(model, rfft, atol=1e-4)
    np.testing.assert_allclose(model, plain, atol=1e-4)
    if pallas:
        ref = np.asarray(stft_magnitude_pallas(jnp.asarray(padded), n_fft, hop, n_fft, interpret=True))
        np.testing.assert_allclose(model, ref, atol=1e-4)


@pytest.mark.cuda
def test_n_fft_768_on_the_card():
    """A size without an FFT instance goes to the DFT kernel on the card,
    launches it once and agrees with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = (torch.randn(1, 40_000, generator=torch.Generator().manual_seed(768)) * 0.3).cuda()
    before = stft_cuda.launches
    out = stft_cuda.stft_magnitude(x, 768, 256, 768)
    assert stft_cuda.launches == before + 1
    ref = tstft.stft_magnitude_plain(x, 768, 256, 768)
    assert float((out - ref).abs().max()) <= 1e-4
