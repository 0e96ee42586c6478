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

