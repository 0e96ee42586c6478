"""The port's cloning-quality metrics (``openvoice_tpu_torch/training/
quality.py``) against the JAX package's (``openvoice_tpu/training/
quality.py``) on the CPU: mel-cepstra, MCD and SE-cosine within 1e-4, and
the JAX suite's behaviour tests of the metrics (tests/test_quality.py)."""

import numpy as np
import pytest

from openvoice_tpu.api import ToneColorConverter as JaxConverter
from openvoice_tpu.training import quality as JQ
from openvoice_tpu_torch.api import ToneColorConverter
from openvoice_tpu_torch.ckpt.from_jax import synthesizer_from_jax
from openvoice_tpu_torch.training import quality as TQ
from tests._torch_port import TINY_API, jax_cfg, jax_params, torch_cfg

SR = 22050


def _clip(freq: float, seconds: float = 1.5, noise: float = 0.0, seed: int = 0) -> np.ndarray:
    tt = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * freq * tt)
    if noise:
        x = x + noise * np.random.default_rng(seed).standard_normal(len(tt))
    return np.clip(x, -1, 1).astype(np.float32)


def _mcd(a, b, **kw) -> float:
    return TQ.mcd(a, b, SR, device="cpu", **kw)


@pytest.mark.parametrize("n_fft,hop,n_mcc", [(1024, 256, 13), (512, 128, 20)])
def test_mel_cepstra_match_jax(n_fft, hop, n_mcc):
    x = _clip(220, noise=0.05, seed=1)
    got = TQ.mel_cepstra(x, SR, n_fft=n_fft, hop=hop, n_mcc=n_mcc, device="cpu")
    ref = JQ.mel_cepstra(x, SR, n_fft=n_fft, hop=hop, n_mcc=n_mcc)
    assert got.shape == ref.shape and got.shape[1] == n_mcc
    np.testing.assert_allclose(got, ref, atol=1e-4 * float(np.abs(ref).max()), rtol=1e-4)


@pytest.mark.parametrize("other", ["speaker", "noise"])
def test_mcd_matches_jax(other):
    a = _clip(220, noise=0.02)
    b = _clip(520, noise=0.02, seed=3) if other == "speaker" else np.clip(
        a + 0.01 * np.random.default_rng(1).standard_normal(len(a)).astype(np.float32), -1, 1)
    np.testing.assert_allclose(_mcd(a, b), JQ.mcd(a, b, SR), rtol=1e-4)


@pytest.fixture(scope="module")
def converters():
    params = jax_params(TINY_API, seed=12)
    jconv = JaxConverter(cfg=jax_cfg(TINY_API), enable_watermark=False)
    jconv.params = params
    tconv = ToneColorConverter(cfg=torch_cfg(TINY_API), device="cpu", enable_watermark=False)
    tconv.set_model(synthesizer_from_jax(params, torch_cfg(TINY_API)))
    return jconv, tconv


def test_se_cosine_matches_jax(converters):
    jconv, tconv = converters
    a, b = _clip(220, noise=0.03, seed=1), _clip(520, noise=0.03, seed=4)
    target = np.asarray(jconv._se_from_audio_batch([a])).reshape(-1)
    for x in (a, b):
        np.testing.assert_allclose(TQ.se_cosine(tconv, x, target), JQ.se_cosine(jconv, x, target), atol=1e-4)


def test_mcd_identity_is_zero():
    x = _clip(220, noise=0.02)
    assert _mcd(x, x) == 0.0


def test_mcd_monotone_in_distortion():
    x = _clip(220)
    d_small = _mcd(x, np.clip(x + 0.01 * _clip(900), -1, 1))
    d_large = _mcd(x, np.clip(x + 0.2 * _clip(900), -1, 1))
    assert 0 < d_small < d_large


def test_mcd_truncates_length_mismatch_and_rejects_empty():
    x = _clip(220)
    assert _mcd(x, x[: len(x) - 700]) < 1.5
    with pytest.raises(ValueError):
        _mcd(x[:10], x[:10])


def test_cosine_basics():
    a, b = np.array([1.0, 0.0]), np.array([0.0, 1.0])
    assert TQ.cosine(a, a) == pytest.approx(1.0)
    assert TQ.cosine(a, -a) == pytest.approx(-1.0)
    assert TQ.cosine(a, b) == pytest.approx(0.0)
    assert TQ.cosine(a, np.zeros(2)) == 0.0


def test_se_cosine_self_is_one_and_orders_speakers(converters):
    _, conv = converters
    a1, a2 = _clip(220, noise=0.03, seed=1), _clip(220, noise=0.03, seed=2)
    b = _clip(520, noise=0.03, seed=3)
    se_a = conv._se_from_audio_batch([a1])
    assert TQ.se_cosine(conv, a1, se_a) == pytest.approx(1.0, abs=1e-5)
    assert TQ.se_cosine(conv, a2, se_a) > TQ.se_cosine(conv, b, se_a)
