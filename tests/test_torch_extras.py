"""The port's auxiliary blocks (``nn/extras.py``), the commons helpers of
``models/align.py`` and the duration predictor's training NLL against the
JAX package's functions (tests/test_extras.py's cases): the same JAX
weights through ``ckpt/from_jax.py::extras_from_jax``, the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu.models import align as JA
from openvoice_tpu.nn import extras as JX
from openvoice_tpu.nn.duration import apply_sdp_forward as jax_sdp_forward
from openvoice_tpu_torch.ckpt.from_jax import extras_from_jax, synthesizer_from_jax
from openvoice_tpu_torch.models import align as TA
from openvoice_tpu_torch.nn import extras as TX
from openvoice_tpu_torch.nn.duration import apply_sdp_forward
from tests._torch_port import TINY_TTS, jax_params, lengths_mask, t, torch_cfg

TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _masked_input(rng, b, length, c, lengths):
    mask = lengths_mask(lengths, length)
    return (rng.standard_normal((b, length, c)).astype(np.float32) * mask), mask


@torch.no_grad()
def test_conv_relu_norm_matches_jax_and_starts_as_identity():
    params = _np(JX.init_conv_relu_norm(jax.random.PRNGKey(0), 16, 32, 16, kernel_size=5, n_layers=3))
    rng = np.random.default_rng(0)
    x, mask = _masked_input(rng, 2, 40, 16, [40, 25])
    fresh = TX.ConvReluNorm(16, 32, 16, 5, 3).eval()
    np.testing.assert_allclose(TX.apply_conv_relu_norm(fresh, t(x), t(mask)).numpy(), x, atol=1e-6)
    params["proj"]["w"] = rng.uniform(-0.1, 0.1, params["proj"]["w"].shape).astype(np.float32)
    block = extras_from_jax(TX.ConvReluNorm(16, 32, 16, 5, 3), params).eval()
    got = TX.apply_conv_relu_norm(block, t(x), t(mask)).numpy()
    ref = np.asarray(JX.apply_conv_relu_norm(params, jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, atol=TOL)
    assert np.abs(got[1, 25:]).max() == 0.0


@pytest.mark.parametrize("gin", [0, 16])
@torch.no_grad()
def test_transformer_coupling_matches_jax_and_inverts(gin):
    n_layers = 3 if gin else 2
    params = _np(JX.init_transformer_coupling_layer(jax.random.PRNGKey(0), channels=32, hidden_channels=48,
                                                    filter_channels=96, kernel_size=3, n_layers=n_layers, n_heads=2,
                                                    gin_channels=gin))
    rng = np.random.default_rng(1)
    params["post"]["w"] = (rng.standard_normal(params["post"]["w"].shape) * 0.1).astype(np.float32)
    layer = extras_from_jax(TX.TransformerCouplingLayer(32, 48, 96, 3, n_layers, 2, gin_channels=gin), params).eval()
    x, mask = _masked_input(rng, 2, 24, 32, [24, 17])
    g = rng.standard_normal((2, 1, gin)).astype(np.float32) if gin else None
    jg = jnp.asarray(g) if gin else None
    y, logdet = TX.apply_transformer_coupling_layer(layer, t(x), t(mask), g=t(g) if gin else None)
    ref_y, ref_logdet = JX.apply_transformer_coupling_layer(params, jnp.asarray(x), jnp.asarray(mask), n_heads=2,
                                                            kernel_size=3, g=jg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=TOL)
    np.testing.assert_array_equal(logdet.numpy(), np.asarray(ref_logdet))
    back = TX.apply_transformer_coupling_layer(layer, y, t(mask), g=t(g) if gin else None, reverse=True)
    np.testing.assert_allclose(back.numpy(), x, atol=TOL)
    np.testing.assert_array_equal(y[..., :16].numpy(), x[..., :16])


@pytest.mark.parametrize("proximal_bias", [False, True])
@torch.no_grad()
def test_decoder_matches_jax_and_is_causal(proximal_bias):
    params = _np(JX.init_decoder(jax.random.PRNGKey(0), hidden=32, filter_channels=64, n_heads=2, kernel_size=3,
                                 n_layers=2))
    decoder = extras_from_jax(TX.Decoder(32, 64, 2, 3, 2, proximal_bias=proximal_bias), params).eval()
    rng = np.random.default_rng(2)
    x, x_mask = _masked_input(rng, 2, 20, 32, [20, 14])
    h, h_mask = _masked_input(rng, 2, 12, 32, [12, 9])
    got = TX.apply_decoder(decoder, t(x), t(x_mask), t(h), t(h_mask)).numpy()
    ref = np.asarray(JX.apply_decoder(params, jnp.asarray(x), jnp.asarray(x_mask), jnp.asarray(h),
                                      jnp.asarray(h_mask), n_heads=2, kernel_size=3, proximal_bias=proximal_bias))
    np.testing.assert_allclose(got, ref, atol=TOL)
    future = x.copy()
    future[:, 15:] = 99.0 * x_mask[:, 15:]
    moved = TX.apply_decoder(decoder, t(future), t(x_mask), t(h), t(h_mask)).numpy()
    np.testing.assert_allclose(moved[0, :15], got[0, :15], atol=TOL)  # the past does not see the future
    assert np.abs(moved[0, 15:] - got[0, 15:]).max() > 1e-3


@pytest.mark.parametrize("length, channels", [(17, 8), (33, 7)])
def test_timing_signals_match_jax(length, channels):
    np.testing.assert_allclose(TA.timing_signal_1d(length, channels).numpy(),
                               np.asarray(JA.timing_signal_1d(length, channels)), atol=1e-6)
    x = np.random.default_rng(0).standard_normal((2, length, channels)).astype(np.float32)
    np.testing.assert_allclose(TA.add_timing_signal_1d(t(x)).numpy(),
                               np.asarray(JA.add_timing_signal_1d(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(TA.cat_timing_signal_1d(t(x)).numpy(),
                               np.asarray(JA.cat_timing_signal_1d(jnp.asarray(x))), atol=1e-6)


def test_subsequent_mask_and_gumbel():
    np.testing.assert_array_equal(TA.subsequent_mask(5).numpy(), np.asarray(JA.subsequent_mask(5)))
    g = TA.rand_gumbel((10000,), generator=torch.Generator().manual_seed(0)).numpy()
    assert np.isfinite(g).all()
    assert abs(g.mean() - 0.5772) < 0.05  # Gumbel(0, 1)'s mean, the Euler–Mascheroni constant
    # the overflow guard: the uniforms are squeezed into [1e-5, 0.99999], as in JAX
    lo, hi = -np.log(-np.log(np.asarray([0.00001, 0.99999], np.float32)))
    assert lo <= g.min() and g.max() <= hi
    assert np.isfinite(np.asarray(JA.rand_gumbel(jax.random.PRNGKey(0), (10000,)))).all()


def test_sdp_forward_nll_matches_jax():
    """The duration predictor's training NLL with the JAX function's own
    posterior noise (drawn from its key, then handed to the port)."""
    params = jax_params(TINY_TTS, seed=6)
    sdp = synthesizer_from_jax(params, torch_cfg(TINY_TTS)).sdp.eval()
    rng = np.random.default_rng(3)
    b, length, hidden = 2, 11, TINY_TTS["hidden_channels"]
    x, mask = _masked_input(rng, b, length, hidden, [11, 7])
    w = (rng.integers(1, 6, (b, length, 1)).astype(np.float32)) * mask
    g = rng.standard_normal((b, 1, TINY_TTS["gin_channels"])).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jax_sdp_forward(params["sdp"], jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w),
                                     jnp.asarray(g), key))
    e_q = np.asarray(jax.random.normal(key, (b, length, 2), dtype=jnp.float32))
    with torch.no_grad():
        got = apply_sdp_forward(sdp, t(x), t(mask), t(w), t(g), t(e_q)).numpy()
    assert got.shape == (b,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
