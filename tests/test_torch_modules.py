"""Each module of the port against its JAX function, on JAX init weights sent
through the bridge and on the same seeded numpy inputs (float32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu.models import synthesizer as JS
from openvoice_tpu.nn import conv as jconv
from openvoice_tpu.nn.flows import apply_coupling_block as j_coupling_block
from openvoice_tpu.nn.hifigan import apply_generator as j_generator
from openvoice_tpu.nn.ref_encoder import apply_reference_encoder as j_ref_encoder
from openvoice_tpu.nn.wavenet import apply_wn as j_wn
from openvoice_tpu_torch.ckpt import from_jax
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.nn import conv as tconv
from openvoice_tpu_torch.nn.flows import apply_coupling_block as t_coupling_block
from openvoice_tpu_torch.nn.hifigan import apply_generator as t_generator
from openvoice_tpu_torch.nn.wavenet import apply_wn as t_wn
from tests._torch_port import TINY, jax_cfg, jax_params, lengths_mask, t, torch_model

LENGTHS = [40, 29]
T = 40


@pytest.fixture(scope="module")
def weights():
    params = jax_params(TINY, seed=11)
    return params, torch_model(TINY, params)


def _load(layer, p, convert):
    sd = {}
    convert(p, "x", sd)
    layer.load_state_dict({k[2:]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return layer


@pytest.mark.parametrize("case", ["conv1d_k5", "conv1d_dilated", "conv_transpose1d"])
@torch.inference_mode()
def test_conv_layers_match_jax(case):
    """The layers' padding conventions and the bridge's conv layouts (the
    transposed conv's kernel flip included) against the JAX primitives."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 23, 12)).astype(np.float32)
    if case == "conv_transpose1d":
        w = rng.standard_normal((8, 12, 6)).astype(np.float32) * 0.1
        b = rng.standard_normal(6).astype(np.float32)
        ref = jconv.conv_transpose1d(jnp.asarray(x), w, b, stride=4, padding=2)
        layer = _load(tconv.conv_transpose1d(12, 6, 8, 4), {"w": w, "b": b}, from_jax._conv_transpose)
    else:
        k, d = (5, 1) if case == "conv1d_k5" else (3, 5)
        w = rng.standard_normal((k, 12, 6)).astype(np.float32) * 0.1
        b = rng.standard_normal(6).astype(np.float32)
        ref = jconv.conv1d(jnp.asarray(x), w, b, padding=(k * d - d) // 2, dilation=d)
        layer = _load(tconv.conv1d(12, 6, k, dilation=d), {"w": w, "b": b}, from_jax._conv)
    out = layer(t(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("with_g", [True, False])
@torch.inference_mode()
def test_wavenet_matches_jax(weights, with_g):
    params, model = weights
    rng = np.random.default_rng(2)
    h = TINY["hidden_channels"]
    mask = lengths_mask(LENGTHS, T)
    x = rng.standard_normal((2, T, h)).astype(np.float32) * mask
    g = rng.standard_normal((2, 1, TINY["gin_channels"])).astype(np.float32) if with_g else None
    ref = j_wn(params["enc_q"]["wn"], jnp.asarray(x), jnp.asarray(mask),
               g=None if g is None else jnp.asarray(g))
    out = t_wn(model.enc_q.enc, t(x), t(mask), None if g is None else t(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@torch.inference_mode()
def test_coupling_block_matches_jax_both_ways(weights):
    """Random `post` weights (JAX initialises them to zero, which would make
    the flow the identity): forward, reverse and round trip."""
    params, model = weights
    rng = np.random.default_rng(3)
    mask = lengths_mask(LENGTHS, T)
    x = rng.standard_normal((2, T, TINY["inter_channels"])).astype(np.float32) * mask
    g = rng.standard_normal((2, 1, TINY["gin_channels"])).astype(np.float32)
    fwd_ref = j_coupling_block(params["flow"], jnp.asarray(x), jnp.asarray(mask), g=jnp.asarray(g))
    fwd = t_coupling_block(model.flow, t(x), t(mask), t(g))
    assert float(np.abs(np.asarray(fwd_ref) - x).max()) > 1e-2  # the flow is not the identity
    np.testing.assert_allclose(fwd.numpy(), np.asarray(fwd_ref), atol=2e-4)
    rev_ref = j_coupling_block(params["flow"], jnp.asarray(x), jnp.asarray(mask), g=jnp.asarray(g),
                               reverse=True)
    rev = t_coupling_block(model.flow, t(x), t(mask), t(g), reverse=True)
    np.testing.assert_allclose(rev.numpy(), np.asarray(rev_ref), atol=2e-4)
    back = t_coupling_block(model.flow, fwd, t(mask), t(g), reverse=True)
    np.testing.assert_allclose(back.numpy(), x, atol=2e-4)


@pytest.mark.parametrize("resblock", ["1", "2"])
@torch.inference_mode()
def test_generator_padded_batch_equals_exact_length_and_jax(weights, resblock):
    if resblock == "1":
        fields, (params, model) = TINY, weights
    else:  # the reference's ResBlock2 (2 dilated convs per branch)
        fields = dict(TINY, resblock="2", resblock_dilation_sizes=((1, 3), (1, 3)))
        params = jax_params(fields, seed=12)
        model = torch_model(fields, params)
    cfg = jax_cfg(fields)
    rng = np.random.default_rng(4)
    mask = lengths_mask(LENGTHS, T)
    z = rng.standard_normal((2, T, TINY["inter_channels"])).astype(np.float32) * mask
    g = rng.standard_normal((2, 1, TINY["gin_channels"])).astype(np.float32)
    padded = t_generator(model.dec, t(z), t(g), t(mask)).numpy()
    ref = j_generator(
        params["dec"], jnp.asarray(z), resblock_kind=cfg.resblock,
        resblock_dilation_sizes=cfg.resblock_dilation_sizes, upsample_rates=cfg.upsample_rates,
        upsample_kernel_sizes=cfg.upsample_kernel_sizes, g=jnp.asarray(g), x_mask=jnp.asarray(mask),
    )
    np.testing.assert_allclose(padded, np.asarray(ref), atol=5e-4)
    up = cfg.upsample_factor
    for i, n in enumerate(LENGTHS):
        exact = t_generator(model.dec, t(z[i : i + 1, :n]), t(g[i : i + 1])).numpy()
        np.testing.assert_allclose(padded[i, : n * up], exact[0], atol=5e-4)
        # past conv_post's 3-sample reach the masked tail is exactly silent
        assert not padded[i, n * up + 3 :].any()


@torch.inference_mode()
def test_reference_encoder_with_lengths_matches_jax(weights):
    params, model = weights
    rng = np.random.default_rng(5)
    spec = np.abs(rng.standard_normal((2, T, TINY["spec_channels"]))).astype(np.float32)
    lengths = np.asarray(LENGTHS, np.int32)
    ref = j_ref_encoder(params["ref_enc"], jnp.asarray(spec), jnp.asarray(lengths))
    out = TS.extract_tone_color(model, t(spec), t(lengths.astype(np.int64)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    # each padded row equals that clip run alone at its own length
    for i, n in enumerate(LENGTHS):
        alone = TS.extract_tone_color(model, t(spec[i : i + 1, :n]))
        np.testing.assert_allclose(out[i].numpy(), alone[0].numpy(), atol=1e-5)


@torch.inference_mode()
def test_posterior_encoder_latents_match_jax(weights):
    params, model = weights
    rng = np.random.default_rng(6)
    mask = lengths_mask(LENGTHS, T)
    spec = np.abs(rng.standard_normal((2, T, TINY["spec_channels"]))).astype(np.float32)
    g = np.zeros((2, 1, TINY["gin_channels"]), np.float32)
    noise = rng.standard_normal((2, T, TINY["inter_channels"])).astype(np.float32)
    ref = JS.posterior_encode(params, jax_cfg(TINY), jnp.asarray(spec), jnp.asarray(mask),
                              jnp.asarray(g), 0.3, jnp.asarray(noise))
    out = TS.posterior_encode(model, t(spec), t(mask), t(g), 0.3, t(noise))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-4)
