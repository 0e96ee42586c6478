"""The serving mode of the PyTorch port as a whole, on tiny configs and the
CPU (where every kernel wrapper runs its plain version): the kernel route
against the JAX graph in f32, the bf16 mode against JAX's own bf16 mode,
padded batches against exact lengths, and the life of the packed cache; for
the V2 converter and the V1 one (zero_g=False, where the posterior encoder's
WaveNet and the decoder see real speaker embeddings)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu.api import ToneColorConverter as JaxConverter
from openvoice_tpu.models import synthesizer as JS
from openvoice_tpu.nn.flows import apply_coupling_block as japply_coupling_block
from openvoice_tpu_torch.api import ToneColorConverter
from openvoice_tpu_torch.ckpt.from_jax import dec_cache_from_jax
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.nn.hifigan import _stage_plan
from tests._torch_port import (
    TINY, TINY_API, TINY_STOCK, TINY_TAIL, TINY_TAIL_V1, TINY_V1, jax_cfg, jax_params, lengths_mask, t,
    torch_cfg, torch_model,
)

SR = 22050


def _case(fields: dict, seed: int, lengths, n: int):
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    b = len(lengths)
    spec = np.abs(rng.standard_normal((b, n, fields["spec_channels"]))).astype(np.float32)
    spec *= lengths_mask(lengths, n)
    g_s = rng.standard_normal((b, 1, fields["gin_channels"])).astype(np.float32)
    g_t = rng.standard_normal((b, 1, fields["gin_channels"])).astype(np.float32)
    noise = rng.standard_normal((b, n, fields["inter_channels"])).astype(np.float32)
    return spec, lengths, g_s, g_t, noise


def test_stage_plans_cover_every_route():
    """TINY's decoder is MRF-kernel stages; TINY_TAIL's adds both tail forms;
    TINY_STOCK's leaves stages on stock layers behind a kernel stage."""
    kinds = lambda fields: [(_stage_plan(TS.Synthesizer(torch_cfg(fields)).dec, i) or {}).get("kind")
                            for i in range(len(fields["upsample_rates"]))]
    assert kinds(TINY) == ["mrf", "mrf"]
    assert kinds(TINY_TAIL) == ["mrf", "upmrf", "tail"]
    assert kinds(TINY_STOCK) == ["mrf", None, None]


@pytest.mark.parametrize("fields", [TINY, TINY_TAIL, TINY_STOCK], ids=["mrf-stages", "tail-stages", "stock-stages"])
@torch.inference_mode()
def test_kernel_route_f32_matches_jax_f32(fields):
    """An f32 cache sends the graph through every wrapper's plain version
    with no rounding: flips, upsample phases and masks must be exact."""
    params = jax_params(fields, seed=21)
    model, cache = dec_cache_from_jax(params, torch_cfg(fields), torch.float32)
    spec, lengths, g_s, g_t, noise = _case(fields, 8, [48, 37], 48)
    cfg = jax_cfg(fields)
    mask = jnp.asarray(lengths_mask(lengths, 48))

    g0 = jnp.zeros_like(jnp.asarray(g_s))
    z, _, _ = JS.posterior_encode(params, cfg, jnp.asarray(spec), mask, g0, 0.3, jnp.asarray(noise))
    z_p = japply_coupling_block(params["flow"], z, mask, g=jnp.asarray(g_s), reverse=False)
    z_hat = japply_coupling_block(params["flow"], z_p, mask, g=jnp.asarray(g_t), reverse=True)
    ours = TS._latents_packed(model, cache, t(spec), t(lengths_mask(lengths, 48)), t(g_s), t(g_t), 0.3, t(noise))
    np.testing.assert_allclose(ours.numpy(), np.asarray(z_hat), atol=2e-4)

    ref, _ = JS.voice_conversion(params, cfg, jnp.asarray(spec), jnp.asarray(lengths), jnp.asarray(g_s),
                                 jnp.asarray(g_t), 0.3, jnp.asarray(noise))
    out, _ = TS.voice_conversion(model, t(spec), t(lengths), t(g_s), t(g_t), 0.3, t(noise), dec_cache=cache)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, None)], ids=["f32", "bf16"])
@torch.inference_mode()
def test_padded_batch_equals_exact_length_on_the_kernel_route(dtype, atol):
    fields = TINY_TAIL
    model, cache = dec_cache_from_jax(jax_params(fields, seed=5), torch_cfg(fields), dtype)
    fast = dtype == torch.bfloat16
    spec, lengths, g_s, g_t, noise = _case(fields, 9, [40, 29], 40)
    both, _ = TS.voice_conversion(model, t(spec), t(lengths), t(g_s), t(g_t), 0.3, t(noise),
                                  fast=fast, dec_cache=cache)
    n = int(lengths[1])
    alone, _ = TS.voice_conversion(model, t(spec[1:, :n]), t(lengths[1:]), t(g_s[1:]), t(g_t[1:]), 0.3,
                                   t(noise[1:, :n]), fast=fast, dec_cache=cache)
    up = torch_cfg(fields).upsample_factor
    assert bool((both[1, n * up + 3:] == 0).all()), "audio past the length (and conv_post's reach) must be 0"
    if atol is None:
        # bf16: padding changes no operand, but the stock layers may sum in
        # another order at another length, which can flip a rounding
        atol = 2.0 ** -6 * float(alone.abs().max())
    np.testing.assert_allclose(both[1, : n * up].numpy(), alone[0, : n * up].numpy(), atol=atol)


def _voice(seconds: float, f0: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * SR)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * tt))) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 2.5 * tt), 0, None) ** 0.5
    return (0.3 * x * env + 0.005 * rng.standard_normal(len(tt))).astype(np.float32)


@pytest.fixture(scope="module")
def converters():
    params = jax_params(TINY_API, seed=31)
    jconv = JaxConverter(cfg=jax_cfg(TINY_API))
    jconv.params = params
    tconv = ToneColorConverter(cfg=torch_cfg(TINY_API), device="cpu")
    tconv.set_model(torch_model(TINY_API, params))
    return jconv, tconv


def test_convert_fast_strays_from_f32_no_more_than_twice_jax(converters):
    """convert(fast=True) against JAX's convert(fast=True) on the CPU (its
    bf16 XLA route).  Two bf16 graphs that round at different places cannot
    be held to each other's bits; each is held to the f32 result instead, and
    the port may stray at most twice as far as JAX does on the same inputs."""
    jconv, tconv = converters
    rng = np.random.default_rng(2)
    se_src = rng.standard_normal(TINY_API["gin_channels"]).astype(np.float32)
    se_tgt = rng.standard_normal(TINY_API["gin_channels"]).astype(np.float32)
    src = _voice(1.3, 130.0, seed=3)
    kw = dict(tau=0.3, seed=4, message="")
    ours_f32 = tconv.convert(src, se_src, se_tgt, **kw)
    ours_fast = tconv.convert(src, se_src, se_tgt, fast=True, **kw)
    jax_f32 = jconv.convert(src, se_src, se_tgt, **kw)
    jax_fast = jconv.convert(src, se_src, se_tgt, fast=True, **kw)
    assert ours_fast.shape == ours_f32.shape == jax_fast.shape and ours_fast.dtype == np.float32
    assert np.isfinite(ours_fast).all()
    ours, theirs = np.abs(ours_fast - ours_f32).max(), np.abs(jax_fast - jax_f32).max()
    peak = np.abs(jax_f32).max()
    assert ours <= 2 * theirs, (f"port max|fast - f32| = {ours:.3e}, JAX max|fast - f32| = {theirs:.3e} "
                                f"(f32 peak {peak:.3e})")
    assert ours > 0, "the fast mode returned the f32 result: it did not run in bf16"


def test_serving_cache_is_packed_once_and_dropped_with_the_weights(converters, monkeypatch, tmp_path):
    _, tconv = converters
    calls = []
    real = TS.make_dec_cache
    monkeypatch.setattr(TS, "make_dec_cache", lambda *a, **k: calls.append(1) or real(*a, **k))
    src = _voice(0.4, 150.0, seed=1)
    se = np.ones(TINY_API["gin_channels"], np.float32)
    tconv._dec_cache = None
    tconv.convert(src, se, se, message="")
    assert calls == [] and tconv._dec_cache is None, "the f32 mode must not pack"
    tconv.convert(src, se, se, message="", fast=True)
    tconv.convert(src, se, se, message="", fast=True)
    assert calls == [1], "the cache must be packed once, at the first fast convert"
    cache = tconv._dec_cache
    assert cache["dtype"] == torch.bfloat16 and cache["wn"]["enc_q"]["w_in"].dtype == torch.bfloat16

    tconv.set_model(tconv.model)
    assert tconv._dec_cache is None, "set_model must drop the cache"
    tconv.convert(src, se, se, message="", fast=True)
    assert calls == [1, 1]
    path = tmp_path / "ckpt.pth"
    torch.save({"model": tconv.model.state_dict()}, path)
    tconv.load_ckpt(str(path))
    assert tconv._dec_cache is None, "load_ckpt must drop the cache"


@torch.inference_mode()
def test_fast_without_cache_or_with_the_wrong_cache_raises():
    model = torch_model(TINY, jax_params(TINY, seed=1))
    spec, lengths, g_s, g_t, noise = _case(TINY, 1, [16], 16)
    args = (model, t(spec), t(lengths), t(g_s), t(g_t), 0.3, t(noise))
    with pytest.raises(ValueError, match="make_dec_cache"):
        TS.voice_conversion(*args, fast=True)
    with pytest.raises(TypeError, match="dec_cache holds"):
        TS.voice_conversion(*args, fast=True, dec_cache=TS.make_dec_cache(model, torch.float32))


@torch.inference_mode()
def test_v1_kernel_route_f32_matches_jax_f32():
    """zero_g=False on the kernel route with an f32 cache: the WaveNet's
    conditioning (the stock copy of ``cond_layer`` outside the kernel) and
    the decoder's ``cond`` see the real embeddings, and every stage plan
    route runs."""
    fields = TINY_TAIL_V1
    params = jax_params(fields, seed=23)
    model, cache = dec_cache_from_jax(params, torch_cfg(fields), torch.float32)
    spec, lengths, g_s, g_t, noise = _case(fields, 10, [48, 31], 48)
    cfg = jax_cfg(fields)
    mask = jnp.asarray(lengths_mask(lengths, 48))
    z, _, _ = JS.posterior_encode(params, cfg, jnp.asarray(spec), mask, jnp.asarray(g_s), 0.3, jnp.asarray(noise))
    z_p = japply_coupling_block(params["flow"], z, mask, g=jnp.asarray(g_s), reverse=False)
    z_hat = japply_coupling_block(params["flow"], z_p, mask, g=jnp.asarray(g_t), reverse=True)
    ours = TS._latents_packed(model, cache, t(spec), t(lengths_mask(lengths, 48)), t(g_s), t(g_t), 0.3, t(noise))
    np.testing.assert_allclose(ours.numpy(), np.asarray(z_hat), atol=2e-4)
    ref, _ = JS.voice_conversion(params, cfg, jnp.asarray(spec), jnp.asarray(lengths), jnp.asarray(g_s),
                                 jnp.asarray(g_t), 0.3, jnp.asarray(noise))
    out, _ = TS.voice_conversion(model, t(spec), t(lengths), t(g_s), t(g_t), 0.3, t(noise), dec_cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4)


def test_v1_convert_fast_strays_from_f32_no_more_than_twice_jax():
    """The V1 converter's serving mode under the V2 converter's bar."""
    params = jax_params(TINY_V1, seed=35)
    jconv = JaxConverter(cfg=jax_cfg(TINY_V1))
    jconv.params = params
    tconv = ToneColorConverter(cfg=torch_cfg(TINY_V1), device="cpu")
    tconv.set_model(torch_model(TINY_V1, params))
    rng = np.random.default_rng(12)
    se_src = rng.standard_normal(TINY_V1["gin_channels"]).astype(np.float32)
    se_tgt = rng.standard_normal(TINY_V1["gin_channels"]).astype(np.float32)
    src = _voice(1.3, 160.0, seed=13)
    kw = dict(tau=0.3, seed=14, message="")
    ours_f32 = tconv.convert(src, se_src, se_tgt, **kw)
    ours_fast = tconv.convert(src, se_src, se_tgt, fast=True, **kw)
    jax_f32 = jconv.convert(src, se_src, se_tgt, **kw)
    jax_fast = jconv.convert(src, se_src, se_tgt, fast=True, **kw)
    assert ours_fast.shape == ours_f32.shape == jax_fast.shape and np.isfinite(ours_fast).all()
    np.testing.assert_allclose(ours_f32, jax_f32, atol=5e-4)
    ours, theirs = np.abs(ours_fast - ours_f32).max(), np.abs(jax_fast - jax_f32).max()
    assert 0 < ours <= 2 * theirs, f"port max|fast - f32| = {ours:.3e}, JAX max|fast - f32| = {theirs:.3e}"
