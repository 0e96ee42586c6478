"""The base-speaker TTS of the port against the JAX package, module by module
and end to end, on the same seeded inputs and JAX init weights sent through
the bridge (CPU; every kernel wrapper runs its plain version).

Durations are ceilings, so a last-bit difference could flip one frame:
log-durations are compared at 1e-4, the ceilings exactly, and every decode
comparison feeds both packages the same ceilings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu.api import BaseSpeakerTTS as JaxTTS
from openvoice_tpu.ckpt.torch_import import import_synthesizer
from openvoice_tpu.models import align as jalign
from openvoice_tpu.models import synthesizer as JS
from openvoice_tpu.nn import attention as jattn
from openvoice_tpu.nn import duration as jdur
from openvoice_tpu.nn import flows as jflows
from openvoice_tpu.nn import transforms as jtf
from openvoice_tpu.nn.flows import apply_coupling_block as j_coupling_block
from openvoice_tpu_torch.api import BaseSpeakerTTS, _stack_enc_rows
from openvoice_tpu_torch.ckpt import from_jax
from openvoice_tpu_torch.ckpt.from_jax import dec_cache_from_jax, jax_state_dict
from openvoice_tpu_torch.models import align as talign
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.nn import attention as tattn
from openvoice_tpu_torch.nn import duration as tdur
from openvoice_tpu_torch.nn import flows as tflows
from openvoice_tpu_torch.nn import transforms as ttf
from tests._regen_golden import GOLDEN_DIR
from tests._torch_port import TINY_TTS, TINY_TTS_TAIL, jax_cfg, jax_params, lengths_mask, t, torch_cfg, torch_model

TEXT = ("The quick brown fox jumps over the lazy dog while the whole village watches it. "
        "A second sentence follows here and it is rather longer than the first one was. "
        "Finally the third and last sentence closes this little test with eleven words.")


def _load(module, p, convert):
    sd = {}
    convert(p, "x", sd)
    module.load_state_dict({k[2:]: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()})
    return module.eval()


def _randomize(p, rng, scale=0.3):
    """Seeded values for the zero-initialised leaves (spline projections,
    affine flows), so that every part of the duration flows moves."""
    if isinstance(p, dict):
        return {k: _randomize(v, rng, scale) for k, v in p.items()}
    if isinstance(p, list):
        return [_randomize(v, rng, scale) for v in p]
    a = np.asarray(p)
    return (rng.standard_normal(a.shape) * scale).astype(np.float32) if not a.any() else a


# -- modules ---------------------------------------------------------------------

def test_generate_path_matches_jax_exactly():
    rng = np.random.default_rng(0)
    dur = rng.integers(0, 4, (3, 9)).astype(np.float32)
    x_len, t_y = np.asarray([9, 6, 1]), 30
    mask = lengths_mask(np.minimum(dur.sum(1), t_y), t_y)[..., 0][:, :, None] * lengths_mask(x_len, 9)[..., 0][:, None, :]
    ref = np.asarray(jalign.generate_path(jnp.asarray(dur), jnp.asarray(mask)))
    out = talign.generate_path(t(dur), t(mask)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.sum() > 0


@pytest.mark.parametrize("t_max,lengths", [(23, [23, 14]), (3, [3, 2])], ids=["T23", "T3-shorter-than-window"])
@torch.inference_mode()
def test_encoder_stack_matches_jax_and_padding_is_inert(t_max, lengths):
    hidden, filt, heads, kernel, window = 32, 48, 2, 3, 4
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    params = {"layers": [jax.tree.map(np.asarray, JS._attn_layer_init(k, hidden, filt, heads, kernel, window))
                         for k in keys]}
    enc = _load(tattn.Encoder(hidden, filt, heads, 2, kernel, window), params, from_jax._attn_encoder)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, t_max, hidden)).astype(np.float32)
    mask = lengths_mask(lengths, t_max)
    ref = jattn.apply_encoder(params, jnp.asarray(x), jnp.asarray(mask), n_heads=heads, kernel_size=kernel,
                              window_size=window)
    out = tattn.apply_encoder(enc, t(x), t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    n = lengths[1]
    alone = tattn.apply_encoder(enc, t(x[1:, :n]), t(mask[1:, :n]))
    np.testing.assert_allclose(out[1, :n].numpy(), alone[0].numpy(), atol=1e-5)
    assert bool((out[1, n:] == 0).all())


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_spline_matches_jax_with_inputs_on_bin_edges(inverse):
    rng = np.random.default_rng(6)
    shape, k, bound = (2, 3, 17), 10, 5.0
    uw, uh = (rng.standard_normal(shape + (k,)).astype(np.float32) for _ in range(2))
    ud = rng.standard_normal(shape + (k - 1,)).astype(np.float32)
    x = rng.uniform(-7.0, 7.0, shape).astype(np.float32)
    # put inputs exactly on the knots the bin search compares against:
    # element j takes its own knot j
    edges, _ = ttf._edges(t(uh if inverse else uw), -bound, bound, ttf.DEFAULT_MIN_BIN_WIDTH)
    x[..., : k + 1] = np.diagonal(edges.numpy()[..., : k + 1, :], axis1=-2, axis2=-1)
    x[0, 0, 0], x[0, 0, 1] = bound, -bound
    ref_y, ref_lad = jtf.piecewise_rational_quadratic_transform(
        jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh), jnp.asarray(ud), inverse=inverse, tails="linear",
        tail_bound=bound)
    y, lad = ttf.piecewise_rational_quadratic_transform(t(x), t(uw), t(uh), t(ud), inverse=inverse,
                                                        tails="linear", tail_bound=bound)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-5)
    # the packages' knots differ by a few ulps (softmax and cumsum round
    # differently), so an input on a knot may fall in the neighbouring bin
    # on the other side: the output is continuous there, its log-derivative
    # only to first order in theta, so it is compared off the knots
    np.testing.assert_allclose(lad.numpy()[..., k + 1:], np.asarray(ref_lad)[..., k + 1:], atol=1e-5)
    assert not np.allclose(y.numpy(), x), "the spline did nothing"


def test_bin_search_counts_ties_as_jax_does():
    """On the same knots, inputs on a knot (and on the last knot, which gets
    eps) land in the same bin as in the JAX package."""
    knots = np.asarray([[-5.0, -1.5, 0.0, 0.25, 2.0, 5.0]] * 2, np.float32)
    x = np.asarray([[-5.0, -1.5, 0.0, 0.25, 2.0, 5.0], [-6.0, -1.5000001, 1e-8, 4.999999, 5.000001, 7.0]],
                   np.float32)
    ref = np.asarray(jtf._searchsorted(jnp.asarray(knots[:, None, :].repeat(6, 1)), jnp.asarray(x)))
    out = ttf._searchsorted(t(knots[:, None, :].repeat(6, 1)), t(x)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[0], [0, 1, 2, 3, 4, 4])


@torch.inference_mode()
def test_duration_predictors_match_jax():
    """The stochastic predictor's reverse pass and the deterministic one, with
    a speaker embedding, on a padded batch: logw at 1e-4."""
    hidden, gin, k = 32, 16, 3
    rng = np.random.default_rng(7)
    sdp_p = _randomize(jax.tree.map(np.asarray, JS._sdp_init(jax.random.PRNGKey(8), hidden, k, gin)), rng)
    dp_p = jax.tree.map(np.asarray, JS._dp_init(jax.random.PRNGKey(9), hidden, 48, k, gin))
    sdp = _load(tdur.StochasticDurationPredictor(hidden, k, gin_channels=gin), sdp_p, from_jax._sdp)
    dp = _load(tdur.DurationPredictor(hidden, 48, k, gin), dp_p, from_jax._dp)
    lengths, n = [19, 11], 19
    x = rng.standard_normal((2, n, hidden)).astype(np.float32)
    mask = lengths_mask(lengths, n)
    x *= mask
    g = rng.standard_normal((2, 1, gin)).astype(np.float32)
    noise = rng.standard_normal((2, n, 2)).astype(np.float32)
    ref = jdur.apply_sdp_reverse(sdp_p, jnp.asarray(x), jnp.asarray(mask), g=jnp.asarray(g), noise_scale=0.8,
                                 noise=jnp.asarray(noise))
    out = tdur.apply_sdp_reverse(sdp, t(x), t(mask), t(noise), g=t(g), noise_scale=0.8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    ref = jdur.apply_duration_predictor(dp_p, jnp.asarray(x), jnp.asarray(mask), g=jnp.asarray(g))
    out = tdur.apply_duration_predictor(dp, t(x), t(mask), g=t(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@torch.inference_mode()
def test_duration_flows_match_jax(reverse):
    """The spline coupling (with its DDSConv and context), the elementwise
    affine and the log flow, in both directions; the forward log-determinants
    too (the training path's)."""
    rng = np.random.default_rng(17)
    filt, k = 24, 3
    cf_p = _randomize(jax.tree.map(np.asarray, JS._conv_flow_init(jax.random.PRNGKey(18), 1, filt, k, 3)), rng)
    ea_p = {"m": rng.standard_normal(2).astype(np.float32), "logs": rng.standard_normal(2).astype(np.float32) * 0.3}
    chain = _load(tdur._flow_chain(filt, k, 1), {"ea": ea_p, "conv_flows": [cf_p]}, from_jax._sdp_flows)
    ea, cf = chain[0], chain[1]
    lengths, n = [15, 9], 15
    mask = lengths_mask(lengths, n)
    x = (rng.standard_normal((2, n, 2)) * 2.0).astype(np.float32) * mask
    ctx = rng.standard_normal((2, n, filt)).astype(np.float32) * mask
    jx, jm, jc = jnp.asarray(x), jnp.asarray(mask), jnp.asarray(ctx)
    tx, tm, tc = t(x).transpose(1, 2), t(mask).transpose(1, 2), t(ctx).transpose(1, 2)
    ref = jflows.apply_conv_flow(cf_p, jx, jm, g=jc, reverse=reverse)
    out = cf(tx, tm, g=tc, reverse=reverse)
    ref_ea = jflows.elementwise_affine(ea_p, jx, jm, reverse=reverse)
    out_ea = ea(tx, tm, reverse=reverse)
    pos = np.abs(x) + 0.1
    ref_log = jflows.log_flow(jnp.asarray(pos), jm, reverse=reverse)
    out_log = tflows.log_flow(t(pos).transpose(1, 2), tm, reverse=reverse)
    for ours, theirs in [(out, ref), (out_ea, ref_ea), (out_log, ref_log)]:
        if reverse:
            np.testing.assert_allclose(ours.transpose(1, 2).numpy(), np.asarray(theirs), atol=1e-5)
        else:
            np.testing.assert_allclose(ours[0].transpose(1, 2).numpy(), np.asarray(theirs[0]), atol=1e-5)
            np.testing.assert_allclose(ours[1].numpy(), np.asarray(theirs[1]), atol=1e-4)


# -- the graph -------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_weights():
    """tests/_regen_golden.py's TTS weights: JAX PRNGKey(321), the flow's
    `post` zero as JAX draws it."""
    params = jax_params(TINY_TTS, seed=321, random_post=False)
    return params, torch_model(TINY_TTS, params)


@torch.inference_mode()
def test_golden_tts_audio(golden_weights):
    _, model = golden_weights
    tokens = np.asarray([[3, 5, 7, 2, 9, 11, 4, 6, 8, 10, 1, 12, 13, 14, 15]], np.int32)
    enc = TS.tts_encode(model, t(tokens), torch.tensor([15]), torch.tensor([2]), torch.zeros(1, 15, 2),
                        noise_scale_w=0.0)
    mf = int(enc.w_ceil.sum()) + 8
    audio, _ = TS.tts_decode(model, enc, mf, torch.zeros(1, mf, TINY_TTS["inter_channels"]), noise_scale=0.0)
    ref = np.load(GOLDEN_DIR / "tts_audio_tiny.npy")
    assert audio.shape[1] == ref.shape[0]
    np.testing.assert_allclose(audio[0, :, 0].numpy(), ref, atol=2e-5, rtol=1e-4)


def _token_case(seed: int, lengths, t_x: int, n_vocab: int):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, n_vocab, (len(lengths), t_x)).astype(np.int32)
    tokens *= lengths_mask(lengths, t_x)[..., 0].astype(np.int32)
    return tokens, np.asarray(lengths), rng.standard_normal((len(lengths), t_x, 2)).astype(np.float32)


@torch.inference_mode()
def test_tts_encode_matches_jax_and_ceilings_are_exact(golden_weights):
    params, model = golden_weights
    cfg = jax_cfg(TINY_TTS)
    tokens, lengths, noise_w = _token_case(10, [21, 13], 21, TINY_TTS["n_vocab"])
    sid = np.asarray([1, 3])
    ref = JS.tts_encode(params, cfg, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(sid), None,
                        noise_scale_w=0.6, length_scale=1.1, sdp_ratio=0.3, noise_w=jnp.asarray(noise_w))
    out = TS.tts_encode(model, t(tokens), t(lengths), t(sid), t(noise_w), noise_scale_w=0.6, length_scale=1.1,
                        sdp_ratio=0.3)
    for name in ("m_p", "logs_p", "x_mask", "g"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-4,
                                   err_msg=name)
    # logw against JAX's own blend of its two predictors
    h, _, _, x_mask = TS.text_encode(model, t(tokens), t(lengths))
    jg = jnp.asarray(out.g.numpy())
    jh, jm = jnp.asarray(h.numpy()), jnp.asarray(x_mask.numpy())
    ref_logw = (jdur.apply_sdp_reverse(params["sdp"], jh, jm, g=jg, noise_scale=0.6, noise=jnp.asarray(noise_w)) * 0.3
                + jdur.apply_duration_predictor(params["dp"], jh, jm, g=jg) * 0.7)
    logw = TS.log_durations(model, h, x_mask, out.g, t(noise_w), noise_scale_w=0.6, sdp_ratio=0.3)
    np.testing.assert_allclose(logw.numpy(), np.asarray(ref_logw), atol=1e-4)
    np.testing.assert_array_equal(out.w_ceil.numpy(), np.asarray(ref.w_ceil))
    assert float(out.w_ceil.sum()) > 0


@torch.inference_mode()
def test_tts_decode_f32_matches_jax(golden_weights):
    """Both packages decode JAX's encode output (the same ceilings): latents
    at 2e-4, audio at 5e-4, on a ragged batch with noise."""
    params, model = golden_weights
    cfg = jax_cfg(TINY_TTS)
    tokens, lengths, noise_w = _token_case(11, [17, 9], 17, TINY_TTS["n_vocab"])
    enc = JS.tts_encode(params, cfg, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray([0, 2]), None,
                        noise_w=jnp.asarray(noise_w))
    mf = 64
    assert int(np.asarray(enc.w_ceil).sum(1).max()) <= mf
    noise = np.random.default_rng(12).standard_normal((2, mf, TINY_TTS["inter_channels"])).astype(np.float32)
    tenc = TS.TTSEncodeOut(*(t(np.asarray(a)) for a in enc))
    z, y_mask, y_lengths, _ = TS.tts_latents(model, tenc, mf, t(noise))

    y_len = jnp.clip(jnp.sum(enc.w_ceil, -1), 1, mf).astype(jnp.int32)
    jmask = jalign.sequence_mask(y_len, mf)[..., None].astype(jnp.float32)
    path = jalign.generate_path(enc.w_ceil, jmask * jnp.swapaxes(enc.x_mask, 1, 2))
    z_p = path @ enc.m_p + jnp.asarray(noise) * jnp.exp(path @ enc.logs_p) * 0.667
    ref_z = j_coupling_block(params["flow"], z_p, jmask, g=enc.g, reverse=True)
    np.testing.assert_array_equal(y_lengths.numpy(), np.asarray(y_len))
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=2e-4)

    ref_audio, ref_mask = JS.tts_decode(params, cfg, enc, mf, jnp.asarray(noise))
    audio, y_mask = TS.tts_decode(model, tenc, mf, t(noise))
    assert audio.dtype == y_mask.dtype == torch.float32
    np.testing.assert_array_equal(y_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), atol=5e-4)


@torch.inference_mode()
def test_tts_weights_carry_the_reference_names(golden_weights):
    """The bridge loads a TTS model strictly, and the JAX package's own
    importer of reference checkpoints reads the port's state dict back with
    nothing missing or unexpected and the same arrays."""
    params, model = golden_weights
    sd = model.state_dict()
    assert set(sd) == set(jax_state_dict(params))
    assert any(k.startswith("enc_p.encoder.attn_layers.") for k in sd) and "emb_g.weight" in sd
    assert not any(k.startswith("ref_enc.") for k in sd)
    back, report = import_synthesizer({k: v.numpy() for k, v in sd.items()}, jax_cfg(TINY_TTS))
    assert report == {"missing": [], "unexpected": []}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=jax.tree_util.keystr(path))


# -- the API and the serving mode -------------------------------------------------

@pytest.fixture(scope="module")
def tts_pair():
    params = jax_params(TINY_TTS_TAIL, seed=13)
    jtts = JaxTTS(cfg=jax_cfg(TINY_TTS_TAIL))
    jtts.params = params
    ttts = BaseSpeakerTTS(cfg=torch_cfg(TINY_TTS_TAIL), device="cpu")
    ttts.set_model(torch_model(TINY_TTS_TAIL, params))
    return params, jtts, ttts


def test_tts_and_tts_batched_match_jax(tts_pair):
    _, jtts, ttts = tts_pair
    assert len(ttts._sentence_tokens(TEXT, 1, "English")[0]) == 3
    ours = ttts.tts(TEXT, None, 1, seed=7)
    ref = jtts.tts(TEXT, None, 1, seed=7)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=5e-4)
    batched = ttts.tts_batched(TEXT, None, 1, seed=7)
    np.testing.assert_allclose(batched, ref, atol=5e-4)
    np.testing.assert_allclose(batched, ours, atol=1e-5)
    assert float(np.abs(ours).max()) > 0


def test_tts_fast_strays_from_f32_no_more_than_twice_jax(tts_pair, tmp_path):
    """tts(fast=True) decodes in bf16 through the flow and decoder kernels'
    plain versions; held to the f32 result as the converter's serving mode
    is, against JAX's own fast mode.  tts_batched(fast=True) gives tts's
    audio."""
    _, jtts, ttts = tts_pair
    ours_f32, ours_fast = ttts.tts(TEXT, None, 1, seed=3), ttts.tts(TEXT, None, 1, seed=3, fast=True)
    jax_f32, jax_fast = jtts.tts(TEXT, None, 1, seed=3), jtts.tts(TEXT, None, 1, seed=3, fast=True)
    assert ours_fast.shape == ours_f32.shape == jax_fast.shape and np.isfinite(ours_fast).all()
    ours, theirs = np.abs(ours_fast - ours_f32).max(), np.abs(jax_fast - jax_f32).max()
    assert 0 < ours <= 2 * theirs, f"port max|fast - f32| = {ours:.3e}, JAX {theirs:.3e}"
    assert ttts._dec_cache["dtype"] == torch.bfloat16
    path = tmp_path / "tts.wav"
    assert ttts.tts_batched(TEXT, str(path), 1, seed=3, fast=True) is None and path.stat().st_size > 0
    # bf16: the batched decode runs the stock layers at B = 2 where tts runs
    # them at B = 1, which may sum in another order and flip a rounding
    batched = ttts.tts_batched(TEXT, None, 1, seed=3, fast=True)
    np.testing.assert_allclose(batched, ours_fast, atol=2.0 ** -6 * float(np.abs(ours_fast).max()))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, None)], ids=["f32", "bf16"])
@torch.inference_mode()
def test_padded_group_equals_each_row_alone_on_the_kernel_route(tts_pair, dtype, atol):
    """A frame-bucket group of two sentences of different token and frame
    lengths, stacked as tts_batched stacks them (padded tokens have duration
    0), decodes each row as it decodes alone; audio past each row's length is
    0.  The f32 cache runs the route's algebra without rounding."""
    params, _, ttts = tts_pair
    model, cache = dec_cache_from_jax(params, torch_cfg(TINY_TTS_TAIL), dtype)
    fast = dtype == torch.bfloat16
    rows = []
    for seed, n in ((14, 19), (15, 12)):
        tokens, lengths, noise_w = _token_case(seed, [n], n, TINY_TTS_TAIL["n_vocab"])
        enc = TS.tts_encode(model, t(tokens), t(lengths), torch.tensor([2]), t(noise_w))
        rows.append({k: getattr(enc, k)[0] for k in ("m_p", "logs_p", "x_mask", "w_ceil")})
    g_row = model.emb_g.weight[2][None]
    mf = 64
    frames = [int(r["w_ceil"].sum()) for r in rows]
    assert frames[0] != frames[1] and max(frames) <= mf
    noise = torch.from_numpy(np.random.default_rng(16).standard_normal((2, mf, TINY_TTS_TAIL["inter_channels"]))
                             .astype(np.float32))
    both, _ = TS.tts_decode(model, _stack_enc_rows(rows, [0, 1], g_row), mf, noise, fast=fast, dec_cache=cache)
    up = torch_cfg(TINY_TTS_TAIL).upsample_factor
    for r in range(2):
        alone, _ = TS.tts_decode(model, _stack_enc_rows(rows, [r], g_row), mf, noise[r:r + 1], fast=fast,
                                 dec_cache=cache)
        n = frames[r] * up
        assert bool((both[r, n + 3:] == 0).all()), "audio past the length (and conv_post's reach) must be 0"
        bar = atol if atol is not None else 2.0 ** -6 * float(alone.abs().max())
        np.testing.assert_allclose(both[r, :n].numpy(), alone[0, :n].numpy(), atol=bar)
    if not fast:
        ref, _ = TS.tts_decode(model, _stack_enc_rows(rows, [0, 1], g_row), mf, noise)
        np.testing.assert_allclose(both.numpy(), ref.numpy(), atol=2e-5)


@torch.inference_mode()
def test_infer_is_encode_then_decode_with_seeded_noise(golden_weights):
    """`infer` draws both noises from numpy generators spawned from its seed
    and returns the audio with its true sample counts."""
    _, model = golden_weights
    tokens, lengths, _ = _token_case(19, [12, 7], 12, TINY_TTS["n_vocab"])
    audio, samples = TS.infer(model, t(tokens), t(lengths), torch.tensor([0, 1]), seed=5)
    rng_w, rng_y = (np.random.default_rng(ss) for ss in np.random.SeedSequence(5).spawn(2))
    enc = TS.tts_encode(model, t(tokens), t(lengths), torch.tensor([0, 1]),
                        t(rng_w.standard_normal((2, 12, 2)).astype(np.float32)))
    mf = audio.shape[1] // torch_cfg(TINY_TTS).upsample_factor
    assert mf >= int(enc.w_ceil.sum(1).max())
    noise = rng_y.standard_normal((2, mf, TINY_TTS["inter_channels"])).astype(np.float32)
    ref, y_mask = TS.tts_decode(model, enc, mf, t(noise))
    np.testing.assert_array_equal(audio, ref[..., 0].numpy())
    np.testing.assert_array_equal(samples, y_mask[..., 0].sum(1).numpy() * torch_cfg(TINY_TTS).upsample_factor)


@torch.inference_mode()
def test_decode_without_a_speaker_on_the_kernel_route(tts_pair):
    """sid=None leaves g None: no conditioning anywhere, on stock layers and
    on the kernel route (an f32 cache, exact algebra) alike."""
    params, _, _ = tts_pair
    model, cache = dec_cache_from_jax(params, torch_cfg(TINY_TTS_TAIL), torch.float32)
    tokens, lengths, noise_w = _token_case(20, [14], 14, TINY_TTS_TAIL["n_vocab"])
    enc = TS.tts_encode(model, t(tokens), t(lengths), None, t(noise_w))
    assert enc.g is None
    noise = t(np.random.default_rng(21).standard_normal((1, 64, TINY_TTS_TAIL["inter_channels"])).astype(np.float32))
    ref, _ = TS.tts_decode(model, enc, 64, noise)
    out, _ = TS.tts_decode(model, enc, 64, noise, dec_cache=cache)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="make_dec_cache"):
        TS.tts_decode(model, enc, 64, noise, fast=True)
