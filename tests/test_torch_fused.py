"""The fused TTS → convert chains of the port against the JAX package's:
`tts_decode_convert` and `tts_synthesize_convert` (audio, decoded frames and
uncapped duration sums), the API's `tts_convert_batched`,
`tts_convert_single_dispatch` (and its overflow fallback) and
`tts_convert_stream`, with the watermark off, in f32; the chain against the
staged truth; and that the one-call chain reads nothing back to the host
(CPU; every kernel wrapper runs its plain version; JAX init weights through
the bridge)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu import api as japi
from openvoice_tpu.models import synthesizer as JS
from openvoice_tpu_torch import api as tapi
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude
from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket
from tests._torch_port import TINY, TINY_TAIL, TINY_TTS_TAIL, jax_cfg, jax_params, t, torch_cfg, torch_model

AUDIO_TOL = 5e-4
# a TTS whose decoder upsamples by 16 and a converter whose hop is 16: the
# fused chain needs base frames to map 1:1 to conversion frames
TTS, CONV = TINY_TTS_TAIL, TINY_TAIL
TEXT = ("The weather is nice today and we should go for a walk. "
        "Later we can have dinner together with our friends. "
        "Tomorrow there is work to be done in the garden.")


@pytest.fixture(scope="module")
def pair():
    """(JAX TTS, JAX converter, port TTS, port converter) on the same
    weights, the watermark off."""
    tp, cp = jax_params(TTS, seed=3), jax_params(CONV, seed=4)
    jt = japi.BaseSpeakerTTS(cfg=jax_cfg(TTS))
    jt.params = tp
    jc = japi.ToneColorConverter(cfg=jax_cfg(CONV), enable_watermark=False)
    jc.params = cp
    tt = tapi.BaseSpeakerTTS(cfg=torch_cfg(TTS), device="cpu")
    tt.set_model(torch_model(TTS, tp))
    tc = tapi.ToneColorConverter(cfg=torch_cfg(CONV), device="cpu", enable_watermark=False)
    tc.set_model(torch_model(CONV, cp))
    return jt, jc, tt, tc


@pytest.fixture(scope="module")
def ses():
    rng = np.random.default_rng(2)
    return (rng.standard_normal((1, CONV["gin_channels"], 1)).astype(np.float32),
            rng.standard_normal((1, CONV["gin_channels"], 1)).astype(np.float32))


def _close(out, ref, atol=AUDIO_TOL):
    """The audio bar, and (the random decoder's audio is quiet) 1e-3 of the
    peak beside it."""
    assert out.shape == ref.shape
    peak = float(np.abs(ref).max())
    assert peak > 0
    np.testing.assert_allclose(out, ref, atol=atol)
    assert float(np.abs(out - ref).max()) <= 1e-3 * peak


def _tokens(rng, lengths, t_max):
    toks = np.zeros((len(lengths), t_max), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, TTS["n_vocab"], n)
    return toks


@torch.inference_mode()
def test_tts_decode_convert_matches_jax(pair):
    """Both packages decode JAX's encode (the same duration ceilings) and
    convert the base audio on the device."""
    jt, jc, tt, tc = pair
    rng = np.random.default_rng(11)
    lengths, tb = [40, 27], 64
    toks = _tokens(rng, lengths, tb)
    noise_w = rng.standard_normal((2, tb, 2)).astype(np.float32)
    enc = JS.tts_encode_jit(jt.params, jt.cfg, jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray([1, 1]), None,
                        noise_w=jnp.asarray(noise_w))
    fb = round_up_to_bucket(int(np.asarray(enc.w_ceil).sum(-1).max()))
    noise_dec = rng.standard_normal((2, fb, TTS["inter_channels"])).astype(np.float32)
    noise_conv = rng.standard_normal((2, fb, CONV["inter_channels"])).astype(np.float32)
    g_s = rng.standard_normal((2, 1, CONV["gin_channels"])).astype(np.float32)
    g_t = rng.standard_normal((2, 1, CONV["gin_channels"])).astype(np.float32)
    ref, ref_mask = JS.tts_decode_convert_jit(jt.params, jt.cfg, enc, fb, jnp.asarray(noise_dec), jc.params, jc.cfg,
                                          jnp.asarray(g_s), jnp.asarray(g_t), 0.3, jnp.asarray(noise_conv))
    t_enc = TS.TTSEncodeOut(*(t(np.asarray(a)) for a in enc))
    out, mask = TS.tts_decode_convert(tt.model, t_enc, fb, t(noise_dec), tc.model, t(g_s), t(g_t), 0.3,
                                      t(noise_conv))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    _close(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="upsample == converter hop"):
        TS.tts_decode_convert(tt.model, t_enc, fb, t(noise_dec), TS.Synthesizer(torch_cfg(TINY)), t(g_s), t(g_t),
                              0.3, t(noise_conv))


@pytest.mark.parametrize("max_frames", [128, 64], ids=["uncapped", "capped"])
@torch.inference_mode()
def test_tts_synthesize_convert_matches_jax(pair, max_frames):
    """Text → cloned audio in one call; at 64 frames the long row passes
    the cap, is truncated, and says so through its uncapped sum."""
    jt, jc, tt, tc = pair
    rng = np.random.default_rng(12)
    lengths, tb = [44, 30], 64
    toks = _tokens(rng, lengths, tb)
    noise_w = rng.standard_normal((2, tb, 2)).astype(np.float32)
    noise_dec = rng.standard_normal((2, max_frames, TTS["inter_channels"])).astype(np.float32)
    noise_conv = rng.standard_normal((2, max_frames, CONV["inter_channels"])).astype(np.float32)
    g_s = rng.standard_normal((2, 1, CONV["gin_channels"])).astype(np.float32)
    g_t = rng.standard_normal((2, 1, CONV["gin_channels"])).astype(np.float32)
    ref, ref_frames, ref_total = JS.tts_synthesize_convert_jit(
        jt.params, jt.cfg, jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray([2, 2]), jnp.asarray(noise_w),
        max_frames, jnp.asarray(noise_dec), jc.params, jc.cfg, jnp.asarray(g_s), jnp.asarray(g_t), 0.3,
        jnp.asarray(noise_conv), length_scale=1.1)
    out, frames, total = TS.tts_synthesize_convert(
        tt.model, t(toks), torch.tensor(lengths), torch.tensor([2, 2]), t(noise_w), max_frames, t(noise_dec),
        tc.model, t(g_s), t(g_t), 0.3, t(noise_conv), length_scale=1.1)
    assert frames.dtype == total.dtype == torch.int32
    np.testing.assert_array_equal(total.numpy(), np.asarray(ref_total))
    np.testing.assert_array_equal(frames.numpy(), np.asarray(ref_frames))
    np.testing.assert_array_equal(frames.numpy(), np.minimum(total.numpy(), max_frames))
    assert (total.numpy() > max_frames).any() == (max_frames == 64)
    _close(out.numpy(), np.asarray(ref))


def test_the_one_call_chain_reads_nothing_back(pair, monkeypatch):
    """Between the encode and the returned tensors nothing goes to the host:
    every host read a tensor offers raises inside the call."""
    _, _, tt, tc = pair
    rng = np.random.default_rng(13)
    args = (tt.model, t(_tokens(rng, [20], 32)), torch.tensor([20]), torch.tensor([0]),
            t(rng.standard_normal((1, 32, 2)).astype(np.float32)), 64,
            t(rng.standard_normal((1, 64, TTS["inter_channels"])).astype(np.float32)), tc.model,
            torch.zeros(1, 1, CONV["gin_channels"]), torch.ones(1, 1, CONV["gin_channels"]), 0.3,
            t(rng.standard_normal((1, 64, CONV["inter_channels"])).astype(np.float32)))

    def host_read(*_args, **_kwargs):
        raise AssertionError("the chain read a tensor back to the host")

    with torch.inference_mode():
        for fast in (False, True):
            cache_t = TS.make_dec_cache(tt.model) if fast else None
            cache_c = TS.make_dec_cache(tc.model) if fast else None
            with monkeypatch.context() as m:
                for name in ("item", "tolist", "cpu", "numpy", "__int__", "__float__", "__bool__", "__index__"):
                    m.setattr(torch.Tensor, name, host_read)
                out = TS.tts_synthesize_convert(*args, fast=fast, tts_dec_cache=cache_t, conv_dec_cache=cache_c)
            assert all(torch.isfinite(o.float()).all() for o in out)


def test_tts_convert_batched_matches_jax(pair, ses):
    jt, jc, tt, tc = pair
    src, tgt = ses
    kw = dict(seed=7, fast=False, message="")
    ref = japi.tts_convert_batched(jt, jc, TEXT, 1, src, tgt, **kw)
    out = tapi.tts_convert_batched(tt, tc, TEXT, 1, src, tgt, **kw)
    _close(out, ref)
    np.testing.assert_array_equal(out, tapi.tts_convert_batched(tt, tc, TEXT, 1, src, tgt, **kw))


def test_tts_convert_batched_equals_the_staged_truth(pair, ses):
    """One sentence: `tts_batched` base audio → host reflect pad → STFT →
    `voice_conversion` with the chain's conversion noise, then the gap."""
    _, _, tt, tc = pair
    src, tgt = ses
    text, seed, tau = "hello there my good friend", 5, 0.3
    fused = tapi.tts_convert_batched(tt, tc, text, 0, src, tgt, tau=tau, seed=seed, fast=False, message="")
    base = tt.tts_batched(text, None, 0, seed=seed)
    gap = int(tt.cfg.sampling_rate * 0.05)
    piece = base[:-gap]
    cfg = tc.cfg
    n_frames = len(piece) // cfg.hop_length
    fb = round_up_to_bucket(n_frames)
    padded, nf = tapi._spec_from_audio(piece, cfg)
    assert nf == n_frames and len(piece) % cfg.hop_length == 0
    spec = torch.zeros(1, fb, cfg.spec_channels)
    spec[0, :n_frames] = stft_magnitude(t(padded)[None], cfg.filter_length, cfg.hop_length,
                                        cfg.win_length)[0, :n_frames]
    noise = tapi._sentence_conv_rngs(seed, 1)[0].standard_normal((fb, cfg.inter_channels)).astype(np.float32)
    with torch.inference_mode():
        audio, _ = TS.voice_conversion(tc.model, spec, torch.tensor([n_frames]), tc._as_g(src), tc._as_g(tgt), tau,
                                       t(noise)[None])
    staged = np.concatenate([audio[0, : n_frames * cfg.upsample_factor, 0].numpy(), np.zeros(gap, np.float32)])
    assert fused.shape == staged.shape
    np.testing.assert_allclose(fused, staged, atol=5e-5)
    assert float(np.abs(fused - staged).max()) <= 1e-3 * float(np.abs(staged).max())


def test_single_dispatch_and_its_overflow_fallback_match_jax(pair, ses):
    """Capped at 6 frames a token, then at 0.05, where every sentence
    overflows and re-runs through the two-stage chain: that equals
    `tts_convert_batched` (the staged draws)."""
    jt, jc, tt, tc = pair
    src, tgt = ses
    kw = dict(seed=3, fast=False, message="")
    stats: dict = {}
    out = tapi.tts_convert_single_dispatch(tt, tc, TEXT, 0, src, tgt, stats=stats, **kw)
    _close(out, japi.tts_convert_single_dispatch(jt, jc, TEXT, 0, src, tgt, **kw))
    n = len(tt._sentence_tokens(TEXT, 0, "English")[0])
    assert n >= 2 and stats == {"sentences": n, "overflow_sentences": 0}
    forced = tapi.tts_convert_single_dispatch(tt, tc, TEXT, 0, src, tgt, frames_per_token=0.05, stats=stats, **kw)
    assert stats == {"sentences": n, "overflow_sentences": n}
    staged = tapi.tts_convert_batched(tt, tc, TEXT, 0, src, tgt, **kw)
    assert forced.shape == staged.shape
    np.testing.assert_allclose(forced, staged, atol=1e-6)
    _close(forced, japi.tts_convert_single_dispatch(jt, jc, TEXT, 0, src, tgt, frames_per_token=0.05, **kw))


def test_stream_matches_jax_and_joins_to_single_dispatch(pair, ses):
    jt, jc, tt, tc = pair
    src, tgt = ses
    kw = dict(seed=9, fast=False, message="")
    chunks = list(tapi.tts_convert_stream(tt, tc, TEXT, 0, src, tgt, **kw))
    ref_chunks = list(japi.tts_convert_stream(jt, jc, TEXT, 0, src, tgt, **kw))
    assert len(chunks) == len(ref_chunks) == len(tt._sentence_tokens(TEXT, 0, "English")[0]) >= 2
    for c, r in zip(chunks, ref_chunks):
        _close(c, r)
    one_shot = tapi.tts_convert_single_dispatch(tt, tc, TEXT, 0, src, tgt, **kw)
    np.testing.assert_allclose(np.concatenate(chunks), one_shot, atol=1e-6)
    overflow = list(tapi.tts_convert_stream(tt, tc, TEXT, 0, src, tgt, frames_per_token=0.05, **kw))
    staged = tapi.tts_convert_batched(tt, tc, TEXT, 0, src, tgt, **kw)
    np.testing.assert_allclose(np.concatenate(overflow), staged, atol=1e-6)


def test_serving_mode_chains(pair, ses):
    """fast=True: both chains through the kernels' plain versions in bf16,
    near their f32 audio, deterministic, and the joined audio watermarked
    once when asked."""
    _, _, tt, tc = pair
    src, tgt = ses
    f32 = tapi.tts_convert_batched(tt, tc, TEXT, 0, src, tgt, seed=4, fast=False, message="")
    fast = tapi.tts_convert_batched(tt, tc, TEXT, 0, src, tgt, seed=4, fast=True, message="")
    assert fast.shape == f32.shape
    assert float(np.abs(fast - f32).max()) <= 0.05 * float(np.abs(f32).max())
    single = tapi.tts_convert_single_dispatch(tt, tc, TEXT, 0, src, tgt, seed=4, fast=True, message="")
    np.testing.assert_array_equal(single, tapi.tts_convert_single_dispatch(tt, tc, TEXT, 0, src, tgt, seed=4,
                                                                           fast=True, message=""))
    tc.enable_watermark = True
    try:
        marked = tapi.tts_convert_batched(tt, tc, TEXT, 0, src, tgt, seed=4, fast=True, message="ovt-cpu1")
        np.testing.assert_array_equal(marked, tc.add_watermark(fast, "ovt-cpu1"))  # once, on the joined audio
    finally:
        tc.enable_watermark = False
