"""The port's CUDA-graph tier (``openvoice_tpu_torch/runtime/graphs.py``) on
the CPU: the key of each site against the JAX package's ``jax.jit`` sites,
each site's body (what a graph captures) against the direct call, the convert
and streaming bodies against JAX, invalidation, launch accounting, and that
the CPU never captures or replays.

There is no card here, so capture and replay go through the stand-ins of
``tests/_torch_graphs.py`` (`fake_graphs`).  The fused chains, the
data-parallel convert and the train steps have their own files
(tests/test_torch_graphs_{chains,train}.py)."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu import api as japi
from openvoice_tpu.api import ToneColorConverter as JaxConverter
from openvoice_tpu.runtime import streaming as jstreaming
from openvoice_tpu_torch import api as tapi
from openvoice_tpu_torch import ops
from openvoice_tpu_torch.api import BaseSpeakerTTS, ToneColorConverter
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.ops import coupling_cuda, stft_cuda, wn_cuda
from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude
from openvoice_tpu_torch.runtime import graphs as G
from openvoice_tpu_torch.runtime.bucketing import DEFAULT_BUCKETS, round_up_to_bucket
from openvoice_tpu_torch.runtime import streaming as tstreaming
from openvoice_tpu_torch.serve import batcher as tbatcher
from tests._torch_graphs import _Graph, _record, fake_graphs, no_cuda_graphs  # noqa: F401 (fixtures)
from tests._torch_port import (
    TINY, TINY_API, TINY_TTS_TAIL, jax_cfg, jax_params, t, torch_cfg, torch_model,
)

SR = 22050
AUDIO_TOL = 5e-4  # the port's audio bar against JAX (f32), as tests/test_torch_convert.py
# TINY_API with its own speaker width: no other test file compiles these
# shapes, so the JAX jit caches below grow only by this file's calls
KEYED = dict(TINY_API, gin_channels=48)
TEXT = "The quick brown fox jumps over the lazy dog. It was a sunny day."


def _voice(seconds: float, f0: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * SR)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * tt))) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 2.5 * tt), 0, None) ** 0.5
    return (0.3 * x * env + 0.005 * rng.standard_normal(len(tt))).astype(np.float32)


def _recording(cache: G.GraphCache, monkeypatch) -> list:
    """Record every key `cache.run` is called with."""
    keys, real = [], cache.run

    def run(key, body, inputs, consume=None):
        keys.append(key)
        return real(key, body, inputs, consume)

    monkeypatch.setattr(cache, "run", run)
    return keys


@pytest.fixture(scope="module")
def keyed_pair():
    params = jax_params(KEYED, seed=51)
    jconv = JaxConverter(cfg=jax_cfg(KEYED), enable_watermark=False)
    jconv.params = params
    tconv = ToneColorConverter(cfg=torch_cfg(KEYED), device="cpu", enable_watermark=False)
    tconv.set_model(torch_model(KEYED, params))
    return jconv, tconv


@pytest.fixture(scope="module")
def tts_model():
    tts = BaseSpeakerTTS(cfg=torch_cfg(TINY_TTS_TAIL), device="cpu")
    tts.set_model(torch_model(TINY_TTS_TAIL, jax_params(TINY_TTS_TAIL, seed=13)))
    return tts


# -- (a) keys --------------------------------------------------------------------

def test_convert_and_tone_color_keys_follow_the_jax_sites(keyed_pair, monkeypatch):
    """Two clips of one bucket share a key, another bucket or mode gets its
    own, as ``_jit_convert`` (static cfg and fast, shapes by bucket) compiles
    once per bucket; extract_se's key takes the batch, as
    ``_jit_tone_color``'s shapes do."""
    jconv, tconv = keyed_pair
    keys = _recording(tconv.graphs, monkeypatch)
    se = np.random.default_rng(3).standard_normal((1, KEYED["gin_channels"], 1)).astype(np.float32)
    clips = [_voice(1.6, 140.0, 1), _voice(1.8, 150.0, 2), _voice(3.5, 160.0, 3)]
    buckets = [round_up_to_bucket(tapi._spec_from_audio(c, tconv.cfg)[1]) for c in clips]
    assert buckets[0] == buckets[1] != buckets[2]
    before = japi._jit_convert._cache_size()
    for clip in clips:
        tconv.convert(clip, se, se, message="")
        jconv.convert(clip, se, se, message="")
    assert keys[0] == keys[1] == G.GraphKey("convert", bucket=buckets[0], batch=1, fast=False)
    assert keys[2] == G.GraphKey("convert", bucket=buckets[2], batch=1, fast=False)
    assert japi._jit_convert._cache_size() - before == len(set(keys)) == 2
    tconv.convert(clips[0], se, se, message="", fast=True)
    assert keys[3] == keys[0]._replace(fast=True)

    before = japi._jit_tone_color._cache_size()
    for batch in ([clips[0]], [clips[1]], [clips[0], clips[1]]):
        tconv._se_from_audio_batch(batch)
        jconv._se_from_audio_batch(batch)
    tone = keys[4:]
    assert tone[0] == tone[1] == G.GraphKey("tone_color", bucket=buckets[0], batch=1)
    assert tone[2] == G.GraphKey("tone_color", bucket=buckets[0], batch=2)
    assert japi._jit_tone_color._cache_size() - before == len(set(tone)) == 2


def test_streaming_chunk_key_follows_run_chunk(keyed_pair, monkeypatch):
    """One window graph per (batch, halo + chunk + halo, fast), whatever the
    length, as ``_run_chunk`` compiles once per chunk_frames."""
    jconv, tconv = keyed_pair
    keys = _recording(tconv.graphs, monkeypatch)
    rng = np.random.default_rng(4)
    cfg = KEYED
    g = rng.standard_normal((1, 1, cfg["gin_channels"])).astype(np.float32)
    before = jstreaming._run_chunk._cache_size()
    for n, chunk in ((50, 24), (70, 24), (50, 16)):
        spec = np.abs(rng.standard_normal((1, n, cfg["spec_channels"]))).astype(np.float32)
        noise = rng.standard_normal((1, n, cfg["inter_channels"])).astype(np.float32)
        tstreaming.voice_conversion_streaming(tconv.model, spec, [n], g, g, 0.3, noise, chunk_frames=chunk,
                                              graphs=tconv.graphs)
        jstreaming.voice_conversion_streaming(jconv.params, jconv.cfg, spec, np.asarray([n]), jnp.asarray(g),
                                              jnp.asarray(g), 0.3, noise, chunk_frames=chunk)
    halo = tstreaming.required_halo(tconv.cfg)
    assert set(keys) == {G.GraphKey("stream_chunk", bucket=24 + 2 * halo, batch=1, fast=False, chunk_frames=24),
                         G.GraphKey("stream_chunk", bucket=16 + 2 * halo, batch=1, fast=False, chunk_frames=16)}
    assert jstreaming._run_chunk._cache_size() - before == 2


def test_tts_keys_take_token_and_frame_buckets(tts_model, monkeypatch):
    """tts: one encode key per token bucket and batch (``tts_encode_jit``),
    one decode key per (token length, frame bucket, batch, fast)
    (``tts_decode_jit``: static max_frames and fast, the rest shapes)."""
    keys = _recording(tts_model.graphs, monkeypatch)
    tts_model.tts(TEXT, None, 1, seed=3)
    tokens, _ = tts_model._sentence_tokens(TEXT, 1, "English")
    enc = [k for k in keys if k.site == "tts_encode"]
    dec = [k for k in keys if k.site == "tts_decode"]
    assert len(enc) == len(dec) == len(tokens) >= 1
    for k, seq in zip(enc, tokens):
        assert k == G.GraphKey("tts_encode", bucket=round_up_to_bucket(len(seq)), batch=1)
    for k, e in zip(dec, enc):
        assert (k.bucket, k.batch, k.fast) == (e.bucket, 1, False) and k.max_frames in DEFAULT_BUCKETS
    keys.clear()
    tts_model.tts_batched(TEXT, None, 1, seed=3, fast=True)
    assert {k.batch for k in keys} <= {1, 2} and all(k.fast for k in keys if k.site == "tts_decode")


def test_batcher_group_keys_take_mode_bucket_batch_and_fast(monkeypatch):
    cfg = torch_cfg(TINY)
    model = torch_model(TINY, jax_params(TINY, seed=5))
    b = tbatcher.ConvertBatcher(model, cfg, max_batch=2, max_wait_ms=5.0, device="cpu")
    keys = _recording(b.graphs, monkeypatch)
    rng = np.random.default_rng(6)
    inputs = dict(lengths=np.asarray([40, 33]), g_src=np.zeros((2, 1, cfg.gin_channels), np.float32),
                  g_tgt=np.zeros((2, 1, cfg.gin_channels), np.float32), taus=np.zeros((2, 1, 1), np.float32))
    pcm = (rng.standard_normal((2, 63 * cfg.hop_length + cfg.filter_length)) * 3000).astype(np.int16)
    with torch.inference_mode():
        b._run_group(64, {**inputs, "pcm": pcm, "noise": tbatcher.row_noise([1, 2], 64, cfg.inter_channels,
                                                                             torch.device("cpu"))})
        spec = np.abs(rng.standard_normal((2, 64, cfg.spec_channels))).astype(np.float32)
        b._run_group(64, {**inputs, "spec": spec, "noise": np.zeros((2, 64, cfg.inter_channels), np.float32)})
    assert keys == [G.GraphKey("batch_pcm", bucket=64, batch=2, fast=False),
                    G.GraphKey("batch_spec", bucket=64, batch=2, fast=False)]


# -- (b) each body on its static buffers, filled twice, equals the direct call -----

def _filled_twice(body, cases: list[dict], direct) -> None:
    """Static buffers made once from the first case, filled with each case
    in turn (`graphs.stage`), the body run on them: exactly the direct
    call's result (``direct(case index)``) each time."""
    static = {k: torch.empty(tuple(G._as_tensor(v).shape), dtype=G._as_tensor(v).dtype)
              for k, v in cases[0].items()}
    for i, case in enumerate(cases):
        G.stage(static, case)
        got, want = G._tensors(body(**static)), G._tensors(direct(i))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _convert_case(cfg, rng, n: int, bucket: int, tau: float) -> dict:
    buf = np.zeros((1, (bucket - 1) * cfg.hop_length + cfg.filter_length), np.float32)
    buf[0, : (n - 1) * cfg.hop_length + cfg.filter_length] = rng.standard_normal(
        (n - 1) * cfg.hop_length + cfg.filter_length) * 0.3
    return {"audio": buf, "lengths": np.asarray([n], np.int64),
            "g_src": rng.standard_normal((1, 1, cfg.gin_channels)).astype(np.float32),
            "g_tgt": rng.standard_normal((1, 1, cfg.gin_channels)).astype(np.float32),
            "tau": np.full((1, 1, 1), tau, np.float32),
            "noise": rng.standard_normal((1, bucket, cfg.inter_channels)).astype(np.float32)}


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "serving"])
@torch.inference_mode()
def test_convert_body_filled_twice_equals_voice_conversion(keyed_pair, fast):
    _, tconv = keyed_pair
    cfg, model = tconv.cfg, tconv.model
    cache = TS.make_dec_cache(model) if fast else None
    rng = np.random.default_rng(7)
    cases = [_convert_case(cfg, rng, 50, 64, 0.3), _convert_case(cfg, rng, 37, 64, 0.7)]

    def direct(c):
        spec = stft_magnitude(t(c["audio"]), cfg.filter_length, cfg.hop_length, cfg.win_length)
        out, _ = TS.voice_conversion(model, spec, t(c["lengths"]), t(c["g_src"]), t(c["g_tgt"]),
                                     float(c["tau"][0, 0, 0]), t(c["noise"]), fast=fast, dec_cache=cache)
        return out

    _filled_twice(partial(tapi.convert_body, model, cfg, fast, cache), cases, lambda i: direct(cases[i]))


@torch.inference_mode()
def test_tone_color_body_filled_twice_equals_extract_tone_color(keyed_pair):
    _, tconv = keyed_pair
    cfg, model = tconv.cfg, tconv.model
    rng = np.random.default_rng(8)
    cases = []
    for lengths in ([64, 40], [23, 61]):
        c = _convert_case(cfg, rng, 64, 64, 0.0)
        cases.append({"audio": np.concatenate([c["audio"], c["audio"][:, ::-1].copy()]),
                      "lengths": np.asarray(lengths, np.int64)})

    def direct(c):
        spec = stft_magnitude(t(c["audio"]), cfg.filter_length, cfg.hop_length, cfg.win_length)
        return TS.extract_tone_color(model, spec, t(c["lengths"]))

    _filled_twice(partial(tapi.tone_color_body, model, cfg), cases, lambda i: direct(cases[i]))


@pytest.mark.parametrize("mode", ["pcm", "spec"])
@torch.inference_mode()
def test_group_body_filled_twice_equals_the_eager_group(mode):
    cfg = torch_cfg(TINY)
    model = torch_model(TINY, jax_params(TINY, seed=9))
    rng = np.random.default_rng(10)
    cases, seeds_of = [], ([3, 4], [7, 0])
    for (lengths, taus), seeds in zip((([64, 20], [0.3, 0.5]), ([41, 0], [0.8, 0.0])), seeds_of):
        case = {"lengths": np.asarray(lengths, np.int64),
                "g_src": rng.standard_normal((2, 1, cfg.gin_channels)).astype(np.float32),
                "g_tgt": rng.standard_normal((2, 1, cfg.gin_channels)).astype(np.float32),
                "taus": np.asarray(taus, np.float32).reshape(2, 1, 1)}
        if mode == "pcm":
            pcm = (rng.standard_normal((2, 63 * cfg.hop_length + cfg.filter_length)) * 3000).astype(np.int16)
            case.update(pcm=pcm, noise=tbatcher.row_noise(seeds, 64, cfg.inter_channels, torch.device("cpu")))
        else:
            case.update(spec=np.abs(rng.standard_normal((2, 64, cfg.spec_channels))).astype(np.float32),
                        noise=rng.standard_normal((2, 64, cfg.inter_channels)).astype(np.float32))
        cases.append(case)

    def direct(i):
        c = cases[i]
        if mode == "pcm":  # the batcher's eager PCM call, its noise drawn inside from the seeds
            return tbatcher._convert_pcm16(model, cfg, t(c["pcm"]), t(c["lengths"]), t(c["g_src"]),
                                           t(c["g_tgt"]), t(c["taus"]), seeds_of[i])
        audio, _ = TS.voice_conversion(model, t(c["spec"]), t(c["lengths"]), t(c["g_src"]), t(c["g_tgt"]),
                                       t(c["taus"]), t(c["noise"]))
        return tbatcher._wire_int16(audio)

    _filled_twice(partial(tbatcher.group_body, model, cfg, False, None), cases, direct)


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "serving"])
@torch.inference_mode()
def test_chunk_body_filled_twice_equals_voice_conversion_masked(keyed_pair, fast):
    _, tconv = keyed_pair
    cfg, model = tconv.cfg, tconv.model
    cache = TS.make_dec_cache(model) if fast else None
    rng = np.random.default_rng(11)
    cases = []
    for n, tau in ((40, 0.3), (17, 0.6)):
        cases.append({"spec": np.abs(rng.standard_normal((1, 48, cfg.spec_channels))).astype(np.float32),
                      "mask": (np.arange(48) < n).astype(np.float32)[None, :, None],
                      "g_src": t(rng.standard_normal((1, 1, cfg.gin_channels)).astype(np.float32)),
                      "g_tgt": t(rng.standard_normal((1, 1, cfg.gin_channels)).astype(np.float32)),
                      "tau": np.full((1, 1, 1), tau, np.float32),
                      "noise": rng.standard_normal((1, 48, cfg.inter_channels)).astype(np.float32)})

    def direct(c):
        return TS.voice_conversion_masked(model, t(c["spec"]), t(c["mask"]), c["g_src"], c["g_tgt"],
                                          float(c["tau"][0, 0, 0]), t(c["noise"]), fast=fast, dec_cache=cache)

    _filled_twice(partial(tstreaming.chunk_body, model, fast, cache), cases, lambda i: direct(cases[i]))


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "serving"])
@torch.inference_mode()
def test_tts_bodies_filled_twice_equal_encode_and_decode(tts_model, fast):
    model, cfg = tts_model.model, tts_model.cfg
    cache = TS.make_dec_cache(model) if fast else None
    rng = np.random.default_rng(12)
    enc_cases, dec_cases = [], []
    for lengths, sids, speed in (([20, 13], [1, 2], 1.0), ([7, 20], [3, 0], 0.8)):
        tokens = np.zeros((2, 32), np.int32)
        for r, n in enumerate(lengths):
            tokens[r, :n] = rng.integers(1, cfg.n_vocab, n)
        enc_cases.append({"tokens": tokens, "lengths": np.asarray(lengths, np.int64),
                          "sid": np.asarray(sids, np.int64),
                          "noise_w": rng.standard_normal((2, 32, 2)).astype(np.float32),
                          "noise_scale_w": np.float32(tapi.NOISE_SCALE_W), "length_scale": np.float32(1.0 / speed),
                          "sdp_ratio": np.float32(tapi.SDP_RATIO)})

    def encode(c):
        return tuple(TS.tts_encode(model, t(c["tokens"]), t(c["lengths"]), t(c["sid"]), t(c["noise_w"]),
                                   noise_scale_w=tapi.NOISE_SCALE_W, length_scale=float(c["length_scale"]),
                                   sdp_ratio=tapi.SDP_RATIO))

    _filled_twice(partial(tapi.tts_encode_body, model), enc_cases, lambda i: encode(enc_cases[i]))
    for c in enc_cases:
        m_p, logs_p, x_mask, w_ceil, g = encode(c)
        dec_cases.append({"m_p": m_p, "logs_p": logs_p, "x_mask": x_mask, "w_ceil": w_ceil, "g": g,
                          "noise": rng.standard_normal((2, 128, cfg.inter_channels)).astype(np.float32),
                          "noise_scale": np.float32(tapi.NOISE_SCALE)})

    def decode(c):
        enc = TS.TTSEncodeOut(c["m_p"], c["logs_p"], c["x_mask"], c["w_ceil"], c["g"])
        return TS.tts_decode(model, enc, 128, t(c["noise"]), noise_scale=tapi.NOISE_SCALE, fast=fast,
                             dec_cache=cache)

    _filled_twice(partial(tapi.tts_decode_body, model, 128, fast, cache), dec_cases, lambda i: decode(dec_cases[i]))


# -- (c) through the replays, against JAX ----------------------------------------------

def test_convert_replays_match_jit_convert(keyed_pair, fake_graphs):
    """convert of two clips of one bucket on a stand-in graph (the first
    captures, the second replays it) against ``_jit_convert`` on the same
    numpy inputs (f32, 5e-4)."""
    jconv, tconv = keyed_pair
    tconv.graphs.clear()
    rng = np.random.default_rng(13)
    cfg = tconv.cfg
    for n, tau in ((61, 0.3), (44, 0.8)):
        case = _convert_case(cfg, rng, n, 64, tau)
        with torch.inference_mode():
            out = tconv.graphs.run(G.GraphKey("convert", bucket=64, batch=1, fast=False),
                                   partial(tapi.convert_body, tconv.model, cfg, False, None), case)
        ref = japi._jit_convert(jconv.params, jconv.cfg, jnp.asarray(case["audio"]), jnp.asarray(case["lengths"]),
                                jnp.asarray(case["g_src"]), jnp.asarray(case["g_tgt"]), jnp.asarray(case["tau"]),
                                jnp.asarray(case["noise"]))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=AUDIO_TOL)
    assert (tconv.graphs.captures, tconv.graphs.replays) == (1, 1)
    se = rng.standard_normal((1, cfg.gin_channels, 1)).astype(np.float32)
    clip = _voice(1.7, 140.0, 14)
    for seed in (1, 2):  # the API's own path: the second call replays its first call's graph
        np.testing.assert_allclose(tconv.convert(clip, se, se[:, ::-1].copy(), seed=seed, message=""),
                                   jconv.convert(clip, se, se[:, ::-1].copy(), seed=seed, message=""),
                                   atol=AUDIO_TOL)
    assert tconv.graphs.replays == 2
    tconv.graphs.clear()


def test_streaming_replays_match_jax_streaming(keyed_pair, fake_graphs):
    """A padded B = 2 batch in 24-frame windows, every window after the
    first a replay of the stand-in graph, against JAX's
    ``voice_conversion_streaming`` (f32, the streaming suite's bar)."""
    jconv, tconv = keyed_pair
    cache = G.GraphCache("cpu")
    cfg = KEYED
    rng = np.random.default_rng(15)
    lengths, n = np.asarray([100, 77]), 100
    spec = np.abs(rng.standard_normal((2, n, cfg["spec_channels"]))).astype(np.float32)
    spec[1, 77:] = 0
    noise = rng.standard_normal((2, n, cfg["inter_channels"])).astype(np.float32)
    g_s = rng.standard_normal((2, 1, cfg["gin_channels"])).astype(np.float32)
    g_t = rng.standard_normal((2, 1, cfg["gin_channels"])).astype(np.float32)
    ref = jstreaming.voice_conversion_streaming(jconv.params, jconv.cfg, spec, lengths, jnp.asarray(g_s),
                                                jnp.asarray(g_t), 0.3, noise, chunk_frames=24)
    out = tstreaming.voice_conversion_streaming(tconv.model, spec, lengths, t(g_s), t(g_t), 0.3, noise,
                                                chunk_frames=24, graphs=cache)
    assert (cache.captures, cache.replays) == (1, 4)
    assert out.shape == ref.shape == (2, n * 64, 1)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=1e-4)
    eager = tstreaming.voice_conversion_streaming(tconv.model, spec, lengths, t(g_s), t(g_t), 0.3, noise,
                                                  chunk_frames=24)
    np.testing.assert_array_equal(out, eager)


def test_tts_and_batcher_replays_equal_their_eager_calls(tts_model, fake_graphs):
    """tts and tts_batched in both modes, and the batcher's groups, replayed
    on the stand-in: each repeat captures nothing and equals the eager call
    exactly."""
    for fast in (False, True):
        for fn in (tts_model.tts, tts_model.tts_batched):
            first = fn(TEXT, None, 1, seed=5, fast=fast)
            captures = tts_model.graphs.captures
            again = fn(TEXT, None, 1, seed=5, fast=fast)
            assert tts_model.graphs.captures == captures and tts_model.graphs.replays > 0
            tts_model.graphs.enabled = False
            try:
                eager = fn(TEXT, None, 1, seed=5, fast=fast)
            finally:
                tts_model.graphs.enabled = True
            np.testing.assert_array_equal(again, eager)
            np.testing.assert_array_equal(first, eager)
    tts_model.graphs.clear()

    cfg = torch_cfg(TINY)
    model = torch_model(TINY, jax_params(TINY, seed=17))
    b = tbatcher.ConvertBatcher(model, cfg, max_batch=2, max_wait_ms=5.0, device="cpu", fast=True)
    rng = np.random.default_rng(18)
    reqs = [dict(audio=_voice(0.05, 150.0 + 10 * k, k)[: 40 * cfg.hop_length], g_src=rng.standard_normal(
        cfg.gin_channels).astype(np.float32), g_tgt=rng.standard_normal(cfg.gin_channels).astype(np.float32),
        tau=0.3, seed=k) for k in range(2)]
    b.start()
    try:
        outs = []
        for enabled in (True, True, False):
            b.graphs.enabled = enabled
            futs = [b.submit(tbatcher.ConvertRequest(**r)) for r in reqs]
            outs.append([f.result(timeout=120) for f in futs])
    finally:
        b.stop()
    assert b.graphs.captures >= 1 and b.graphs.replays >= 1
    for a, c in zip(outs[1], outs[2]):
        np.testing.assert_array_equal(a, c)


# -- (d) invalidation ----------------------------------------------------------------

def test_set_model_load_ckpt_and_init_random_drop_the_graphs(fake_graphs, tmp_path):
    from openvoice_tpu.ckpt.native_io import save_npz

    params = jax_params(TINY_API, seed=19)
    path = str(tmp_path / "conv.npz")
    save_npz(path, params)
    tconv = ToneColorConverter(cfg=torch_cfg(TINY_API), device="cpu", enable_watermark=False)
    se = np.random.default_rng(20).standard_normal((1, TINY_API["gin_channels"], 1)).astype(np.float32)
    clip = _voice(1.2, 150.0, 21)
    for replace in (lambda: tconv.set_model(torch_model(TINY_API, params)), lambda: tconv.load_ckpt(path),
                    lambda: tconv.init_random(3)):
        replace()
        assert len(tconv.graphs) == 0
        first = tconv.convert(clip, se, se, message="", fast=True)
        assert len(tconv.graphs) == 1 and tconv.graphs.keys()[0].fast
        np.testing.assert_array_equal(tconv.convert(clip, se, se, message="", fast=True), first)
    # a rebuilt serving cache drops them too; an in-place update keeps them,
    # and the replay reads the updated weights
    tconv._dec_cache = None
    tconv.convert(clip, se, se, message="")
    tconv._require_dec_cache()
    assert len(tconv.graphs) == 0
    before = tconv.convert(clip, se, se, message="")
    with torch.no_grad():
        tconv.model.dec.conv_post.weight.mul_(2.0)
    after = tconv.convert(clip, se, se, message="")
    assert len(tconv.graphs) == 1 and tconv.graphs.replays >= 1
    tconv.graphs.enabled = False
    np.testing.assert_array_equal(after, tconv.convert(clip, se, se, message=""))
    assert float(np.abs(after - before).max()) > 0


# -- (e) launch accounting -------------------------------------------------------------

def test_a_replay_adds_the_launches_recorded_at_capture(fake_graphs, monkeypatch):
    for module in (wn_cuda, coupling_cuda, stft_cuda):
        monkeypatch.setattr(module, "launches", 0)
    with ops.recording_launches() as tally:
        ops.count_launch(wn_cuda.__name__)
        ops.count_launch(coupling_cuda.__name__)
        ops.count_launch(coupling_cuda.__name__)
        with pytest.raises(RuntimeError, match="already recording"):
            with ops.recording_launches():
                pass
    assert tally == {wn_cuda.__name__: 1, coupling_cuda.__name__: 2}
    assert wn_cuda.launches == coupling_cuda.launches == 0  # recorded, not launched
    ops.count_launch(stft_cuda.__name__)
    assert stft_cuda.launches == 1

    cache = G.GraphCache("cpu")
    graph = _Graph()
    static = {"x": torch.zeros(3)}
    outputs = _record(graph, lambda x: x * 2, static, None, None)
    key = G.GraphKey("convert", bucket=64, batch=1, fast=True, device="cpu")
    cache._graphs[key] = G.CapturedGraph(graph, static, outputs, dict(tally), 0.0)
    for k in (1, 2):
        out = cache.run(key, None, {"x": np.full(3, float(k), np.float32)})
        assert torch.equal(out, torch.full((3,), 2.0 * k)) and out.data_ptr() != outputs.data_ptr()
        assert (wn_cuda.launches, coupling_cuda.launches, stft_cuda.launches) == (k, 2 * k, 1)
    assert graph.replayed == 2 and cache.replays == 2
    with pytest.raises(ValueError, match="against the graph's"):
        cache.run(key, None, {"x": np.zeros(4, np.float32)})


# -- (f) the CPU never captures or replays -------------------------------------------

def test_cpu_entry_points_never_capture_or_replay(keyed_pair, tts_model, no_cuda_graphs, tmp_path):
    from openvoice_tpu_torch.audio.io import write_wav
    from openvoice_tpu_torch.runtime.mesh import make_mesh
    from openvoice_tpu_torch.serve.distributed import DistRequest, DistributedConvertService
    from openvoice_tpu_torch.training.loop import train
    from tests._torch_port import TINY_TAIL

    tconv = ToneColorConverter(cfg=torch_cfg(KEYED), device="cpu", enable_watermark=False)
    tconv.set_model(keyed_pair[1].model)
    tts = BaseSpeakerTTS(cfg=torch_cfg(TINY_TTS_TAIL), device="cpu")
    tts.set_model(tts_model.model)
    path = str(tmp_path / "ref.wav")
    write_wav(path, _voice(1.1, 160.0, 22), SR)
    se = tconv.extract_se([path])
    tconv.convert(_voice(1.3, 150.0, 23), se, se, message="")
    tconv.convert(_voice(1.3, 150.0, 23), se, se, message="", fast=True)
    tconv.convert_streaming(_voice(1.3, 150.0, 23), se, se, message="", chunk_frames=24)
    tts.tts(TEXT, None, 1, fast=True)
    tts.tts_batched(TEXT, None, 1)
    # the fused chains, on a converter whose hop is the TTS's upsampling
    chain_conv = ToneColorConverter(cfg=torch_cfg(TINY_TAIL), device="cpu", enable_watermark=False)
    chain_conv.init_random(0)
    chain_se = np.ones((1, TINY_TAIL["gin_channels"], 1), np.float32)
    for fast in (False, True):
        tapi.tts_convert_batched(tts, chain_conv, TEXT, 1, chain_se, chain_se, fast=fast, message="")
        tapi.tts_convert_single_dispatch(tts, chain_conv, TEXT, 1, chain_se, chain_se, fast=fast, message="")
        list(tapi.tts_convert_stream(tts, chain_conv, TEXT, 1, chain_se, chain_se, fast=fast, message=""))
    cfg = torch_cfg(TINY)
    model = torch_model(TINY, jax_params(TINY, seed=24))
    b = tbatcher.ConvertBatcher(model, cfg, max_batch=2, device="cpu")
    b.start()
    try:
        fut = b.submit(tbatcher.ConvertRequest(audio=_voice(0.1, 150.0, 25), g_src=np.zeros(cfg.gin_channels),
                                               g_tgt=np.zeros(cfg.gin_channels), tau=0.3, seed=1))
        assert fut.result(timeout=120).size > 0
    finally:
        b.stop()
    svc = DistributedConvertService(model, cfg, make_mesh(2, data=2, model=1, devices=["cpu", "cpu"]),
                                    fast=True, device="cpu")
    req = DistRequest(spec=np.ones((30, cfg.spec_channels), np.float32), n_frames=30, g_src=np.zeros(cfg.gin_channels),
                      g_tgt=np.zeros(cfg.gin_channels))
    for _ in range(2):
        assert svc.convert_round([req, req, req])[0].shape == (30 * cfg.upsample_factor,)
    root = tmp_path / "train_set"
    for s, f0 in enumerate((140.0, 230.0)):
        (root / f"speaker{s}").mkdir(parents=True)
        write_wav(str(root / f"speaker{s}" / "utt0.wav"), _voice(2.0, f0, 26 + s), SR)
    state = train(str(root), cfg, steps=2, batch_size=2, segment_frames=24, adversarial=True, log_every=0,
                  device="cpu")
    assert state.gen.step == 2
    owners = [tconv.graphs, tts.graphs, tts.chain_graphs(chain_conv), chain_conv.graphs, b.graphs, state.graphs,
              *(rep.graphs for rep in svc.replicas.values())]
    for graphs in owners:
        assert not graphs.active()
        assert len(graphs) == graphs.captures == graphs.replays == 0
