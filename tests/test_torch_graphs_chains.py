"""The fused TTS → convert chains and the data-parallel convert as CUDA
graphs (``openvoice_tpu_torch/api.py``, ``runtime/parallel.py``,
``serve/{distributed,batcher}.py`` through ``runtime/graphs.py``) on the CPU:
each site's key against the JAX package's ``tts_decode_convert_jit``,
``tts_synthesize_convert_jit`` and the distributed round's
``voice_conversion_jit``; each site's body filled twice against the eager
function and against JAX; replays against the eager calls; and that a chain
graph, which reads two models, is dropped when either model's weights are
replaced.  Capture and replay go through the stand-ins of
``tests/_torch_graphs.py``."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu import api as japi
from openvoice_tpu.models import synthesizer as JS
from openvoice_tpu.runtime.mesh import make_mesh as jax_make_mesh
from openvoice_tpu.serve.distributed import DistRequest as JaxRequest
from openvoice_tpu.serve.distributed import DistributedConvertService as JaxService
from openvoice_tpu_torch import api as tapi
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.runtime import graphs as G
from openvoice_tpu_torch.runtime import parallel as TP
from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket
from openvoice_tpu_torch.runtime.mesh import make_mesh
from openvoice_tpu_torch.serve import batcher as tbatcher
from openvoice_tpu_torch.serve.distributed import DistRequest, DistributedConvertService
from tests._torch_graphs import fake_graphs  # noqa: F401 (fixture)
from tests._torch_port import AUDIO_TOL, TINY_TAIL, TINY_TTS_TAIL, jax_cfg, jax_params, t, torch_cfg, torch_model

# the fused chain's pair (TTS upsample 16 = converter hop 16), the converter
# with its own speaker width: no other test file compiles these shapes, so the
# JAX jit caches below grow only by this file's calls
TTS, CONV = TINY_TTS_TAIL, dict(TINY_TAIL, gin_channels=40)
TEXT = ("The weather is nice today and we should go for a walk. "
        "Later we can have dinner together with our friends. "
        "Tomorrow there is work to be done in the garden.")


@pytest.fixture(scope="module")
def pair():
    """(JAX TTS, JAX converter, port TTS, port converter) on the same
    weights, the watermark off."""
    tp, cp = jax_params(TTS, seed=31), jax_params(CONV, seed=32)
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
    rng = np.random.default_rng(33)
    return tuple(rng.standard_normal((1, CONV["gin_channels"], 1)).astype(np.float32) for _ in range(2))


def _recording(cache: G.GraphCache, monkeypatch) -> list:
    keys, real = [], cache.run

    def run(key, body, inputs, consume=None):
        keys.append(key)
        return real(key, body, inputs, consume)

    monkeypatch.setattr(cache, "run", run)
    return keys


def _close(out, ref):
    """The fused suite's bar: the audio bar, and 1e-3 of the peak."""
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=AUDIO_TOL)
    assert float(np.abs(out - ref).max()) <= 1e-3 * float(np.abs(ref).max())


# -- keys ----------------------------------------------------------------------------

def test_chain_keys_follow_the_jax_sites(pair, ses, monkeypatch):
    """tts_convert_batched: one decode-convert key per frame group (the
    group's stacked token length, its frame bucket as max_frames, its
    rows, fast), as ``tts_decode_convert_jit`` (static max_frames and
    fast) compiles once per such shape; the single dispatch and the stream:
    one synthesize-convert key per token group (token bucket, the cap's
    frames, rows, fast), as ``tts_synthesize_convert_jit``."""
    jt, jc, tt, tc = pair
    src, tgt = ses
    keys = _recording(tt.chain_graphs(tc), monkeypatch)
    kw = dict(seed=7, fast=False, message="")
    tokens, _ = tt._sentence_tokens(TEXT, 1, "English")
    with torch.inference_mode():
        rows = tapi._encode_rows(tt.model, tokens, 1, 1.0, tapi._sentence_noise_rngs(7, len(tokens)), tt.device)
    want = [G.GraphKey("tts_decode_convert", bucket=max(rows[i]["m_p"].shape[0] for i in idxs), batch=len(idxs),
                       fast=False, max_frames=fb) for fb, idxs in tapi.frame_groups(rows).items()]
    before = JS.tts_decode_convert_jit._cache_size()
    tapi.tts_convert_batched(tt, tc, TEXT, 1, src, tgt, **kw)
    japi.tts_convert_batched(jt, jc, TEXT, 1, src, tgt, **kw)
    assert keys == want
    assert JS.tts_decode_convert_jit._cache_size() - before == len(set(keys))

    keys.clear()
    before = JS.tts_synthesize_convert_jit._cache_size()
    groups: dict[int, list[int]] = {}
    for i, seq in enumerate(tokens):
        groups.setdefault(round_up_to_bucket(len(seq)), []).append(i)
    tapi.tts_convert_single_dispatch(tt, tc, TEXT, 1, src, tgt, **kw)
    japi.tts_convert_single_dispatch(jt, jc, TEXT, 1, src, tgt, **kw)
    assert keys == [G.GraphKey("tts_synthesize_convert", bucket=tb, batch=len(idxs), fast=False,
                               max_frames=round_up_to_bucket(int(tb * 6.0))) for tb, idxs in groups.items()]
    assert JS.tts_synthesize_convert_jit._cache_size() - before == len(set(keys))
    keys.clear()
    list(tapi.tts_convert_stream(tt, tc, TEXT, 1, src, tgt, **kw))
    assert [k.batch for k in keys] == [1] * len(tokens) and {k.site for k in keys} == {"tts_synthesize_convert"}


def _dp_requests(cfg, n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nf = int(rng.integers(20, 60))
        out.append({"spec": np.abs(rng.standard_normal((nf, cfg.spec_channels))).astype(np.float32),
                    "n_frames": nf, "g_src": rng.standard_normal(cfg.gin_channels).astype(np.float32),
                    "g_tgt": rng.standard_normal(cfg.gin_channels).astype(np.float32), "tau": 0.3 + 0.1 * i,
                    "seed": 900 + 10 * seed + i})
    return out


@pytest.fixture(scope="module")
def dp_weights():
    params = jax_params(CONV, seed=34)
    return params, torch_model(CONV, params).eval()


def test_dp_round_keys_follow_the_distributed_round(dp_weights, fake_graphs):
    """A round's rows a position and bucket select its graph: a second
    round of the shape replays, another bucket or row count captures anew,
    as the JAX round's ``voice_conversion_jit`` (static cfg and fast)
    compiles once per global shape; over two data positions on one device
    the two positions share their device's replica and its one graph."""
    params, model = dp_weights
    cfg = torch_cfg(CONV)
    one = DistributedConvertService(model, cfg, make_mesh(1, devices=["cpu"]), device="cpu")
    jsvc = JaxService(jax.tree.map(np.asarray, params), jax_cfg(CONV), jax_make_mesh(1))
    rounds = [_dp_requests(cfg, 3, 1), _dp_requests(cfg, 3, 2), _dp_requests(cfg, 2, 3)]
    rounds.append([dict(r, spec=np.tile(r["spec"], (2, 1)), n_frames=2 * r["n_frames"]) for r in rounds[2]])
    before = JS.voice_conversion_jit._cache_size()
    for reqs in rounds:
        got = one.convert_round([DistRequest(**r) for r in reqs])
        ref = jsvc.convert_round([JaxRequest(**r) for r in reqs])
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, atol=AUDIO_TOL)
    (rep,) = one.replicas.values()
    shapes = [(round_up_to_bucket(max(r["n_frames"] for r in reqs)), len(reqs)) for reqs in rounds]
    assert set(rep.graphs.keys()) == {G.GraphKey("dp_convert", bucket=b, batch=n, fast=False, device="cpu")
                                      for b, n in shapes}
    assert (rep.graphs.captures, rep.graphs.replays) == (len(set(shapes)), len(shapes) - len(set(shapes)))
    assert JS.voice_conversion_jit._cache_size() - before == len(set(shapes)) == 3

    two = DistributedConvertService(model, cfg, make_mesh(2, data=2, model=1, devices=["cpu", "cpu"]), device="cpu")
    two.convert_round([DistRequest(**r) for r in rounds[0]])
    (rep2,) = two.replicas.values()
    assert rep2.graphs.keys() == [G.GraphKey("dp_convert", bucket=shapes[0][0], batch=2, fast=False, device="cpu")]
    assert (rep2.graphs.captures, rep2.graphs.replays) == (1, 1)  # 3 rows → 2 a position; the second replays


# -- the bodies, filled twice ------------------------------------------------------------

def _filled_twice(body, cases: list[dict], direct) -> list:
    """Static buffers made once from the first case, filled with each case
    in turn, the body run on them: exactly the direct call's result each
    time; returns the body's outputs."""
    static = {k: torch.empty(tuple(G._as_tensor(v).shape), dtype=G._as_tensor(v).dtype)
              for k, v in cases[0].items()}
    outs = []
    for i, case in enumerate(cases):
        G.stage(static, case)
        got, want = G._tensors(body(**static)), G._tensors(direct(i))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        outs.append(tuple(x.clone() for x in got))
    return outs


def _tokens(rng, lengths, t_max):
    toks = np.zeros((len(lengths), t_max), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, TTS["n_vocab"], n)
    return toks


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "serving"])
@torch.inference_mode()
def test_chain_bodies_filled_twice_equal_the_chains_and_jax(pair, fast):
    """tts_decode_convert_body and tts_synthesize_convert_body on static
    buffers filled twice (other tokens, noise, embeddings, tau and knobs)
    against `S.tts_decode_convert` / `S.tts_synthesize_convert` with float
    knobs, exactly; in f32 also against the JAX package's jitted chains on
    the same arrays, at the fused suite's bar."""
    jt, jc, tt, tc = pair
    caches = (TS.make_dec_cache(tt.model), TS.make_dec_cache(tc.model)) if fast else (None, None)
    rng = np.random.default_rng(35)
    tb, fb = 64, 128
    syn_cases = []
    for lengths, sid, tau, speed in (([40, 27], 1, 0.3, 1.0), ([33, 44], 2, 0.6, 1.2)):
        syn_cases.append({
            "tokens": _tokens(rng, lengths, tb), "lengths": np.asarray(lengths, np.int32),
            "sid": np.full(2, sid, np.int64), "noise_w": rng.standard_normal((2, tb, 2)).astype(np.float32),
            "noise_dec": rng.standard_normal((2, fb, TTS["inter_channels"])).astype(np.float32),
            "g_src": rng.standard_normal((2, 1, CONV["gin_channels"])).astype(np.float32),
            "g_tgt": rng.standard_normal((2, 1, CONV["gin_channels"])).astype(np.float32),
            "tau": np.full((2, 1, 1), tau, np.float32),
            "noise_conv": rng.standard_normal((2, fb, CONV["inter_channels"])).astype(np.float32),
            "noise_scale": np.float32(tapi.NOISE_SCALE), "noise_scale_w": np.float32(tapi.NOISE_SCALE_W),
            "length_scale": np.float32(1.0 / speed), "sdp_ratio": np.float32(tapi.SDP_RATIO)})

    def synthesize(c):
        return TS.tts_synthesize_convert(
            tt.model, t(c["tokens"]), t(c["lengths"]), t(c["sid"]), t(c["noise_w"]), fb, t(c["noise_dec"]),
            tc.model, t(c["g_src"]), t(c["g_tgt"]), float(c["tau"][0, 0, 0]), t(c["noise_conv"]),
            noise_scale=tapi.NOISE_SCALE, noise_scale_w=tapi.NOISE_SCALE_W, length_scale=float(c["length_scale"]),
            sdp_ratio=tapi.SDP_RATIO, fast=fast, tts_dec_cache=caches[0], conv_dec_cache=caches[1])

    outs = _filled_twice(partial(tapi.tts_synthesize_convert_body, tt.model, tc.model, fb, fast, *caches),
                         syn_cases, lambda i: synthesize(syn_cases[i]))
    dec_cases = []
    for c in syn_cases:
        enc = TS.tts_encode(tt.model, t(c["tokens"]), t(c["lengths"]), t(c["sid"]), t(c["noise_w"]),
                            noise_scale_w=tapi.NOISE_SCALE_W, length_scale=float(c["length_scale"]),
                            sdp_ratio=tapi.SDP_RATIO)
        dec_cases.append({**enc._asdict(), **{k: c[k] for k in ("noise_dec", "g_src", "g_tgt", "tau", "noise_conv",
                                                                 "noise_scale")}})

    def decode(c):
        audio, y_mask = TS.tts_decode_convert(
            tt.model, TS.TTSEncodeOut(c["m_p"], c["logs_p"], c["x_mask"], c["w_ceil"], c["g"]), fb,
            t(c["noise_dec"]), tc.model, t(c["g_src"]), t(c["g_tgt"]), float(c["tau"][0, 0, 0]),
            t(c["noise_conv"]), noise_scale=tapi.NOISE_SCALE, fast=fast, tts_dec_cache=caches[0],
            conv_dec_cache=caches[1])
        return audio, y_mask[..., 0].sum(dim=-1).to(torch.int32)

    _filled_twice(partial(tapi.tts_decode_convert_body, tt.model, tc.model, fb, fast, *caches), dec_cases,
                  lambda i: decode(dec_cases[i]))
    if fast:
        return
    for c, (audio, frames, total) in zip(syn_cases, outs):
        ref, ref_frames, ref_total = JS.tts_synthesize_convert_jit(
            jt.params, jt.cfg, *(jnp.asarray(c[k]) for k in ("tokens", "lengths", "sid", "noise_w")), fb,
            jnp.asarray(c["noise_dec"]), jc.params, jc.cfg, jnp.asarray(c["g_src"]), jnp.asarray(c["g_tgt"]),
            jnp.asarray(c["tau"]), jnp.asarray(c["noise_conv"]), length_scale=jnp.asarray(c["length_scale"]))
        np.testing.assert_array_equal(total.numpy(), np.asarray(ref_total))
        np.testing.assert_array_equal(frames.numpy(), np.asarray(ref_frames))
        _close(audio.numpy(), np.asarray(ref))


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "serving"])
@torch.inference_mode()
def test_dp_body_filled_twice_equals_voice_conversion_and_jax(dp_weights, fast):
    params, model = dp_weights
    cfg = torch_cfg(CONV)
    cache = TS.make_dec_cache(model) if fast else None
    rng = np.random.default_rng(36)
    cases = []
    for lengths, taus in (([64, 41], [0.3, 0.5]), ([17, 0], [0.8, 0.0])):
        cases.append({"spec": np.abs(rng.standard_normal((2, 64, cfg.spec_channels))).astype(np.float32),
                      "lengths": np.asarray(lengths, np.int64),
                      "g_src": rng.standard_normal((2, 1, cfg.gin_channels)).astype(np.float32),
                      "g_tgt": rng.standard_normal((2, 1, cfg.gin_channels)).astype(np.float32),
                      "tau": np.asarray(taus, np.float32).reshape(2, 1, 1),
                      "noise": rng.standard_normal((2, 64, cfg.inter_channels)).astype(np.float32)})

    def direct(c):
        audio, _ = TS.voice_conversion(model, *(t(c[k]) for k in ("spec", "lengths", "g_src", "g_tgt", "tau", "noise")),
                                       fast=fast, dec_cache=cache)
        return audio

    outs = _filled_twice(partial(TP.dp_convert_body, model, fast, cache), cases, lambda i: direct(cases[i]))
    if fast:
        return
    for c, (audio,) in zip(cases, outs):
        ref, _ = JS.voice_conversion_jit(params, jax_cfg(CONV), *(jnp.asarray(c[k]) for k in (
            "spec", "lengths", "g_src", "g_tgt", "tau", "noise")))
        np.testing.assert_allclose(audio.numpy(), np.asarray(ref), atol=AUDIO_TOL)


# -- replays against eager calls ---------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True], ids=["f32", "serving"])
def test_chain_replays_equal_their_eager_calls(pair, ses, fake_graphs, fast):
    """Each chain twice (the second call replays every graph the first
    captured), then with other draws, tau and speed, then with the TTS
    model's graphs off (the chains eager): bit-equal; the single dispatch's
    overflow re-run and the stream likewise."""
    _, _, tt, tc = pair
    src, tgt = ses
    graphs = tt.chain_graphs(tc)
    graphs.clear()
    calls = [
        lambda **kw: tapi.tts_convert_batched(tt, tc, TEXT, 1, src, tgt, **kw),
        lambda **kw: tapi.tts_convert_single_dispatch(tt, tc, TEXT, 1, src, tgt, **kw),
        lambda **kw: tapi.tts_convert_single_dispatch(tt, tc, TEXT, 1, src, tgt, frames_per_token=0.05, **kw),
        lambda **kw: np.concatenate(list(tapi.tts_convert_stream(tt, tc, TEXT, 1, src, tgt, **kw))),
    ]
    for call in calls:
        kw = dict(seed=5, fast=fast, message="")
        first = call(**kw)
        captures = graphs.captures
        again = call(**kw)
        other = call(**dict(kw, seed=6, tau=0.55, speed=1.1))
        assert graphs.captures >= captures and graphs.replays > 0
        tt.graphs.enabled = False
        try:
            replays = graphs.replays
            eager, eager_other = call(**kw), call(**dict(kw, seed=6, tau=0.55, speed=1.1))
            assert graphs.replays == replays  # off: nothing replayed
        finally:
            tt.graphs.enabled = True
        np.testing.assert_array_equal(again, eager)
        np.testing.assert_array_equal(first, eager)
        np.testing.assert_array_equal(other, eager_other)
        assert float(np.abs(other[: len(first)] - first[: len(other)]).max()) > 0


def test_dp_round_and_mesh_batcher_replays_equal_eager(dp_weights, fake_graphs):
    """Two rounds of one shape over a 2×1 mesh (the second replays each
    position's graph) against the service with its replicas' graphs off;
    the batcher over the same mesh, its groups' shards replayed, against
    the batcher with its graphs off: bit-equal."""
    _, model = dp_weights
    cfg = torch_cfg(CONV)
    mesh = make_mesh(2, data=2, model=1, devices=["cpu", "cpu"])
    graphed = DistributedConvertService(model, cfg, mesh, fast=True, device="cpu")
    eager = DistributedConvertService(model, cfg, mesh, fast=True, device="cpu")
    for rep in eager.replicas.values():
        rep.graphs.enabled = False
    for seed in (4, 5):
        reqs = [DistRequest(**r) for r in _dp_requests(cfg, 4, seed)]
        for a, b in zip(graphed.convert_round(reqs), eager.convert_round(reqs)):
            np.testing.assert_array_equal(a, b)
    (rep,) = graphed.replicas.values()
    assert rep.graphs.replays >= 2 and all(r.graphs.captures == 0 for r in eager.replicas.values())

    rng = np.random.default_rng(37)
    reqs = [dict(audio=(rng.standard_normal(40 * cfg.hop_length) * 0.2).astype(np.float32),
                 g_src=rng.standard_normal(cfg.gin_channels).astype(np.float32),
                 g_tgt=rng.standard_normal(cfg.gin_channels).astype(np.float32), tau=0.3, seed=k) for k in range(3)]
    b = tbatcher.ConvertBatcher(model, cfg, max_batch=4, max_wait_ms=5.0, fast=True, mesh=mesh)
    b.start()
    try:
        outs = []
        for enabled in (True, True, False):
            b.graphs.enabled = enabled
            futs = [b.submit(tbatcher.ConvertRequest(**r)) for r in reqs]
            outs.append([f.result(timeout=120) for f in futs])
    finally:
        b.stop()
    assert b.graphs.captures >= 1 and b.graphs.replays >= 2  # both positions of each later group replay
    for graph_run in outs[:2]:
        for a, c in zip(graph_run, outs[2]):
            np.testing.assert_array_equal(a, c)


# -- invalidation --------------------------------------------------------------------------

def test_a_chain_graph_is_dropped_when_either_model_changes(pair, ses, fake_graphs):
    """The chains' graphs read the TTS model and the converter: new weights
    on either, or either's rebuilt serving cache, drops them; either
    owner's graphs off runs the chains eagerly."""
    _, _, tt, tc = pair
    src, tgt = ses
    graphs = tt.chain_graphs(tc)
    assert tt.chain_graphs(tc) is graphs
    tts_model, conv_model = tt.model, tc.model

    def chain():
        return tapi.tts_convert_batched(tt, tc, "hello there my good friend", 0, src, tgt, seed=2, fast=True,
                                        message="")

    chain()
    before = graphs.captures
    chain()
    assert graphs.captures == before and len(graphs) >= 1  # the repeat replays
    for replace in (lambda: tt.set_model(tts_model), lambda: tc.set_model(conv_model),
                    lambda: setattr(tt, "_dec_cache", None), lambda: setattr(tc, "_dec_cache", None)):
        replace()  # new weights drop the graphs at once; a dropped serving cache at its rebuild
        before = graphs.captures
        chain()
        assert graphs.captures > before  # captured anew, not replayed on the old tensors
    for owner in (tt, tc):
        owner.graphs.enabled = False
        try:
            assert not graphs.active()
        finally:
            owner.graphs.enabled = True
    assert graphs.active()
