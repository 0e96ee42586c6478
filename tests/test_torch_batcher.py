"""The port's serving batcher and its planning against the JAX package's:
`plan_groups` and the bucket tables, the batcher in spec mode (host noise,
tau 0.3) and PCM mode (in-call STFT, device noise; tau 0, where the noise is
inert), its determinism, independence of batchmates, failure isolation,
padded rows of length 0, and the metrics registry (CPU; every kernel wrapper
runs its plain version).  Both batchers get the same JAX init weights, the
port's through the weight bridge."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from openvoice_tpu.runtime import bucketing as jbucket
from openvoice_tpu.runtime import profiler as jprof
from openvoice_tpu.serve.batcher import ConvertBatcher as JaxBatcher
from openvoice_tpu.serve.batcher import ConvertRequest as JaxRequest
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.runtime import bucketing as tbucket
from openvoice_tpu_torch.runtime import profiler as tprof
from openvoice_tpu_torch.serve import batcher as tbatcher
from openvoice_tpu_torch.serve.batcher import ConvertBatcher, ConvertRequest
from tests._torch_port import TINY, jax_cfg, jax_params, t, torch_cfg, torch_model

AUDIO_TOL = 5e-4  # the port's audio bar against JAX (f32)
WIRE_TOL = 3e-4   # the JAX suite's bar across the int16 wire (tests/test_serve.py)
UP = 16           # TINY's upsample factor
HOP = TINY["hop_length"]


# -- planning ---------------------------------------------------------------------

def test_bucket_tables_match_jax():
    assert tbucket.FINE_BUCKETS == jbucket.FINE_BUCKETS
    assert tbucket.DEFAULT_BUCKETS == jbucket.DEFAULT_BUCKETS
    for cap in range(1, 17):
        assert tbucket.allowed_batch_sizes(cap) == jbucket.allowed_batch_sizes(cap)
    for n in (1, 64, 65, 500, 4096, 4097, 9000):
        for table in (tbucket.DEFAULT_BUCKETS, tbucket.FINE_BUCKETS):
            assert tbucket.round_up_to_bucket(n, table) == jbucket.round_up_to_bucket(n, table)
    arr = np.arange(70 * 3, dtype=np.float32).reshape(70, 3)
    for axis in (0, 1):
        out, n = tbucket.pad_to_bucket(arr, axis)
        ref, ref_n = jbucket.pad_to_bucket(arr, axis)
        assert n == ref_n
        np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_batch", [1, 4, 6, 8])
def test_plan_groups_matches_jax(seed, max_batch):
    """A seeded spread of length mixes: short and long clips, ties, and
    lengths past the table."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    high = (300, 2000, 5000)[seed % 3]
    lengths = [int(x) for x in rng.integers(1, high, n)]
    plan = tbucket.plan_groups(lengths, max_batch=max_batch)
    assert plan == jbucket.plan_groups(lengths, max_batch=max_batch)
    assert sorted(i for idx, _, _ in plan for i in idx) == list(range(n))
    sizes = [3, 5] if max_batch >= 5 else None
    assert (tbucket.plan_groups(lengths, max_batch=max_batch, batch_sizes=sizes, fixed_cost_frames=10)
            == jbucket.plan_groups(lengths, max_batch=max_batch, batch_sizes=sizes, fixed_cost_frames=10))
    assert tbucket.plan_groups([], max_batch=max_batch) == []


# -- the batcher ------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    return jax_params(TINY, seed=0)


@pytest.fixture(scope="module")
def batchers(weights):
    jb = JaxBatcher(weights, jax_cfg(TINY), max_batch=4, max_wait_ms=20)
    tb = ConvertBatcher(torch_model(TINY, weights), torch_cfg(TINY), max_batch=4, max_wait_ms=20, device="cpu")
    jb.start()
    tb.start()
    yield jb, tb
    jb.stop()
    tb.stop()


def _inputs(n_frames: int, seed: int, tau: float):
    rng = np.random.default_rng(seed)
    return dict(
        spec=np.abs(rng.standard_normal((n_frames, TINY["spec_channels"]))).astype(np.float32),
        n_frames=n_frames,
        g_src=rng.standard_normal(TINY["gin_channels"]).astype(np.float32),
        g_tgt=rng.standard_normal(TINY["gin_channels"]).astype(np.float32),
        tau=tau, seed=seed,
    )


def _wave(n_frames: int, seed: int, tau: float):
    """A waveform request's fields, the samples already on the int16 grid
    (what the PCM mode uploads)."""
    rng = np.random.default_rng(seed)
    wave = np.round(np.clip(rng.standard_normal(n_frames * HOP) * 0.1, -1, 1) * 32767.0) / np.float32(32767.0)
    return dict(audio=wave.astype(np.float32), g_src=rng.standard_normal(TINY["gin_channels"]).astype(np.float32),
                g_tgt=rng.standard_normal(TINY["gin_channels"]).astype(np.float32), tau=tau, seed=seed)


def _both(batchers, fields: list[dict]) -> list[tuple[np.ndarray, np.ndarray]]:
    """Submit the same requests to both batchers at once; results in order."""
    jb, tb = batchers
    jf = [jb.submit(JaxRequest(**f)) for f in fields]
    tf = [tb.submit(ConvertRequest(**f)) for f in fields]
    return [(j.result(timeout=300), p.result(timeout=300)) for j, p in zip(jf, tf)]


def _close(out, ref, atol):
    """The absolute bar, and (the random decoder's audio is quiet: peaks of
    2e-3 to 5e-3) a bar of 5 % of the peak beside it."""
    assert out.shape == ref.shape
    peak = float(np.abs(ref).max())
    assert peak > 0
    np.testing.assert_allclose(out, ref, atol=atol)
    assert float(np.abs(out - ref).max()) <= 0.05 * peak


def test_spec_mode_matches_jax_at_tau_03(batchers):
    """Spec mode draws the host noise as JAX's batcher does: the same audio,
    across a mix of lengths that forms padded groups."""
    fields = [_inputs(n, seed=s, tau=0.3) for s, n in enumerate((50, 41, 64, 33, 70, 12))]
    for (ref, out), f in zip(_both(batchers, fields), fields):
        assert out.shape == (f["n_frames"] * UP,)
        _close(out, ref, AUDIO_TOL)


def test_pcm_mode_matches_jax_at_tau_0(batchers):
    """PCM mode runs the STFT in the batched call; its noise stream is not
    JAX's, so the two are held together at tau 0."""
    fields = [_wave(n, seed=20 + s, tau=0.0) for s, n in enumerate((48, 30, 61))]
    for ref, out in _both(batchers, fields):
        _close(out, ref, AUDIO_TOL)


def test_pcm_mode_equals_spec_mode_at_tau_0(batchers):
    """The same waveform as a PCM request and as its host spectrogram."""
    from openvoice_tpu_torch.api import _spec_from_audio
    from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude

    _, tb = batchers
    cfg = torch_cfg(TINY)
    f = _wave(48, seed=11, tau=0.0)
    pcm_out = tb.submit(ConvertRequest(**f)).result(timeout=300)
    padded, n_frames = _spec_from_audio(f["audio"], cfg)
    spec = stft_magnitude(t(padded)[None], cfg.filter_length, cfg.hop_length, cfg.win_length)[0, :n_frames]
    spec_out = tb.submit(ConvertRequest(spec=spec.numpy(), n_frames=n_frames, g_src=f["g_src"],
                                        g_tgt=f["g_tgt"], tau=0.0, seed=3)).result(timeout=300)
    _close(pcm_out, spec_out, WIRE_TOL)


def test_spec_mode_equals_convert_seed_at_tau_04(batchers):
    """At tau > 0 spec mode keeps `convert`'s host noise stream: the first
    n_frames rows of default_rng(seed) at the bucket's shape."""
    _, tb = batchers
    f = _inputs(45, seed=17, tau=0.4)
    out = tb.submit(ConvertRequest(**f)).result(timeout=300)
    noise = np.random.default_rng(17).standard_normal((45, TINY["inter_channels"])).astype(np.float32)
    with torch.inference_mode():
        direct, _ = TS.voice_conversion(tb.model, t(f["spec"])[None], torch.tensor([45]), t(f["g_src"])[None, None],
                                        t(f["g_tgt"])[None, None], 0.4, t(noise)[None])
    _close(out, direct[0, :, 0].numpy(), WIRE_TOL)


def test_pcm_mode_deterministic_per_seed(batchers):
    _, tb = batchers
    f = _wave(40, seed=12, tau=0.4)

    def run(seed):
        return tb.submit(ConvertRequest(**dict(f, seed=seed))).result(timeout=300)

    a1, a2, b = run(5), run(5), run(6)
    np.testing.assert_array_equal(a1, a2)
    assert np.max(np.abs(a1 - b)) > 1e-4


def test_result_independent_of_batchmates(batchers):
    _, tb = batchers
    solo = tb.submit(ConvertRequest(**_inputs(48, seed=7, tau=0.3))).result(timeout=300)
    futs = [tb.submit(ConvertRequest(**_inputs(48, seed=s, tau=0.3))) for s in (7, 8, 9, 10)]
    np.testing.assert_allclose(futs[0].result(timeout=300), solo, atol=2e-5)
    for f in futs[1:]:
        f.result(timeout=300)


def test_bad_request_fails_only_its_own_future(batchers):
    _, tb = batchers
    good = [_inputs(40 + s, seed=30 + s, tau=0.3) for s in range(3)]
    bad = dict(_inputs(44, seed=40, tau=0.3), g_src=np.zeros(5, np.float32))
    futs = [tb.submit(ConvertRequest(**f)) for f in (good[0], bad, good[1], good[2])]
    with pytest.raises(ValueError, match="g_src"):
        futs[1].result(timeout=300)
    for f, fut in zip(good, (futs[0], futs[2], futs[3])):
        out = fut.result(timeout=300)
        alone = tb.submit(ConvertRequest(**f)).result(timeout=300)
        np.testing.assert_allclose(out, alone, atol=2e-5)
    short = tb.submit(ConvertRequest(audio=np.zeros(3, np.float32), g_src=good[0]["g_src"], g_tgt=good[0]["g_tgt"]))
    with pytest.raises(ValueError, match="too short"):
        short.result(timeout=300)


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "serving"])
def test_padded_rows_of_length_0_are_zero(weights, fast):
    """A group padded to its batch size with rows of length 0: those rows
    come out exactly 0, and a real row equals its own call at B = 1."""
    model = torch_model(TINY, weights)
    cfg = torch_cfg(TINY)
    cache = TS.make_dec_cache(model) if fast else None
    rng = np.random.default_rng(3)
    target = 63 * HOP + cfg.filter_length
    pcm = t((rng.standard_normal((4, target)) * 3000).astype(np.int16))
    lens = torch.tensor([64, 40, 0, 0])
    g = t(rng.standard_normal((4, 1, cfg.gin_channels)).astype(np.float32))
    taus = torch.full((4, 1, 1), 0.3)
    with torch.inference_mode():
        wire = tbatcher._convert_pcm16(model, cfg, pcm, lens, g, g, taus, [1, 2, 0, 0], fast=fast, dec_cache=cache)
        one = tbatcher._convert_pcm16(model, cfg, pcm[:1], lens[:1], g[:1], g[:1], taus[:1], [1], fast=fast,
                                      dec_cache=cache)
    assert wire.dtype == torch.int16 and wire.shape == (4, 64 * UP)
    assert bool((wire[2:] == 0).all())
    assert int(wire[0].abs().max()) > 0
    assert int((wire[0] - one[0]).abs().max()) <= 1


def test_failed_call_fails_only_its_group(weights, monkeypatch):
    """A device fault injected into one call, mid-stream: every request
    completes, with audio or with the error of its own group only."""
    b = ConvertBatcher(torch_model(TINY, weights), torch_cfg(TINY), max_batch=4, max_wait_ms=10, device="cpu")
    real, calls = TS.voice_conversion, {"n": 0}

    def poisoned(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected fault: device unavailable")
        return real(*args, **kwargs)

    monkeypatch.setattr(tbatcher.S, "voice_conversion", poisoned)
    before = tprof.METRICS.snapshot()["counters"].get("batch_failures", 0)
    b.start()
    try:
        n_req, n_threads = 32, 4
        lengths = [(24, 30, 36)[i % 3] for i in range(n_req)]
        futs: list = [None] * n_req

        def submitter(tid):
            for i in range(tid, n_req, n_threads):
                futs[i] = b.submit(ConvertRequest(**_inputs(lengths[i], seed=i, tau=0.3)))
                time.sleep(0.001)

        threads = [threading.Thread(target=submitter, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        ok = failed = 0
        for i, f in enumerate(futs):
            try:
                out = f.result(timeout=300)
                assert out.shape == (lengths[i] * UP,) and np.isfinite(out).all()
                ok += 1
            except RuntimeError as exc:
                assert "injected fault" in str(exc)
                failed += 1
    finally:
        b.stop()
    assert ok + failed == n_req
    assert 0 < failed <= 4
    assert tprof.METRICS.snapshot()["counters"]["batch_failures"] > before


def test_resolve_device_fills_in_the_cuda_index(monkeypatch):
    """"cuda" and None name the same card, so models and services made with
    either compare equal (cuda != cuda:0 would refuse the pair)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert tbatcher.resolve_device("cuda") == torch.device("cuda", 3)
    assert tbatcher.resolve_device(torch.device("cuda")) == torch.device("cuda", 3)
    assert tbatcher.resolve_device(None) == torch.device("cuda", 3)
    assert tbatcher.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert tbatcher.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatcher.resolve_device("cuda")


def test_dead_dispatch_thread_fails_every_future(weights, monkeypatch):
    """A dispatch thread that dies (here: torch.cuda.set_device refusing a
    device with no index, as the real one does) fails the requests waiting
    for it, and every later submit at once; none hangs."""
    calls = []

    def set_device(device):
        calls.append(device)
        if torch.device(device).index is None:
            raise ValueError("Expected a torch.device with a specified index or an integer, but got:cuda")

    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    b = ConvertBatcher(torch_model(TINY, weights), torch_cfg(TINY), max_batch=4, max_wait_ms=10, device="cpu")
    b.device = torch.device("cuda")
    first = b.submit(ConvertRequest(**_inputs(24, seed=0, tau=0.3)))
    b.start()
    try:
        with pytest.raises(RuntimeError, match="dispatch thread failed.*specified index"):
            first.result(timeout=30)
        later = b.submit(ConvertRequest(**_inputs(24, seed=1, tau=0.3)))
        assert later.done()
        with pytest.raises(RuntimeError, match="dispatch thread failed"):
            later.result(timeout=0)
    finally:
        b.stop()
    assert calls == [torch.device("cuda")]


# -- metrics ----------------------------------------------------------------------

def test_metrics_keys_match_jax(batchers):
    _both(batchers, [_inputs(30, seed=1, tau=0.3), _wave(30, seed=2, tau=0.0)])
    jsnap, tsnap = jprof.METRICS.snapshot(), tprof.METRICS.snapshot()
    assert set(tsnap) == set(jsnap) == {"counters", "latency", "audio_seconds_per_second"}
    for key in ("audio_seconds", "busy_seconds", "batches"):
        assert key in tsnap["counters"] and key in jsnap["counters"]
    for key in ("request_latency", "convert_batch"):
        assert set(tsnap["latency"][key]) == set(jsnap["latency"][key])


def test_metrics_registry_matches_jax():
    """The same observations give the same snapshot, key for key."""
    ours, theirs = tprof.Metrics(), jprof.Metrics()
    for m in (ours, theirs):
        for i, v in enumerate(np.random.default_rng(0).uniform(0, 2, 300)):
            m.observe("request_latency" if i % 3 else "convert_batch", float(v))
            m.add("audio_seconds", float(v) * 3)
        m.add("busy_seconds", 7.5)
        m.add("batches")
    assert ours.snapshot() == theirs.snapshot()
    assert ours.dump_json() == theirs.dump_json()


def test_metrics_counter_under_threads():
    """More adding threads than cores, with a short switch interval: no
    update is lost."""
    m = tprof.Metrics()
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [m.add("n") for _ in range(n_adds)]) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert m.snapshot()["counters"]["n"] == n_threads * n_adds


def test_trace_records_latency_and_profile_to_writes_a_chrome_trace(tmp_path):
    import json

    m = tprof.Metrics()
    with tprof.profile_to(str(tmp_path)):
        with tprof.trace("span", metrics=m):
            torch.ones(8).sum()
    assert m.snapshot()["latency"]["span"]["count"] == 1
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "span" for e in events)
