"""The port's spans and counters (``runtime/profiler.py::trace``): gated off
when no profiler records, profiler ranges on every thread when one does,
nested inside the public entries' spans, kept out of the CUDA graphs'
bodies; and the batcher's queue-wait and padding counters (CPU; every
kernel wrapper runs its plain version; random weights)."""

import threading
import time

import numpy as np
import pytest
import torch

from openvoice_tpu_torch import api as tapi
from openvoice_tpu_torch.runtime import profiler as tprof
from openvoice_tpu_torch.runtime import streaming as tstream
from openvoice_tpu_torch.runtime.bucketing import plan_groups
from openvoice_tpu_torch.serve import batcher as tbatcher
from openvoice_tpu_torch.serve.batcher import ConvertBatcher, ConvertRequest
from tests._torch_port import TINY_TAIL, TINY_TTS_TAIL, torch_cfg

TEXT = ("The weather is nice today and we should go for a walk. "
        "Later we can have dinner together with our friends.")
BODIES = [(tapi, "convert_body"), (tapi, "tone_color_body"), (tapi, "tts_encode_body"), (tapi, "tts_decode_body"),
          (tapi, "tts_decode_convert_body"), (tapi, "tts_synthesize_convert_body"), (tbatcher, "group_body"),
          (tstream, "chunk_body")]


@pytest.fixture(scope="module")
def converter():
    tc = tapi.ToneColorConverter(cfg=torch_cfg(TINY_TAIL), device="cpu")
    tc.init_random(4)
    return tc


@pytest.fixture(scope="module")
def tts():
    tt = tapi.BaseSpeakerTTS(cfg=torch_cfg(TINY_TTS_TAIL), device="cpu")
    tt.init_random(3)
    return tt


@pytest.fixture(scope="module")
def se():
    return np.random.default_rng(2).standard_normal((1, TINY_TAIL["gin_channels"], 1)).astype(np.float32)


def _audio(seconds=0.4, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(22050 * seconds)) / 22050
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def _profile(all_threads=False):
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  **(tprof._all_threads() if all_threads else {}))


def _spans(prof):
    """(name, thread, start, end) of every ``ov.`` span and ``convert_batch``."""
    return [(e.name, e.thread, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("ov.") or e.name == "convert_batch"]


def _kind(name):
    return name.split(" ", 1)[0]


def _inside(span, outer):
    return span[1] == outer[1] and outer[2] <= span[2] and span[3] <= outer[3] and span is not outer


def _boom(*args, **kwargs):
    raise AssertionError("a profiler range was entered with no profiler recording")


def test_trace_off_enters_no_range_and_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    before = tprof.METRICS.snapshot()
    assert not tprof.profiling()
    with tprof.trace("ov.test"):
        pass
    with tprof.trace("ov.test", args={"group": 1}):
        pass
    assert tprof.METRICS.snapshot() == before


def test_trace_with_metrics_records_latency(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    m = tprof.Metrics()
    with tprof.trace("span", metrics=m):
        time.sleep(0.002)
    lat = m.snapshot()["latency"]["span"]
    assert lat["count"] == 1 and lat["mean_ms"] >= 2.0


def test_spans_carry_args_on_every_thread():
    """Under ``profile_all_threads`` (the benchmark's traced runs) the gate
    holds on the profiler's thread and on others, and the args ride in the
    range's name."""
    seen = []

    def work(tag):
        seen.append(tprof.profiling())
        with tprof.trace("ov.test", args={"thread": tag, "n": 3}):
            torch.ones(4).sum()

    with _profile(all_threads=True) as prof:
        work("main")
        th = threading.Thread(target=work, args=("worker",))
        th.start()
        th.join()
    spans = [s for s in _spans(prof) if _kind(s[0]) == "ov.test"]
    assert seen == [True, True]
    assert sorted(s[0] for s in spans) == ["ov.test thread=main n=3", "ov.test thread=worker n=3"]
    assert len({s[1] for s in spans}) == 2


def test_profile_to_writes_every_threads_spans(tmp_path):
    import json

    def work():
        with tprof.trace("ov.worker", args={"group": 7}):
            pass

    with tprof.profile_to(str(tmp_path)):
        th = threading.Thread(target=work)
        th.start()
        th.join()
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert "ov.worker group=7" in names


def test_convert_spans_nest_in_the_entry(converter, se):
    with _profile() as prof:
        converter.convert(_audio(), se, se, seed=1, fast=True)
    spans = _spans(prof)
    entries = [s for s in spans if _kind(s[0]) == "ov.convert"]
    assert len(entries) == 1 and "fast=True" in entries[0][0] and "req=" in entries[0][0]
    inner = {_kind(s[0]) for s in spans if _inside(s, entries[0])}
    assert {"ov.prepare", "ov.noise", "ov.readback", "ov.watermark"} <= inner


def test_tts_convert_batched_spans_nest_in_the_entry(tts, converter, se):
    with _profile() as prof:
        tapi.tts_convert_batched(tts, converter, TEXT, 0, se, se, seed=2, fast=False)
    spans = _spans(prof)
    entries = [s for s in spans if _kind(s[0]) == "ov.tts_convert_batched"]
    assert len(entries) == 1 and "fast=False" in entries[0][0]
    inner = {_kind(s[0]) for s in spans if _inside(s, entries[0])}
    assert {"ov.text", "ov.prepare", "ov.noise", "ov.readback", "ov.join", "ov.watermark"} <= inner


def test_stream_entry_spans_each_next(tts, converter, se):
    """A generator's entry span brackets each ``next``: a chunk's work, and
    last the call that ends the stream."""
    with _profile() as prof:
        chunks = list(tapi.tts_convert_stream(tts, converter, TEXT, 0, se, se, seed=2))
    spans = _spans(prof)
    entries = sorted((s for s in spans if _kind(s[0]) == "ov.tts_convert_stream"), key=lambda s: s[2])
    assert len(chunks) == 2 and len(entries) == 3
    assert any(_kind(s[0]) == "ov.text" and _inside(s, entries[0]) for s in spans)
    assert all(any(_kind(s[0]) == "ov.watermark" and _inside(s, e) for s in spans) for e in entries[:2])
    assert not any(_inside(s, entries[2]) for s in spans)


def _requests(frames, seed=0):
    rng = np.random.default_rng(seed)
    gin, freq = TINY_TAIL["gin_channels"], TINY_TAIL["spec_channels"]
    return [ConvertRequest(spec=np.abs(rng.standard_normal((n, freq))).astype(np.float32), n_frames=n,
                           g_src=rng.standard_normal(gin).astype(np.float32),
                           g_tgt=rng.standard_normal(gin).astype(np.float32), tau=0.3, seed=i)
            for i, n in enumerate(frames)]


def _run(batcher, reqs):
    """Submit `reqs` at once and wait for their answers."""
    futures = [batcher.submit(r) for r in reqs]
    for f in futures:
        f.result(timeout=120)


def test_batcher_counts_queue_wait_and_padding(converter):
    frames = [20, 25, 30]
    b = ConvertBatcher(converter.model, converter.cfg, max_batch=4, max_wait_ms=30, device="cpu")
    before = tprof.METRICS.snapshot()["counters"]
    reqs = _requests(frames)
    t0 = time.perf_counter()
    for r in reqs:  # queued before the dispatch thread starts: planned as one pool
        b.submit(r)
    b.start()
    try:
        for r in reqs:
            r.future.result(timeout=120)
    finally:
        b.stop()
    waited = time.perf_counter() - t0
    snap = tprof.METRICS.snapshot()
    rise = {k: v - before.get(k, 0.0) for k, v in snap["counters"].items()}
    plan = plan_groups(frames, max_batch=4)
    assert rise["dispatched_requests"] == 3 and rise["batches"] == len(plan)
    assert rise["true_frames"] == sum(frames)
    assert rise["dispatched_frames"] == sum(bucket * padded for _, bucket, padded in plan)
    assert 3 * 0.03 * 0.5 <= rise["queue_seconds"] <= 3 * waited
    assert "convert_batch" in snap["latency"]


def test_batcher_group_spans_share_numbers(converter):
    b = ConvertBatcher(converter.model, converter.cfg, max_batch=4, max_wait_ms=5, device="cpu")
    b.start()
    try:
        with _profile(all_threads=True) as prof:
            first, second = _requests([40, 50], seed=1), _requests([60], seed=2)
            _run(b, first)
            _run(b, second)
    finally:
        b.stop()
    spans = _spans(prof)

    def groups(kind):
        return {s[0].split("group=")[1].split()[0]: s for s in spans if _kind(s[0]) == kind}

    packs, readbacks, answers = groups("ov.batcher.pack"), groups("ov.batcher.readback"), groups("ov.batcher.answer")
    assert len(packs) == 2 and set(packs) == set(readbacks) == set(answers)
    ids = {packs[g][0].split("requests=")[1] for g in packs}
    assert ids == {",".join(str(r.request_id) for r in first), str(second[0].request_id)}
    batches = [s for s in spans if s[0] == "convert_batch"]
    assert len(batches) == 2
    for s in batches:  # each follows its group's pack on the dispatch thread
        pack = max((p for p in packs.values() if p[1] == s[1] and p[3] <= s[2]), key=lambda p: p[3])
        assert readbacks[pack[0].split("group=")[1].split()[0]][2] >= pack[2]


def test_request_ids_are_unique_and_rising():
    ids = [r.request_id for r in _requests([10, 10, 10])]
    assert ids == sorted(ids) and len(set(ids)) == 3


def test_no_span_inside_a_graph_body(monkeypatch, tts, converter, se):
    """A capture runs a body's Python once and a replay runs none of it, so
    a span inside a body would be recorded once at capture and never again.
    Every body runs here (eagerly, as a capture would run it) with a flag
    up, and no ``ov.`` range opens while it is."""
    inside, opened, called = [0], [], set()
    real = torch.profiler.record_function

    def recording(name, *args, **kwargs):
        opened.append((name, inside[0]))
        return real(name, *args, **kwargs)

    def flagged(name, body):
        def run(*args, **kwargs):
            called.add(name)
            inside[0] += 1
            try:
                return body(*args, **kwargs)
            finally:
                inside[0] -= 1
        return run

    for module, name in BODIES:
        monkeypatch.setattr(module, name, flagged(name, getattr(module, name)))
    monkeypatch.setattr(torch.profiler, "record_function", recording)
    b = ConvertBatcher(converter.model, converter.cfg, max_batch=2, max_wait_ms=5, device="cpu")
    b.start()
    try:
        with _profile(all_threads=True):
            converter.convert(_audio(), se, se, seed=1, fast=True)
            converter.convert_streaming(_audio(0.6), se, se, seed=1, chunk_frames=256)
            converter._se_from_audio_batch([_audio(0.3), _audio(0.2, seed=1)])
            tts.tts_batched(TEXT, None, 0, seed=1)
            tapi.tts_convert_batched(tts, converter, TEXT, 0, se, se, seed=2)
            tapi.tts_convert_single_dispatch(tts, converter, TEXT, 0, se, se, seed=2)
            _run(b, [ConvertRequest(audio=_audio(0.3), g_src=se.reshape(-1), g_tgt=se.reshape(-1), seed=3)])
    finally:
        b.stop()
    assert called == {name for _, name in BODIES}
    assert any(name.startswith("ov.") for name, _ in opened)
    assert [name for name, depth in opened if depth and name.startswith("ov.")] == []
