"""The readings of the program's spans (``ovbench/spans.py``) and of the
batcher's queue and padding counters (``metrics/queue_wait_ms.py``,
``metrics/pad_share.py``): known values from hand-placed spans, kernel
records and counter rises; the benchmark's own gap naming unchanged where
no ``ov.`` span is open; and tiny traced runs on the CPU."""

import time
from types import SimpleNamespace

import pytest
import torch

from ovbench import harness
from ovbench import spans as SP
from ovbench.tests.tiny import tiny_cell
from ovbench.trace import Trace

MS = 1_000_000  # ns


def span(name, start_ms, end_ms, tid=1):
    return SP.Span(name.split(" ", 1)[0], name, tid, int(start_ms * MS), int(end_ms * MS))


def request(t, tid=1, entry="ov.convert"):
    """One request of 10 ms from t: prepare 1, noise 2, stage 0.5, replay
    0.5, readback 4 (the card busy), watermark 1.5; inside its call span."""
    return [span("ovbench.call", t - 0.5, t + 10.5, tid), span(f"{entry} fast=True req=1", t, t + 10, tid),
            span("ov.prepare", t, t + 1, tid), span("ov.noise", t + 1, t + 3, tid),
            span("ov.graph.stage site=convert bucket=512 batch=1", t + 3, t + 3.5, tid),
            span("ov.graph.replay site=convert bucket=512 batch=1", t + 3.5, t + 4, tid),
            span("ov.readback", t + 4, t + 8, tid), span("ov.watermark samples=1", t + 8, t + 9.5, tid)]


def window(n=3):
    spans = sorted((s for i in range(n) for s in request(20.0 * i + 1)), key=lambda s: s.start)
    # the card busy from the replay's enqueue to the readback's end
    kernels = [("k", int((20.0 * i + 4) * MS), int((20.0 * i + 9) * MS)) for i in range(n)]
    return spans, kernels, 0, int(20.0 * n * MS)


def test_per_request_means():
    spans, _, t0, t1 = window()
    got = SP.per_request(spans, t0, t1)
    assert got["entries"] == 3
    assert got["entry_ms"] == pytest.approx(10.0) and got["host_ms"] == pytest.approx(6.0)
    assert got["noise_ms"] == pytest.approx(2.0) and got["watermark_ms"] == pytest.approx(1.5)
    assert got["readback_ms"] == pytest.approx(4.0) and got["text_ms"] == 0.0
    assert got["graph.stage_ms"] == pytest.approx(0.5)


def test_per_request_counts_entries_that_start_in_the_window_and_nested_kinds_once():
    spans, _, _, _ = window()
    spans.append(span("ov.noise", 1.5, 2.5))  # inside the first request's noise span
    spans.sort(key=lambda s: s.start)
    got = SP.per_request(spans, int(10 * MS), int(60 * MS))
    assert got["entries"] == 2 and got["noise_ms"] == pytest.approx(2.0)
    assert SP.per_request(spans, int(70 * MS), int(80 * MS)) == {"entries": 0}


def test_chain_text_time():
    spans = request(1.0, entry="ov.tts_convert_batched") + [span("ov.text", 1.0, 1.8)]
    spans.sort(key=lambda s: s.start)
    got = SP.per_request(spans, 0, int(20 * MS))
    assert got["entries"] == 1 and got["text_ms"] == pytest.approx(0.8)


def test_idle_by_span_and_covered_share():
    spans, kernels, t0, t1 = window()
    by, covered = SP.idle_by_span(kernels, spans, t0, t1)
    # a call (the card busy from its stage to its readback's end): 0.5 ms
    # idle before the entry and 0.5 after it, prepare 1, noise 2, watermark
    # 1.5, and 0.5 in the entry after the watermark
    assert by == pytest.approx({"ov.noise": 2.0, "ov.watermark": 1.5, "ov.prepare": 1.0, "outside": 1.0,
                                "entry": 0.5})
    assert covered == pytest.approx(4.5 / 6.0)


def test_label_gaps_name_the_shortest_open_ov_span():
    spans = [span("ovbench.call", 0, 20), span("ov.convert", 1, 19), span("ov.noise", 2, 8),
             span("ov.watermark", 12, 15), span("convert_batch", 11, 16, tid=2)]
    kernels = [("k", 0, int(1 * MS)), ("k", int(8.5 * MS), int(12 * MS)), ("k", int(15.5 * MS), int(20 * MS))]
    assert SP.label_gaps(kernels, spans, 0, int(20 * MS)) == [["ov.noise", 0.0075], ["ov.watermark", 0.0035]]


def test_label_gaps_without_ov_spans_match_the_benchmark_trace():
    """With the parent's spans only (no ``ov.``), the naming is the
    benchmark's `Trace.idle_gaps`, label for label and length for length."""
    spans = [span("ovbench.call", 0.5, 9.0), span("convert_batch", 2.0, 3.0, tid=2),
             span("ovbench.call", 12.0, 30.0), span("convert_batch", 14.0, 14.5, tid=2)]
    kernels = [("k", int(3.5 * MS), int(5 * MS)), ("k", int(9.5 * MS), int(13 * MS)), ("k", int(20 * MS), int(22 * MS))]
    tr = Trace(kernels=kernels, spans=[(s.kind, s.start, s.end) for s in spans], t0=0, t1=int(40 * MS))
    assert SP.label_gaps(kernels, spans, tr.t0, tr.t1) == tr.idle_gaps()


def ctx_of(counters):
    return SimpleNamespace(counters=counters)


def test_queue_wait_and_pad_share_from_counter_rises():
    queue, pad = harness.metric_reader("queue_wait_ms"), harness.metric_reader("pad_share")
    rise = {"batches": 4.0, "busy_seconds": 0.1, "queue_seconds": 1.5, "dispatched_requests": 10.0,
            "true_frames": 3000.0, "dispatched_frames": 4096.0}
    assert queue(ctx_of(rise)) == pytest.approx(150.0)
    assert pad(ctx_of(rise)) == pytest.approx(100.0 * (1 - 3000 / 4096))


@pytest.mark.parametrize("counters", [None, {}, {"batches": 3.0, "busy_seconds": 0.2, "audio_seconds": 9.0}])
def test_counter_readers_read_nothing_without_the_counters(counters):
    """A program without the counters (the parent's), or a cell with no
    batcher, reads nothing and does not raise."""
    assert harness.metric_reader("queue_wait_ms")(ctx_of(counters)) is None
    assert harness.metric_reader("pad_share")(ctx_of(counters)) is None


def test_traced_batcher_run_reports_queue_wait_and_padding():
    from ovbench import run as RUN

    torch.set_num_threads(2)
    cell = tiny_cell("v2-batcher-backlog", clients=2)
    cell.spec["limits"] = {k: (4.0 if "ratio" in k else v) for k, v in cell.spec["limits"].items()}
    res = RUN.run_cell(cell, 2 ** 40 + 5, 1.0, True, torch.device("cpu"), t_start=time.perf_counter())
    got = res["metrics"]
    assert res["correct"] and {"queue_wait_ms", "pad_share", "batch_rows", "dispatch_share"} <= set(got)
    assert got["queue_wait_ms"]["value"] >= 0 and got["queue_wait_ms"]["unit"] == "ms"
    assert 0 <= got["pad_share"]["value"] < 100 and got["pad_share"]["unit"] == "%"


@pytest.mark.parametrize("name", ["v2-convert-interactive", "v1-chain-interactive"])
def test_traced_window_reads_the_program_spans(name):
    torch.set_num_threads(2)
    out = SP.traced_window(tiny_cell(name), 2 ** 40 + 7, 1.0, torch.device("cpu"))
    got = out["per_request"]
    assert out["answered"] > 0 and out["failed"] == 0 and got["entries"] > 0
    assert got["noise_ms"] > 0 and got["watermark_ms"] > 0 and got["readback_ms"] > 0
    assert 0 < got["host_ms"] <= got["entry_ms"]
    assert (got["text_ms"] > 0) == (name == "v1-chain-interactive")
    # no kernel records on the CPU: the whole window is idle; the eager
    # model runs in the entry, under no span of its own
    assert 0 < out["covered_share"] < 1 and {"ov.noise", "ov.watermark", "entry"} <= set(out["idle_by_span"])
    assert len(out["idle_gaps"]) == len(out["harness_idle_gaps"])
