"""The program's own spans in a traced window (``ov.`` ranges of
``openvoice_tpu_torch/runtime/profiler.py::trace``), which the benchmark's
`Trace` does not keep: it reads only ``convert_batch`` and
``ovbench.call``.  Not part of a run.

    python3 ovbench/spans.py --workload <cell> --seed <n> --seconds <s>
        One window of the cell as ``run.py --trace 1`` runs it (set-up, then
        the closed loop under ``torch.profiler`` with every thread's spans),
        then one JSON line: the span metrics per request (`per_request`),
        the device's idle time inside the harness's ``ovbench.call`` spans
        by the innermost ``ov.`` span open over it (`idle_by_span`) and the
        share of it below the entry span (`covered_share`), and the
        longest idle gaps named by the shortest ``ov.`` span open at their
        middle (`idle_gaps`), beside the harness's own naming.
    python3 ovbench/spans.py --span-cost
        What one span costs on this host: ``trace`` with no profiler, and
        inside a profiler that records every thread (µs a span).

The functions below take plain lists (spans, kernel records on the
profiler's clock), so that a `Trace` that keeps the ``ov.`` spans can use
them as they are.

Definitions (a request is an entry span that starts inside the window):

* ``host_ms``: the entry spans' time less the ``ov.readback`` time inside
  them, a request: the caller's thread working while the card waits on it;
* ``noise_ms``, ``watermark_ms``, ``text_ms``, ``readback_ms``, ...: the
  time of that span kind inside the entry spans, a request (a span inside
  another of its kind counted once).
"""

from __future__ import annotations

import bisect
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ovbench import run as RUN  # noqa: E402  (first: it sets the thread pools before torch loads)
from ovbench import harness  # noqa: E402
from ovbench.traffic import Traffic  # noqa: E402

CALL, BATCH = "ovbench.call", "convert_batch"
# the program's public entries (openvoice_tpu_torch/api.py), whose spans are requests
ENTRIES = frozenset("ov." + n for n in (
    "convert", "convert_streaming", "extract_se", "extract_se_from_file", "tts", "tts_batched",
    "tts_convert_batched", "tts_convert_single_dispatch", "tts_convert_stream"))


class Span(NamedTuple):
    kind: str      # the name up to its first space (``ov.convert``)
    name: str      # the whole name, with its ``key=value`` args
    tid: int
    start: int     # ns, on the profiler's clock
    end: int


def read_spans(prof) -> list[Span]:
    """Every ``ov.`` span, ``convert_batch`` and ``ovbench.call`` of a
    stopped ``torch.profiler.profile``, by start: the host's ranges, not
    their copies on the device's timeline (which span the range's kernels)."""
    from torch.autograd import DeviceType

    from ovbench.trace import _ns

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            continue
        name = e.name()
        kind = name.split(" ", 1)[0]
        if kind.startswith("ov.") or kind in (CALL, BATCH):
            s = _ns(e, "start")
            out.append(Span(kind, name, int(e.start_thread_id()), s, s + int(e.duration_ns())))
    out.sort(key=lambda s: s.start)
    return out


def _within(s: Span, outer: Span) -> bool:
    return s.tid == outer.tid and outer.start <= s.start and s.end <= outer.end and s is not outer


def per_request(spans: list[Span], t0: int, t1: int) -> dict:
    """Means a request over the entry spans that start in [t0, t1):
    ``entries``, ``entry_ms``, ``<kind>_ms`` for each span kind inside them
    (``ov.noise`` → ``noise_ms``, ``ov.graph.stage`` → ``graph.stage_ms``)
    and ``host_ms`` (entry less readback)."""
    entries = [s for s in spans if s.kind in ENTRIES and t0 <= s.start < t1]
    entries = [e for e in entries if not any(_within(e, o) for o in entries)]
    if not entries:
        return {"entries": 0}
    starts = [s.start for s in spans]
    total: dict[str, float] = {}
    for e in entries:
        inner = [s for s in spans[bisect.bisect_left(starts, e.start):bisect.bisect_right(starts, e.end)]
                 if _within(s, e) and s.kind.startswith("ov.") and s.kind not in ENTRIES]
        for s in inner:
            if any(o.kind == s.kind and _within(s, o) for o in inner):
                continue  # counted in the span of its kind around it
            key = s.kind[3:] + "_ms"
            total[key] = total.get(key, 0.0) + (s.end - s.start) / 1e6
    n = len(entries)
    out = {"entries": n, "entry_ms": sum(e.end - e.start for e in entries) / 1e6 / n}
    out.update({k: v / n for k, v in sorted(total.items())})
    for kind in ("noise", "watermark", "text", "readback"):
        out.setdefault(f"{kind}_ms", 0.0)
    out["host_ms"] = out["entry_ms"] - out["readback_ms"]
    return out


def idle_intervals(kernels: list, t0: int, t1: int) -> list[tuple[int, int]]:
    """The gaps in [t0, t1] in which no kernel ran (kernels: (name, start,
    end), by start), as the benchmark's `Trace.idle_gaps` finds them."""
    gaps, end = [], t0
    for _, s, e in kernels:
        if s > end and s <= t1:
            gaps.append((end, s))
        end = max(end, e)
    if end < t1:
        gaps.append((end, t1))
    return gaps


def idle_by_span(kernels: list, spans: list[Span], t0: int, t1: int) -> tuple[dict, float | None]:
    """The device's idle time inside the ``ovbench.call`` spans of the
    window, in ms a call, by the innermost ``ov.`` span open over it on the
    call's thread (``entry`` where only the entry span is, ``outside`` where
    not even that), and the share of it below the entry span (None without
    idle time in a call)."""
    gaps = idle_intervals(kernels, t0, t1)
    gap_starts = [g[0] for g in gaps]
    starts = [s.start for s in spans]
    by: dict[str, float] = {}
    calls = [c for c in spans if c.kind == CALL and t0 <= c.start < t1]
    for c in calls:
        inner = [s for s in spans[bisect.bisect_left(starts, c.start):bisect.bisect_right(starts, c.end)]
                 if _within(s, c) and s.kind.startswith("ov.")]
        cuts = sorted({c.start, c.end, *(x for s in inner for x in (s.start, s.end))})
        i = max(bisect.bisect_right(gap_starts, c.start) - 1, 0)
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) // 2
            open_ = [s for s in inner if s.start <= mid < s.end]
            label = "outside"
            if open_:
                innermost = min(open_, key=lambda s: s.end - s.start)
                label = "entry" if innermost.kind in ENTRIES else innermost.kind
            while i < len(gaps) and gaps[i][1] <= a:
                i += 1
            j = i
            while j < len(gaps) and gaps[j][0] < b:
                idle = min(b, gaps[j][1]) - max(a, gaps[j][0])
                if idle > 0:
                    by[label] = by.get(label, 0.0) + idle
                j += 1
    total = sum(by.values())
    below = total - by.get("entry", 0.0) - by.get("outside", 0.0)
    n = max(len(calls), 1)
    return ({k: v / 1e6 / n for k, v in sorted(by.items(), key=lambda x: -x[1])},
            below / total if total > 0 else None)


def label_gaps(kernels: list, spans: list[Span], t0: int, t1: int, n: int = 10) -> list:
    """The n longest idle gaps of the window, each named by the shortest
    ``ov.`` span open at its middle on any thread, else by
    ``convert_batch``, then ``ovbench.call``, as the benchmark's
    `Trace.idle_gaps` names them; ``none`` where nothing is open."""
    gaps = sorted(idle_intervals(kernels, t0, t1), key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) // 2
        open_ = [s for s in spans if s.start <= mid <= s.end]
        ours = [s for s in open_ if s.kind.startswith("ov.")]
        if ours:
            label = min(ours, key=lambda s: s.end - s.start).kind
        else:
            label = next((k for k in (BATCH, CALL) if any(s.kind == k for s in open_)), "none")
        out.append([label, (b - a) / 1e9])
    return out


def traced_window(cell: harness.Cell, seed: int, seconds: float, device) -> dict:
    """One window of `cell` under the profiler (as ``run.py --trace 1``)
    → the readings above, with the harness's own gap naming and the
    window's answered requests, mean latency and idle share."""
    import torch

    from ovbench.trace import END, START, Trace

    on_card = device.type == "cuda"
    config = cell.config
    fields = config.get("model") or config["converter"]
    traffic = Traffic(cell.mix, seed, int(fields["gin_channels"]), int(fields["sampling_rate"]))
    driver = harness.driver_class(cell.spec["driver"])(cell.spec, config, traffic, seed, device)
    driver.setup()
    launches = RUN.launch_counts()
    activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
    prof = torch.profiler.profile(activities=activities, **RUN.all_threads())

    def mark(name: str) -> None:
        with torch.profiler.record_function(name):
            pass

    prof.__enter__()
    records, t_start, t_end, hung = harness.closed_loop(driver, traffic, seconds, {}, lambda: mark(START),
                                                        lambda: mark(END), span=torch.profiler.record_function)
    if on_card:
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    tr = Trace.read(prof)
    if on_card:
        tr.check({k: v - launches[k] for k, v in RUN.launch_counts().items()})
    spans = read_spans(prof)
    driver.close()
    done = [r for r in records if r.error is None and r.t_done <= t_end]
    by, covered = idle_by_span(tr.kernels, spans, tr.t0, tr.t1)
    return {"cell": cell.name, "seed": seed, "answered": len(done), "failed": sum(r.error is not None for r in records)
            + hung, "mean_request_ms": 1e3 * sum(r.t_done - r.t_submit for r in done) / max(len(done), 1),
            "window_s": tr.window(), "idle_share": 100.0 * (1.0 - tr.busy() / tr.window()) if tr.window() > 0
            else None, "complete": tr.complete, "per_request": per_request(spans, tr.t0, tr.t1),
            "idle_by_span": by, "covered_share": covered, "idle_gaps": label_gaps(tr.kernels, spans, tr.t0, tr.t1),
            "harness_idle_gaps": tr.idle_gaps()}


def span_cost(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    """µs a span: ``trace`` with no profiler (and an empty loop's cost
    beside it), and inside a profiler that records every thread, bare and
    with args; ``record_function`` alone beside them."""
    import torch

    from openvoice_tpu_torch.runtime.profiler import trace

    def per(n, body) -> float:
        t0 = time.perf_counter()
        body(n)
        return 1e6 * (time.perf_counter() - t0) / n

    def empty(n):
        for _ in range(n):
            pass

    def spans(n, args=None):
        for _ in range(n):
            with trace("ov.cost", args=args):
                pass

    def ranges(n):
        for _ in range(n):
            with torch.profiler.record_function("ov.cost"):
                pass

    out = {"empty_loop_us": per(n_off, empty), "off_us": per(n_off, spans)}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **RUN.all_threads()):
        out["on_us"] = per(n_on, spans)
        out["on_args_us"] = per(n_on, lambda n: spans(n, {"group": 1, "bucket": 512}))
        out["record_function_us"] = per(n_on, ranges)
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--span-cost", action="store_true")
    args = p.parse_args(argv)
    if args.span_cost:
        print(json.dumps(span_cost()))
        return 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(args.workload, bench)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    print(RUN.card_line(), file=sys.stderr)
    print(json.dumps(traced_window(cell, args.seed, args.seconds, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
