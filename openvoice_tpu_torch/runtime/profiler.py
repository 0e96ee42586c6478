"""Tracing, profiling and request metrics (the port's counterpart of
``openvoice_tpu/runtime/profiler.py``).

* `trace(name, metrics=None, args=None)`: a named span.  While a torch
  profiler records (`profiling`), it is a ``torch.profiler.record_function``
  range, on the clock of the profiler's kernel records, so each idle gap of
  the card lines up with what the host was doing; where the caller passes
  `metrics`, its wall time goes in as a latency.  Otherwise it costs one
  flag read.  `args` ride in the range's name (``"ov.convert fast=True
  req=3"``): the profiler drops ``record_function``'s own args string from
  its events.
* `Metrics`: host-only, thread-safe request counters and latency
  percentiles.  Its snapshot keys are the JAX package's, since the server's
  ``/metrics`` returns them: ``audio_seconds / busy_seconds`` is the
  ``audio_seconds_per_second`` figure.
* `profile_to(dir)`: a ``torch.profiler`` trace of a region, every
  thread's spans included, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler


class Metrics:
    """Thread-safe rolling metrics registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lat: dict[str, list[float]] = defaultdict(list)
        self._counters: dict[str, float] = defaultdict(float)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._lat[name].append(seconds)
            if len(self._lat[name]) > 10000:
                self._lat[name] = self._lat[name][-5000:]

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def add_many(self, values: dict[str, float]) -> None:
        """`add` of each counter, under one lock."""
        with self._lock:
            for name, value in values.items():
                self._counters[name] += value

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = {"counters": dict(self._counters)}
            lats = {}
            for name, vals in self._lat.items():
                if not vals:
                    continue
                s = sorted(vals)
                n = len(s)
                lats[name] = {
                    "count": n,
                    "mean_ms": 1e3 * sum(s) / n,
                    "p50_ms": 1e3 * s[n // 2],
                    "p95_ms": 1e3 * s[min(n - 1, int(n * 0.95))],
                    "p99_ms": 1e3 * s[min(n - 1, int(n * 0.99))],
                }
            out["latency"] = lats
            gen = self._counters.get("audio_seconds", 0.0)
            wall = self._counters.get("busy_seconds", 0.0)
            if wall > 0:
                out["audio_seconds_per_second"] = gen / wall
            return out

    def dump_json(self) -> str:
        return json.dumps(self.snapshot())


METRICS = Metrics()


def profiling() -> bool:
    """Whether a torch profiler is recording: torch's own flag, set by every
    profiler on start and cleared on stop.  It holds on every thread, where
    ``torch._C._autograd._profiler_enabled()`` reads the calling thread's
    state, which is false on all of them under ``profile_all_threads``."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    """`trace`'s scope while a profiler records or a latency is wanted."""

    __slots__ = ("_name", "_metrics", "_range", "_t0")

    def __init__(self, name: str, metrics: Metrics | None, args: dict | None, recording: bool):
        self._name, self._metrics, self._range = name, metrics, None
        if recording:
            label = name if not args else name + " " + " ".join(f"{k}={v}" for k, v in args.items())
            self._range = torch.profiler.record_function(label)

    def __enter__(self) -> "_Span":
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._metrics is not None:
            self._metrics.observe(self._name, time.perf_counter() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def trace(name: str, metrics: Metrics | None = None, args: dict | None = None):
    """Named span: a profiler range while a profiler records (`args`, where
    given, appended to its name as ``key=value``), and a latency in
    `metrics` where the caller passes one; else a shared no-op scope.  No
    span goes inside a CUDA graph's body: a replay runs none of its Python."""
    recording = _autograd_profiler._is_profiler_enabled
    if not recording and metrics is None:
        return _OFF
    return _Span(name, metrics, args, recording)


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Profile the enclosed region (host, and the GPU when there is one) and
    write it to ``log_dir/trace.json`` as a Chrome trace, with the port's
    `trace` spans of every thread (the batcher's dispatch and reader
    threads too, where this torch has ``profile_all_threads``); yields the
    ``torch.profiler.profile`` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities, **_all_threads()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _all_threads() -> dict:
    """The profiler's option to record every thread's spans, where this
    torch has it (``profile_all_threads``, torch 2.11 on)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}
