"""Tracing, profiling and request metrics (the port's counterpart of
``openvoice_tpu/runtime/profiler.py``).

* `trace(name)`: a ``torch.profiler.record_function`` scope, whose wall time
  also goes into `Metrics` as a latency.
* `Metrics`: host-only, thread-safe request counters and latency
  percentiles.  Its snapshot keys are the JAX package's, since the server's
  ``/metrics`` returns them: ``audio_seconds / busy_seconds`` is the
  ``audio_seconds_per_second`` figure.
* `profile_to(dir)`: a ``torch.profiler`` trace of a region, written as a
  Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

import torch


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


@contextlib.contextmanager
def trace(name: str, metrics: Metrics | None = None):
    """Named scope: shows up in profiler traces and feeds latency metrics."""
    m = metrics or METRICS
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    m.observe(name, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Profile the enclosed region (host, and the GPU when there is one) and
    write it to ``log_dir/trace.json`` as a Chrome trace; yields the
    ``torch.profiler.profile`` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
