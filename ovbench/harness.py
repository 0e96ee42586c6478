"""The benchmark's machinery, driven by data: a cell is found by name
(``workloads/<cell>.json``), its configuration (``configs/<name>.json``),
its traffic mix (``traffic/<mix>.json``), its entry (``drivers/<entry>.py``)
and each of its metrics (``metrics/<name>.py``) by theirs.

A run: set-up (the program's build, weights, warm-up), then a closed loop
of the mix's clients for the window, then the metrics, then the check of
a sample of the answers against the reference (`judge`).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
FORBIDDEN = ("jax", "jaxlib", "flax", "openvoice_tpu")  # top-level module names, compared whole
DRAIN_S = 120.0     # the most a run waits, after the window, for the answers in flight
SAMPLE = 16         # answers a run checks against the reference


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def checked(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"bad name {name!r}")
    return name


@dataclass
class Cell:
    """One entry of BENCHMARK.json's ``workloads`` with what it names."""

    name: str
    entry: dict            # the BENCHMARK.json entry
    spec: dict             # workloads/<cell>.json
    config: dict           # configs/<config>.json
    mix: dict              # traffic/<mix>.json
    end_to_end: list       # BENCHMARK.json metric entries that this cell reports
    per_layer: list


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict, root: Path = ROOT) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[checked(name)]
    spec = _json(root / "workloads" / f"{name}.json")
    config = _json(root / "configs" / f"{checked(entry['config'])}.json")
    mix = _json(root / "traffic" / f"{checked(entry['traffic'])}.json")
    return Cell(name, entry, spec, config, mix, [m for m in bench["end_to_end"] if reports(m, name)],
                [m for m in bench["per_layer"] if reports(m, name)])


def metric_reader(name: str):
    """The ``read`` of ``metrics/<name>.py``.  A name may hold dots and
    dashes (a metric split by cell, as ``p95_ms.v2-convert-interactive``),
    so the file is loaded by its path."""
    key = f"ovbench.metrics.{checked(name)}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, ROOT / "metrics" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key].read


def driver_class(entry: str):
    return importlib.import_module(f"ovbench.drivers.{checked(entry)}").Driver


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run may not hold."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


# -- the closed loop -----------------------------------------------------------------

@dataclass
class Record:
    client: int
    j: int
    index: int             # the pool item
    t_submit: float
    t_done: float = 0.0
    error: str | None = None
    audio_s: float = 0.0
    work: dict = field(default_factory=dict)


def closed_loop(driver, traffic, seconds: float, keep: dict, on_start=None, on_end=None,
                span=None) -> tuple[list[Record], float, float, int]:
    """The mix's clients, each sending its next request on its last answer,
    for `seconds` from now; `on_start` and `on_end` are called at the
    window's bounds.  Then waits (up to `DRAIN_S`) for the answers in
    flight.  The first answer to each pool item is kept in `keep` (item
    index → output).  Returns (every request answered or failed, window
    start, window end, requests never answered)."""
    records: list[Record] = []
    lock = threading.Lock()
    sr = traffic_rate(driver)
    if on_start:
        on_start()
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def client(c: int) -> None:
        j = 0
        while time.perf_counter() < t_end:
            req = traffic.request(c, j)
            rec = Record(c, j, req["index"], time.perf_counter())
            try:
                with span("ovbench.call") if span else nullcontext():
                    out = driver.call(req)
                rec.t_done = time.perf_counter()
                rec.audio_s = len(out) / sr
                rec.work = driver.work(req, out)
                with lock:
                    keep.setdefault(req["index"], out)
            except Exception as exc:  # noqa: BLE001 — a failed request is counted, not fatal
                rec.t_done = time.perf_counter()
                rec.error = repr(exc)
            with lock:
                records.append(rec)
            j += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(traffic.clients)]
    for t in threads:
        t.start()
    time.sleep(max(t_end - time.perf_counter(), 0.0))
    if on_end:
        on_end()
    for t in threads:
        t.join(timeout=max(t_end + DRAIN_S - time.perf_counter(), 0.0))
    hung = sum(t.is_alive() for t in threads)
    if hung:
        print(f"{hung} request(s) unanswered {DRAIN_S:.0f} s after the window", file=sys.stderr)
    return records, t0, t_end, hung


def traffic_rate(driver) -> int:
    fields = driver.fields("tts") if "tts" in driver.config else driver.fields("model")
    return int(fields["sampling_rate"])


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0–100), linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


# -- the check -----------------------------------------------------------------------

def rel_err(out: np.ndarray, ref: np.ndarray) -> float:
    """‖out − ref‖ / ‖ref‖ over the whole answer."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))


def draw_sample(traffic, answered: set[int], seed: int, k: int = SAMPLE) -> list[int]:
    """Pool items to check: the longest answered one and k − 1 more drawn
    from the seed."""
    size = (lambda i: len(traffic.pool[i]["audio"])) if "audio" in traffic.pool[0] else (
        lambda i: len(traffic.pool[i]["text"]))
    items = sorted(answered)
    if not items:
        return []
    longest = max(items, key=size)
    rest = [i for i in items if i != longest]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5A4]))
    return [longest] + [int(i) for i in rng.choice(rest, size=min(k - 1, len(rest)), replace=False)]


def judge(driver, items: list[dict], outs: list) -> dict:
    """The numbers compared for answers `outs` to requests `items`:

    * ``audio_rel_err``: the widest relative distance from the reference's
      answer;
    * for cells in bf16, the distance against the reference's bf16 twin's
      own distance from the reference (how many times as far from float32
      the answer lies as an honest bf16 computation of it):
      ``audio_err_ratio``, the widest ratio request by request, and
      ``audio_err_ratio_pooled``, the ratio of the two distances summed in
      square over the sample;
    * ``length_mismatch``: answers whose length the reference cannot give.
    """
    refs = driver.reference(items, outs)
    twins = driver.reference(items, outs, "bf16") if driver.fast else [None] * len(items)
    worst, ratio, mismatched = 0.0, 0.0, 0
    pooled = [0.0, 0.0]
    for out, ref, twin in zip(outs, refs, twins):
        if ref is None or len(ref) != len(out):
            mismatched += 1
            continue
        err = rel_err(out, ref)
        worst = max(worst, err)
        if twin is not None:
            ratio = max(ratio, err / max(rel_err(twin, ref), 1e-12))
            ref64 = np.asarray(ref, np.float64)
            pooled[0] += float(np.sum((np.asarray(out, np.float64) - ref64) ** 2))
            pooled[1] += float(np.sum((np.asarray(twin, np.float64) - ref64) ** 2))
    numbers = {"audio_rel_err": worst, "length_mismatch": float(mismatched)}
    if driver.fast:
        numbers["audio_err_ratio"] = ratio
        numbers["audio_err_ratio_pooled"] = float(np.sqrt(pooled[0] / max(pooled[1], 1e-30)))
    return numbers


def control_outputs(driver, items: list[dict]) -> list:
    """The control's answers: the reference in the precision below the
    cell's, put in the program's place."""
    return driver.reference(items, None, "control")


def limits_line(numbers: dict, limits: dict) -> dict:
    """Each number read, with its limit (None: read, not compared)."""
    return {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
