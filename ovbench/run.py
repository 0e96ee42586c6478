"""Run one cell of the benchmark of openvoice_tpu_torch once, on the card.

    python3 ovbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, this folder and the
program.  Set-up builds the program's kernels (cached inside the checkout),
makes the weights on the card from the seed, and warms every shape the
cell's traffic uses; then the cell's clients run for `--seconds` in a closed
loop.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics from a ``torch.profiler`` trace of the same window.
Then a sample of the answers is checked against the plain reference
(``ovbench/reference``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which also close standard error.

Exits 2 without enough CUDA devices, 3 where the program is missing, and 4
where the process holds JAX or the JAX package after the window; none of
these prints a result.
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """The `time.perf_counter` reading at this process's start, from
    Linux's /proc (10 ms ticks); now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])  # field 22, starttime
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os

        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# torch's and numpy's thread pools at one thread, a setting of the deployment
# that each configuration states under `assumed` (with its readings); a
# library the port can load (transformers) is kept from loading JAX
for _var, _value in (("OMP_NUM_THREADS", "1"), ("OPENBLAS_NUM_THREADS", "1"), ("MKL_NUM_THREADS", "1"),
                     ("USE_FLAX", "0"), ("USE_JAX", "0")):
    os.environ[_var] = _value
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ovbench import harness  # noqa: E402
from ovbench.reference.model import Config  # noqa: E402
from ovbench.traffic import Traffic  # noqa: E402


def parse(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def launch_counts() -> dict:
    """The port's kernel launch counters, by wrapper module."""
    from openvoice_tpu_torch.ops import coupling_cuda, mrf_cuda, stft_cuda, tail_cuda, wn_cuda

    return {m.__name__.rsplit(".", 1)[1]: m.launches for m in (stft_cuda, wn_cuda, coupling_cuda, mrf_cuda, tail_cuda)}


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def all_threads() -> dict:
    """The profiler's option to record host spans of every thread (the
    batcher's dispatch thread, the clients), where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def model_configs(config: dict) -> dict:
    """The reference configurations the operation counts read."""
    if "tts" in config:
        return {"tts": Config.from_dict(config["tts"]), "convert": Config.from_dict(config["converter"])}
    return {"convert": Config.from_dict(config["model"])}


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict | None:
    """One run of `cell` on `device` → the result line's object (None where
    the process holds a forbidden module after the window)."""
    import torch

    from ovbench import flops
    from ovbench.trace import END, START, Trace

    on_card = device.type == "cuda"
    config = cell.config
    fields = config.get("model") or config["converter"]
    traffic = Traffic(cell.mix, seed, int(fields["gin_channels"]), int(fields["sampling_rate"]))
    driver = harness.driver_class(cell.spec["driver"])(cell.spec, config, traffic, seed, device)
    driver.setup()
    caches = driver.graph_caches()
    counters = getattr(driver, "counters", lambda: None)
    at = {"counters": counters(), "captures": sum(c.captures for c in caches), "launches": launch_counts()}
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities, **all_threads())
        prof.__enter__()
    end = {}

    def window_start() -> None:
        if prof is not None:
            with torch.profiler.record_function(START):
                pass

    def window_end() -> None:
        if prof is not None:
            with torch.profiler.record_function(END):
                pass
        end["counters"] = counters()
        end["captures"] = sum(c.captures for c in caches)

    keep: dict = {}
    records, t0, t_end, hung = harness.closed_loop(driver, traffic, seconds, keep, window_start, window_end,
                                                   span=torch.profiler.record_function if trace else None)
    if on_card:
        torch.cuda.synchronize(device)
    launched = {k: v - at["launches"][k] for k, v in launch_counts().items()}
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        tr = Trace.read(prof)
        if on_card:
            tr.check(launched)
        prof = None
    peak = int(torch.cuda.max_memory_reserved(device)) if on_card else 0

    completed = [r for r in records if r.error is None and r.t_done <= t_end]
    delta = None
    if at["counters"] is not None:
        delta = {k: v - at["counters"].get(k, 0.0) for k, v in end["counters"].items()}
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    ctx = SimpleNamespace(
        window_s=t_end - t0, setup_s=setup_s, records=records, completed=completed,
        traced=[r for r in records if r.error is None], counters=delta,
        captures=end["captures"] - at["captures"], trace=tr, cfgs=model_configs(config),
        peaks=flops.peaks(kind) if on_card else None, precision=config["precision"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = harness.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    if not allowed_modules():
        return None

    # the check: the program's state goes first, so that the reference
    # neither shares the card with it nor raises the peak read above
    failed = sum(r.error is not None for r in records) + hung
    driver.close()
    caches = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    sample = harness.draw_sample(traffic, set(keep), seed)
    numbers = harness.judge(driver, [traffic.pool[i] for i in sample], [keep[i] for i in sample])
    numbers["failed"] = float(failed)
    limits = cell.spec["limits"]
    correct = bool(sample) and all(limits[k] is not None and numbers[k] <= limits[k] for k in limits)

    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": int(cell.entry["chips"]),
                   "memory_peak_bytes": peak}
    if tr is not None:
        device_info.update(busy_s=tr.busy(), window_s=tr.window())
    result = {"correct": correct, "attempted": len(records) + hung, "failed": failed, "metrics": metrics,
              "device": device_info}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_kernels(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = harness.limits_line(numbers, limits)
    result["checks"]["sampled"] = {"value": float(len(sample)), "limit": None}
    return result


def allowed_modules() -> bool:
    """False, with the names on standard error, where the process holds a
    module it may not (JAX, or the JAX package)."""
    found = harness.forbidden_modules()
    if found:
        print("the run holds modules it may not: " + ", ".join(found), file=sys.stderr)
    return not found


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(args.workload, bench)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    try:
        import openvoice_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program is not in this checkout: {exc}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(card_line(), file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    if result is None or not allowed_modules():   # once more: the check and the teardown import too
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
