"""Readings the benchmark's limits were set from, on the card.  Not part of a
run.

    python3 ovbench/calibrate.py noise
        The PCM mode's device noise: is the first n rows of
        ``torch.randn(b, inter)`` from a freshly seeded ``torch.Generator``
        on the card the same for every bucket b ≥ n?  (The reference draws
        n rows.)
    python3 ovbench/calibrate.py levels --workload <cell> --seeds 1,2
        The reference's audio level ([rms, peak] each) on six of the cell's
        requests, before the watermark: what ``conv_post_gain`` was set from.
    python3 ovbench/calibrate.py control --workload <cell> --seeds 1,2,3
        The control of the cell's comparison: the reference in the precision
        below the configuration's put in the program's place, judged as a
        run judges the program, on each seed.
    python3 ovbench/calibrate.py program --workload <cell> --seeds 1,2,3 [--seconds 2]
        The program's readings: a whole run of the cell on each seed (a
        short window), one after another in this process, so that the
        process and the kernels start once.

Each prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ovbench import harness  # noqa: E402
from ovbench.traffic import Traffic  # noqa: E402


def noise(device: torch.device) -> None:
    from openvoice_tpu_torch.runtime.bucketing import FINE_BUCKETS

    worst = 0.0
    for seed in (0, 1234, 2 ** 31 - 1, 98765432101):
        for b in [x for x in FINE_BUCKETS if x >= 192]:
            full = torch.randn(b, 192, generator=torch.Generator(device).manual_seed(seed), device=device)
            for n in sorted({1, 64, 130, b // 2, b - 1, b}):
                part = torch.randn(n, 192, generator=torch.Generator(device).manual_seed(seed), device=device)
                worst = max(worst, float((full[:n] - part).abs().max()))
    print(json.dumps({"reading": "noise_prefix", "max_abs_diff": worst, "buckets": [192, FINE_BUCKETS[-1]]}))


def driver_for(name: str, seed: int, device: torch.device):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(name, bench)
    fields = cell.config.get("model") or cell.config["converter"]
    traffic = Traffic(cell.mix, seed, int(fields["gin_channels"]), int(fields["sampling_rate"]))
    return harness.driver_class(cell.spec["driver"])(cell.spec, cell.config, traffic, seed, device), traffic


def levels(name: str, seeds: list[int], device: torch.device) -> None:
    """rms and peak of the reference's answers to six pool requests, before
    the watermark: each converter's output, and for a text cell the TTS's
    base audio too."""
    from ovbench.drivers.batcher import device_noise
    from ovbench.drivers.chain import Driver as Chain, sentence_rngs
    from ovbench.drivers.convert import reference_convert
    from ovbench.reference import model as R

    def level(y: np.ndarray) -> list[float]:
        return [float(np.sqrt(np.mean(y ** 2))), float(np.abs(y).max())]

    for seed in seeds:
        driver, traffic = driver_for(name, seed, device)
        read: dict[str, list] = {"converter": [], "tts": []}
        with torch.no_grad(), R.precision("f32"):
            if isinstance(driver, Chain):
                tts, conv = driver.ref_model("tts", 0), driver.ref_model("converter", 1)
                for req in traffic.pool[:6]:
                    m_p, logs_p, w, g = driver._encode(tts, req)[0]   # the first sentence
                    _, rng_y, rng_c = sentence_rngs(req["seed"], 1)[0]
                    w_ceil = torch.ceil(w)
                    t_y = int(w_ceil.sum())
                    noise = torch.from_numpy(rng_y.standard_normal((t_y, 192)).astype(np.float32)).to(device)
                    base = R.np_audio(R.tts_decode(tts, R.tts_latents(m_p, logs_p, w_ceil, noise), g))
                    read["tts"].append(level(base))
                    read["converter"].append(level(reference_convert(
                        conv, base, req["src"], req["tgt"], req["tau"],
                        device_noise(req["seed"], t_y, conv.cfg.inter_channels, device))))
            else:
                model = driver.ref_model("model", 0)
                for req in traffic.pool[:6]:
                    n = (len(req["audio"]) + 768 - 1024) // 256 + 1
                    read["converter"].append(level(reference_convert(
                        model, req["audio"], req["src"], req["tgt"], req["tau"],
                        device_noise(req["seed"], n, model.cfg.inter_channels, device))))
        print(json.dumps({"reading": "levels", "workload": name, "seed": seed, **{k: v for k, v in read.items() if v}}))


def control(name: str, seeds: list[int], device: torch.device) -> None:
    for seed in seeds:
        t = time.perf_counter()
        driver, traffic = driver_for(name, seed, device)
        sample = harness.draw_sample(traffic, set(range(len(traffic.pool))), seed)
        items = [traffic.pool[i] for i in sample]
        outs = harness.control_outputs(driver, items)
        numbers = harness.judge(driver, items, outs)
        print(json.dumps({"reading": "control", "workload": name, "seed": seed, **numbers,
                          "seconds": time.perf_counter() - t}), flush=True)


def program(name: str, seeds: list[int], seconds: float, device: torch.device) -> None:
    from ovbench.run import run_cell

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in seeds:
        t = time.perf_counter()
        result = run_cell(harness.load_cell(name, bench), seed, seconds, False, device, t_start=t)
        print(json.dumps({"reading": "program", "workload": name, "seed": seed, "correct": result["correct"],
                          **{k: v["value"] for k, v in result["checks"].items()},
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("what", choices=("noise", "levels", "control", "program"))
    p.add_argument("--workload")
    p.add_argument("--seeds", default="1")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.what == "noise":
        noise(device)
    elif args.what == "levels":
        levels(args.workload, seeds, device)
    elif args.what == "control":
        control(args.workload, seeds, device)
    else:
        program(args.workload, seeds, args.seconds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
