#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``openvoice_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one NVIDIA H100

Phases, in order; any failure exits non-zero before the result line:

1. toolchain: Python, torch, CUDA, nvcc, the card's name and power limit;
2. build: every kernel source ``openvoice_tpu_torch/csrc/*.cu``, all nvcc
   processes started together;
3. kernel check: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, with its time, the plain version's,
   one PyTorch library call's and the bound;
4. main path: a full-width V2 converter with seeded random weights runs
   extract_se on two synthetic wav files, then convert on a 10 s synthetic
   waveform (tau 0.3, watermark on); the launch counters, zeroed just
   before, show which kernels the path ran;
5. card against CPU: the same converter's speaker embeddings and its
   convert of a ~2 s clip, on cuda and on cpu;
6. one JSON line of every ported kernel, the card's ``nvidia-smi`` line,
   then the result line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Without a CUDA card, or outside a checkout of the
repository, it fails.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 1234
SR = 22050
MESSAGE = "ovt-h100"  # 8 characters: two 32-bit watermark windows
STFT_TOL = 1e-4       # the JAX suite's STFT bar (tests/test_ops.py), f32
CPU_AUDIO_TOL = 5e-4  # the port's audio bar against JAX on the CPU (f32)
SE_TOL = 1e-4         # the port's speaker-embedding bar against JAX (f32)
TIMED_RUNS = 20


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


# -- measurement helpers -----------------------------------------------------

def time_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of `fn` in ms: CUDA events around each of `runs`
    warm calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_peaks(name: str) -> tuple[float, float]:
    """(fp32 FLOP/s, memory bytes/s) of the card.  fp32 is computed from the
    card itself: SMs × 128 fp32 lanes × 2 (FMA) × max SM clock.  Memory rate
    from NVIDIA's H100 data sheets: SXM 3.35 TB/s, PCIe 2.0, NVL 3.9."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"]).splitlines()[0])
    bw = 2.0e12 if "PCIe" in name else 3.9e12 if "NVL" in name else 3.35e12
    return sms * 128 * 2 * mhz * 1e6, bw


# -- phases ------------------------------------------------------------------

def toolchain() -> tuple[str, str]:
    import torch

    from openvoice_tpu_torch.ops import _nvcc

    phase("1. toolchain")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"nvcc: {run([_nvcc._nvcc(), '--version']).splitlines()[-1]}")
    print(f"card: {smi}  ({torch.cuda.device_count()} visible)")
    return smi, torch.cuda.get_device_name(0)


def build() -> None:
    from openvoice_tpu_torch.ops import _nvcc

    phase("2. build")
    names = _nvcc.kernel_names()
    check(bool(names), "no kernel sources found")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        reports = dict(zip(names, pool.map(_nvcc.build, names)))
    print(f"built {names} in {time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        _nvcc.load(name)


def stft_case(rng, lengths: list[int], bucket: int):
    """A batch shaped as the API builds it: row i holds lengths[i] samples,
    then zeros up to the bucket's length."""
    import torch

    target = (bucket - 1) * 256 + 1024
    batch = np.zeros((len(lengths), target), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = rng.standard_normal(n) * 0.3
    return torch.from_numpy(batch).cuda()


def kernel_check(name: str) -> dict:
    import torch

    from openvoice_tpu_torch.audio.stft import host_spectrogram, stft_magnitude_plain
    from openvoice_tpu_torch.ops import stft_cuda

    phase("3. kernel check (K5 stft_magnitude vs its plain version)")
    rng = np.random.default_rng(SEED)
    # the convert path at a 10 s clip (861 frames → bucket 1024); extract_se
    # on three clips of 3, 5 and 8 s (bucket 768); and a win < n_fft case.
    # Inputs are N(0, 0.3²) audio, the level the 1e-4 bar was set on.
    cases = [
        ("convert B=1 bucket 1024", stft_case(rng, [220500 + 768], 1024), 1024),
        ("extract_se B=3 bucket 768", stft_case(rng, [66150 + 768, 110250 + 768, 176400 + 768], 768), 1024),
        ("win 800 B=1 bucket 1024", stft_case(rng, [220500 + 768], 1024), 800),
    ]
    max_err = 0.0
    for label, x, win in cases:
        out = stft_cuda.stft_magnitude(x, 1024, 256, win)
        ref = stft_magnitude_plain(x, 1024, 256, win)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        host_err = float(np.abs(out[0].cpu().numpy() - host_spectrogram(x[0].cpu().numpy(), 1024, 256, win)).max())
        print(f"{label}: out {tuple(out.shape)}  max|kernel - plain| {err:.3e}  "
              f"max|kernel - numpy f64| {host_err:.3e}  (bar {STFT_TOL})")
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()), f"{label}: bad output")
        check(err <= STFT_TOL and host_err <= STFT_TOL, f"{label}: kernel disagrees with its plain version")
        max_err = max(max_err, err)

    x = cases[0][1]  # the convert path's shape is the one timed
    b, length = x.shape
    frames, n_freq = (length - 1024) // 256 + 1, 513
    window = torch.hann_window(1024, device=x.device)

    def library():
        spec = torch.stft(x, 1024, 256, 1024, window=window, center=False, return_complex=True)
        return torch.sqrt(spec.real.square() + spec.imag.square() + 1e-6).transpose(1, 2)

    lib_err = float((library() - stft_cuda.stft_magnitude(x, 1024, 256, 1024)).abs().max())
    ms = time_ms(lambda: stft_cuda.stft_magnitude(x, 1024, 256, 1024))
    plain_ms = time_ms(lambda: stft_magnitude_plain(x, 1024, 256, 1024))
    library_ms = time_ms(library)
    flop_rate, byte_rate = card_peaks(name)
    ops = 2 * b * frames * 1024 * 2 * n_freq + 5 * b * frames * n_freq
    nbytes = 4 * (b * length + 1024 * 2 * n_freq + b * frames * n_freq)
    op_ms, byte_ms = ops / flop_rate * 1e3, nbytes / byte_rate * 1e3
    bound_ms = max(op_ms, byte_ms)
    print(f"[{b}, {length}] → [{b}, {frames}, {n_freq}]: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"torch.stft {library_ms:.4f} ms (max diff {lib_err:.2e})")
    print(f"bound {bound_ms:.4f} ms = max({ops / 1e9:.3f} GFLOP at {flop_rate / 1e12:.1f} TFLOP/s fp32, "
          f"{nbytes / 1e6:.2f} MB at {byte_rate / 1e12:.2f} TB/s); kernel at "
          f"{ops / ms / 1e9:.2f} TFLOP/s, {100 * bound_ms / ms:.1f}% of bound")
    return {
        "name": "stft_magnitude", "route": "cuda",
        "source": "openvoice_tpu_torch/csrc/stft.cu",
        "replaces": "openvoice_tpu/ops/stft_pallas.py:75",
        "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": library_ms,
    }


def voice(seconds: float, f0: float, seed: int) -> np.ndarray:
    """Speech-like signal: vibrato harmonic tone, syllable-rate envelope, noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * SR)) / SR
    phase_ = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * tt))) / SR
    x = sum(np.sin(k * phase_) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 2.5 * tt), 0, None) ** 0.5
    return (0.3 * x * env + 0.005 * rng.standard_normal(len(tt))).astype(np.float32)


def converter():
    """Full-width V2 converter on the card with seeded random weights.  The
    init zeroes each coupling's `post` (the flow would be the identity), so
    those get seeded random values too."""
    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG, ToneColorConverter

    tc = ToneColorConverter(cfg=V2_CONVERTER_CONFIG)
    check(tc.device.type == "cuda", f"converter landed on {tc.device}")
    tc.init_random(SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for layer in tc.model.flow.flows[::2]:
            w = layer.post.weight
            s = 1.0 / math.sqrt(w.shape[1] * w.shape[2])
            w.copy_(torch.empty(w.shape).uniform_(-s, s, generator=gen))
            layer.post.bias.copy_(torch.empty(w.shape[0]).uniform_(-s, s, generator=gen))
    return tc


def main_path(tc, tmp: str) -> tuple[dict, dict]:
    import torch

    from openvoice_tpu_torch.api import _spec_from_audio
    from openvoice_tpu_torch.audio.io import write_wav
    from openvoice_tpu_torch.ops import stft_cuda

    phase("4. main path: extract_se → convert, V2 full width, f32")
    cfg = tc.cfg
    refs = []
    for i, (secs, f0) in enumerate([(6.0, 110.0), (8.0, 220.0)]):
        refs.append(os.path.join(tmp, f"ref{i}.wav"))
        write_wav(refs[-1], voice(secs, f0, seed=i), SR)
    src = voice(10.0, 150.0, seed=7)
    n_frames = _spec_from_audio(src, cfg)[1]  # 861 at V2's hop 256: bucket 1024

    torch.cuda.synchronize()
    stft_cuda.launches = 0
    t0 = time.perf_counter()
    se_src = tc.extract_se(refs[:1])
    se_tgt = tc.extract_se(refs[1:])
    out = tc.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message=MESSAGE)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"stft_magnitude": stft_cuda.launches}
    print(f"first extract_se ×2 + convert: {first_s:.3f} s; kernel launches {launches}")
    # one STFT launch per extract_se batch and one per convert
    check(launches["stft_magnitude"] == 3, "the main path did not run the STFT kernel 3 times")

    check(se_src.shape == se_tgt.shape == (1, cfg.gin_channels, 1), f"SE shape {se_src.shape}")
    check(bool(np.isfinite(se_src).all() and np.isfinite(se_tgt).all()), "SE not finite")
    check(out.shape == (n_frames * cfg.upsample_factor,), f"audio shape {out.shape}, frames {n_frames}")
    check(bool(np.isfinite(out).all()), "audio not finite")
    peak = float(np.abs(out).max())
    check(peak <= 1.0, f"audio peak {peak} > 1")
    found = tc.detect_watermark(out, 2)
    print(f"audio {out.shape} ({len(out) / SR:.2f} s), peak {peak:.4f}, rms {float(np.sqrt(np.mean(out ** 2))):.5f}, "
          f"watermark {found!r}")
    check(found == MESSAGE, f"watermark read back {found!r}, wrote {MESSAGE!r}")

    # warm timings: whole convert (host pad, noise, device graph, readback,
    # watermark) by host clock; the device part alone by CUDA events
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        tc.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message=MESSAGE)
        walls.append(time.perf_counter() - t0)
    convert_s = statistics.median(walls)
    stages = stage_times(tc, src, se_src, se_tgt)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"warm convert of {len(src) / SR:.1f} s: {convert_s * 1e3:.2f} ms (median of 5) = "
          f"{len(src) / SR / convert_s:.1f} audio-s/s; peak device memory {peak_gb:.2f} GB")
    print("device time by stage (ms, CUDA events, median of 5): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    device_profile(lambda: tc.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message=MESSAGE),
                   convert_s * 1e3)
    return launches, {"se_src": se_src, "se_tgt": se_tgt, "refs": refs}


def stage_times(tc, audio: np.ndarray, se_src, se_tgt) -> dict:
    """Device time of each stage of convert's graph, run as
    models/synthesizer.py::voice_conversion_masked runs it."""
    import torch

    from openvoice_tpu_torch.api import _spec_from_audio
    from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude
    from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket

    cfg, model, dev = tc.cfg, tc.model, tc.device
    padded, n = _spec_from_audio(audio, cfg)
    bucket = round_up_to_bucket(n)
    buf = torch.zeros(1, (bucket - 1) * cfg.hop_length + cfg.filter_length, device=dev)
    buf[0, : len(padded)] = torch.from_numpy(padded).to(dev)
    mask = (torch.arange(bucket, device=dev) < n).float()[None, None]
    noise = torch.randn(1, cfg.inter_channels, bucket, device=dev)
    g_src, g_tgt = tc._as_g(se_src).transpose(1, 2), tc._as_g(se_tgt).transpose(1, 2)
    g0 = torch.zeros_like(g_src)
    with torch.inference_mode():
        spec = stft_magnitude(buf, cfg.filter_length, cfg.hop_length, cfg.win_length).transpose(1, 2)
        z = model.enc_q(spec, mask, g0, 0.3, noise)[0]
        z_hat = model.flow(model.flow(z, mask, g=g_src), mask, g=g_tgt, reverse=True)
        return {
            "stft": time_ms(lambda: stft_magnitude(buf, cfg.filter_length, cfg.hop_length, cfg.win_length), 5),
            "enc_q": time_ms(lambda: model.enc_q(spec, mask, g0, 0.3, noise), 5),
            "flow fwd+rev": time_ms(
                lambda: model.flow(model.flow(z, mask, g=g_src), mask, g=g_tgt, reverse=True), 5),
            "dec": time_ms(lambda: model.dec(z_hat * mask, g=g0, x_mask=mask), 5),
        }


def device_profile(fn, wall_ms: float) -> None:
    """torch.profiler over one warm call: the device's busy share of a warm
    call's wall time `wall_ms`, and the kernels with the most device time.
    (A first profiled call pays the profiler's own start-up, so the second
    one is read.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    # the kernels' own rows (device_type CUDA): the operators' rows would
    # count the same device time again
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    if not rows or rows[0][0] <= 0:
        print("profiler: no device time recorded (not measured)")
        return
    busy = sum(r[0] for r in rows)
    print(f"profiler: {sum(r[1] for r in rows)} kernel launches, device busy {busy:.2f} ms = "
          f"{100 * busy / wall_ms:.1f}% of the warm convert's {wall_ms:.2f} ms; top kernels:")
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.3f} ms {count:5d}×  {key[:90]}")


def card_vs_cpu(tc, ses: dict) -> None:
    from openvoice_tpu_torch import ToneColorConverter

    phase("5. card against CPU (same port, same weights; 2 s clip, watermark off)")
    cpu = ToneColorConverter(cfg=tc.cfg, device="cpu", enable_watermark=False)
    cpu.set_model(copy.deepcopy(tc.model))
    se_diff = float(np.abs(cpu.extract_se(ses["refs"]) - tc.extract_se(ses["refs"])).max())
    src = voice(2.0, 180.0, seed=11)
    t0 = time.perf_counter()
    on_cpu = cpu.convert(src, ses["se_src"], ses["se_tgt"], tau=0.3, seed=SEED, message="")
    cpu_s = time.perf_counter() - t0
    on_card = tc.convert(src, ses["se_src"], ses["se_tgt"], tau=0.3, seed=SEED, message="")
    diff = float(np.abs(on_card - on_cpu).max())
    peak = float(np.abs(on_cpu).max())
    print(f"SE: max |cuda - cpu| = {se_diff:.3e} (bound {SE_TOL}); audio: max |cuda - cpu| = {diff:.3e} "
          f"(bound {CPU_AUDIO_TOL}), {diff / peak:.2e} of the peak {peak:.5f}; CPU convert {cpu_s:.2f} s")
    check(se_diff <= SE_TOL, "card and CPU disagree on the speaker embedding")
    check(on_card.shape == on_cpu.shape and diff <= CPU_AUDIO_TOL and diff <= 1e-3 * peak,
          "card and CPU disagree on the audio")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run needs a CUDA card", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are real f32
    torch.backends.cudnn.allow_tf32 = False

    smi, kind = toolchain()
    build()
    kernels = [kernel_check(kind)]
    tc = converter()
    with tempfile.TemporaryDirectory() as tmp:
        launches, ses = main_path(tc, tmp)
        card_vs_cpu(tc, ses)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    phase("6. result")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
