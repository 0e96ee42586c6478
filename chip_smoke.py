#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``openvoice_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one NVIDIA H100
    python3 chip_smoke.py --sweep [wn coupling mrf tail]
                                   # instead: time K1-K4 (or those named) over
                                   # K1's and K2's ring depth, K3's ring
                                   # depth and tile target, K4's
                                   # ring reserve and tile target
    python3 chip_smoke.py --elastic     # instead: build, then phase 11 alone
    python3 chip_smoke.py --installed   # instead: build, then phase 12 alone
    python3 chip_smoke.py --melo-tail   # instead: build, then phase 3f alone
    python3 chip_smoke.py --tf32-control
                                   # instead: phase 9.4's gradients, plus the
                                   # card's f32 pass again with TF32 on, which
                                   # the f32 gradient bar must refuse

Phases, in order; any failure exits non-zero before the result line:

1. toolchain: Python, torch, CUDA, nvcc, the card's name and power limit;
2. build: every kernel source ``openvoice_tpu_torch/csrc/*.cu``, all nvcc
   processes started together;
3. kernel check: each kernel (K5 STFT, K1 WaveNet stack, K2 coupling block,
   K3 MRF stage, K4 decoder tail) against its plain PyTorch version on the
   card, at the shapes the main path gives it and at a ragged batch, with its
   time, the plain version's, the bound, and one PyTorch library call's (K5)
   or the stock bf16 layers' (K1-K4); K5 also at n_fft 256, 512, 768, 1000,
   2048 and 4096 (its FFT and its DFT route), K1 and K4 also at length 0,
   where their tiles exit early; then (3f) K4 at MeloTTS-English's decoder
   stages 2-4 (upsample kernels 8 and 2, 16 channels with conv_post).  Every time is CUDA events around calls
   queued behind a 1 ms device spin (`time_ms`), so that the host's enqueue
   of a call never lands inside its window;
4. main path, f32: a full-width V2 converter with seeded random weights runs
   extract_se on two synthetic wav files, then convert on a 10 s synthetic
   waveform (tau 0.3, watermark on); the launch counters, zeroed just
   before, show which kernels the path ran.  Then the CUDA graphs
   (``runtime/graphs.py``): the second extract_se replays the first one's
   graph, the repeat of the convert replays the graph its first call
   captured (no new capture, the same launches), bit-equal to the eager
   ``S.voice_conversion`` route and to convert with the graphs off, and a
   clip of the same bucket with another tau, g, length and noise gives the
   eager result; the warm wall eager against graph (median of 5 a block,
   eager, graph, graph, eager), each one's device busy share, the graph
   convert's wall split by host part, capture seconds, graphs held and the
   graph pool's bytes;
5. main path, serving mode: convert(fast=True) of the same clip, counters
   zeroed just before, the same graph checks and numbers; then serving
   against f32 on the card;
6. card against CPU: the same converter's speaker embeddings and its
   convert of a ~2 s clip in both modes, on cuda and on cpu;
6b. V1 path: a full-width V1 base-speaker TTS (seeded random weights) runs
   ``tts`` in f32 and in serving mode and ``tts_batched(fast=True)`` on four
   English sentences, at least two of which share a frame bucket; the launch
   counters show K2, K3 ×2 and K4 ×2 per decode group; K2 (reverse), K3 and
   K4 are held against their plain versions at the group's ragged shape and
   timed against its first row alone; fast against f32, batched against
   sentence by sentence, and card against CPU on a short sentence; then
   ``get_se`` (and its cache) on the TTS audio and a synthetic target with a
   full-width V1 converter, and ``convert`` in both modes (K5 1, K1 1, K2 2,
   K3 2, K4 2 in serving mode).  ``tts`` and ``tts_batched`` in both modes
   replay an encode graph a token-bucket group and a decode graph a
   frame-bucket group from their second call on: no new capture, the same
   launches, bit-equal to the graphs off, also with another speaker, seed
   and speed; warm walls eager against graph and their busy shares;
8. the serving tier, at full width (it runs before the result):
   (both converters' conv_post scaled ×100 first, so that their audio stands
   well above one step of the batcher's int16 wire)
   8a. ``ConvertBatcher`` in serving mode on the V2 converter: 32 requests of
   2-12 s submitted together (half PCM at tau 0, half spectrograms at tau
   0.3) at max_batch 8; the launch counters show K5 1 (PCM groups), K1 1,
   K2 2, K3 2, K4 2 per group; padded rows of length 0 come out exactly 0;
   each result against ``convert(fast=True)`` of its clip; one clip alone
   against the same clip in a group of 8; a group of 8 replayed, and one of
   other PCM clips, taus, embeddings and seeds, bit-equal to the group
   eager; audio-s/s at max_batch 8 (graph and eager) and 1, p50/p95
   latency, the dispatch thread's busy share, the device's busy share, the
   graphs captured and the pool's bytes; each kernel of one B = 8 group (two
   rows of length 0) against its plain version and timed against its first
   row alone;
   8b. ``serve()`` on 127.0.0.1 port 0 (V1 TTS, V1 converter): /convert,
   /tts and /clone (fused, single) against the direct calls, then one
   ``VoiceApp.predict`` against get_se → tts_batched → convert;
   8c. the fused chains on 6b's sentences: ``tts_convert_batched`` against
   the staged truth in both modes (launches K5 1, K1 1, K2 3, K3 4, K4 4 per
   group), ``tts_convert_single_dispatch`` twice and its overflow fallback,
   ``tts_convert_stream`` joined, and the chain's STFT (K5 on the gathered
   reflect-padded signal) against its plain version; then every chain in
   both modes repeated as CUDA graph replays (no new capture, the eager
   launches), bit-equal to the chain eager, ``tts_convert_batched`` also
   with another seed, tau and speed; warm walls eager against graph, the
   busy share of ``tts_convert_batched`` both ways, captures, capture
   seconds and the pool;
   8d. ``convert_streaming`` of a 60 s clip against one-shot ``convert`` in
   both modes, its repeat (every window a replay) bit-equal to the windows
   eager, a 45 s clip with another tau, g and noise likewise, and the peak
   device memory of streaming at 60 s and 240 s and of one-shot at 60 s, as
   replays and eager, beside the graph pool's bytes;
9. training, at full width (after the serving tier, before the result): a
   synthetic set of 2 speakers × 2 files × 8 s; ``train()`` of the V2
   converter with the GAN recipe (B 8, 128-frame segments) for 4 steps with
   a checkpoint every 2, then again to 6 (it resumes: on_step sees 5 and 6);
   every loss finite, G and D moved, the train step launched no kernel, the
   step-4 checkpoint loads bit for bit; a warm step's wall as a replay of
   the graph ``train()`` captured and eager, the profiler's busy share of
   each, FLOPs and f32 bound, peak memory; 20 mel/KL steps overfitting one
   batch (replays after the first); three steps of each train step from one
   state (B 8) as graph replays against eager: in f64 every loss and
   parameter leaf within 1e-10 of its peak; in f32 the median leaf's
   distance from f64 within 3× eager's, and one more step from one state
   within 3× the spread of two eager steps (a loss's at least 3× f32's
   epsilon); one B = 1 GAN
   step on the card against the CPU (losses, every
   gradient leaf in f64, D's and G's gradients in f32 against the CPU's own
   f32 rounding, a whole step's metrics); the trained converter
   through ``extract_se`` and ``convert`` in both modes (K5 1, K1 1, K2 2,
   K3 2, K4 2 in serving mode), ``mcd`` / ``se_cosine`` and the
   SE-conditioned dataset's first batch (K5, in the prefetch thread)
   against the CPU;
10. audio formats and the mesh tier (after training, before the result):
   10a. the codec libraries built from ``audio/native_src``, the codecs this
   machine has printed (a missing system library is printed, not failed;
   FLAC and WAV always run); a 10 s clip written in every available format
   through ``load_audio`` → ``extract_se_from_file`` → ``convert(fast=True)``
   (K5 1, K1 1, K2 2, K3 2, K4 2), held against the WAV clip (FLAC lossless
   at PCM16, a lossy codec by its aligned SNR and the speaker embedding's
   cosine); ``serve()`` answering ``format: "mp3", kbps: 64``;
   10b. on a one-process mesh over the card: the sequence-parallel and the
   tensor-parallel f32 convert (1×2) against the single-device convert at
   the JAX suite's bar, a serving-mode ``ConvertBatcher`` over a 2×1 mesh on
   8 requests against the single-device batcher (K5 1 a PCM group's shard,
   K1 1, K2 2, K3 2, K4 2 a shard; padded rows exactly 0), its group of 8
   repeated as each shard's graph replay, bit-equal to the shards eager;
   ``data_parallel_convert`` of 4 rows over the 2 positions repeated as
   replays (the eager launches), bit-equal to eager; a heartbeat;
   10c. two processes of this script (``--mesh-child``) on the card over
   gloo: the global batch and the collectives, a data-parallel serving-mode
   convert round (K1 1, K2 2, K3 2, K4 2 a rank) against one process, and a
   data-parallel B = 8 GAN step at full width whose losses and every
   gradient leaf match one process's step in f64 (1e-10 of the leaf's peak),
   then a warm f32 step's wall; then one NCCL rank through the same helpers;
11. the CLI and the elastic tier (after phase 10, before the result), at V2
   full width on seeded random weights (conv_post ×100), every process on
   cuda:0, ranks over gloo:
   11a. ``tools.main`` in process: ``convert-ckpt`` of a reference-format
   ``.pth`` (weight-normed convs, a numpy scalar), ``extract-se --device
   cuda`` (K5, by the counter) against ``extract_se_from_file``; then
   ``serve --ckpt <converted dir> --port 0`` as a process, one /convert
   against the in-process ``convert``, stopped by SIGTERM;
   11b. two ranks of ``DistributedConvertService(fast=True)``, two rounds,
   rank 1 passing [] in the first: K1 1, K2 2, K3 2, K4 2 a rank a round by
   the counters, padded rows exactly 0, each request against its
   one-process ``convert(fast=True)``; then each round again, each rank's
   rows a replay of its replica's graph (the same launches), bit-equal to
   the round with the graphs off;
   11c. a ``Supervisor`` of 2 f32 workers, worker 1 SIGKILLed after the first
   result; the shrunk world of 1 finishes; each result against one process;
   11d. a ``TrainSupervisor`` of 2 (mel/KL, 8 steps, a checkpoint every 4),
   worker 1 dying after step 6; the relaunch resumes from step_4;
   11e. ``LiveSupervisor`` + ``serve_elastic``, 8 requests over HTTP, a worker
   dying after 2 done, every answer against one process, worlds 2 then 1;
12. the installed port (after phase 11, before the result): a wheel built
   from a copy of the tree (``pip wheel --no-deps --no-build-isolation``,
   offline), installed with ``pip install --no-deps --target`` into a
   directory outside the repository; one child process (``--installed-child``,
   ``python -P`` with only that directory on ``PYTHONPATH``, a fresh working
   directory) builds K1-K5 and ``libovt_audio`` from the installed copy's own
   sources into its own ``csrc/build``, then runs each demo's ``main``
   (``openvoice_tpu_torch.demos.*``; V2 from a ``.pth`` with conv_post ×100,
   V1 on random weights; a 10 s WAV source, a 6 s FLAC reference), then
   ``tools.main(["extract-se", ...])`` and the installed
   ``bin/openvoice-tpu-torch``; each demo's launches against
   ``INSTALLED_LAUNCHES`` (fused_chain: n calls of K5 1, K1 1, K2 3, K3 4,
   K4 4); v2_conversion's and fused_chain's output WAVs against the same
   demos run here on the repository's copy (1e-5 and 0.05 of the peak);
7. one JSON line of every ported kernel (with ``launches_train_phase`` and
   phase 10's, 11's and 12's launch counts), one of the serving tier's
   numbers, one of the CUDA graphs' (phases 4-5, 6b, 8a, 8c, 9, 10b), one of
   training's,
   one of phase 10's, one of phase 11's, one of
   phase 12's, the card's ``nvidia-smi`` line, then the result line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Without a CUDA card, or outside a checkout of the
repository, it fails.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import functools
import io
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
# K1-K4 against their plain versions, both on bf16-valued operands with f32
# sums: a different summation order can flip a bf16 rounding, nothing more
KERNEL_MAX_TOL = 2.0 ** -6    # max |kernel - plain| over max |plain|: a flip at the peak is 2^-7
# mean |kernel - plain| over max |plain|.  The WaveNet kernels carry a flip
# through up to 16 layers of a residual; a decoder stage sums 126 taps of small
# weights and flips rarely.  Each bar is about twice what one H100 measured.
WN_MEAN_TOL = 2.0 ** -10.5
MRF_MEAN_TOL = 2.0 ** -13
ROUND_TRIP_TOL = 2.0 ** -5    # K2 forward then reverse, over max |x|
FRAMES = 861                  # the 10 s clip at hop 256
BUCKET = 1024                 # its bucket
# serving (bf16) against parity (f32) on the card, and card against CPU in
# serving mode, both as a share of the reference's peak: sixteen bf16 WaveNet
# layers and eight couplings in a row measured 0.012-0.013 on one H100, and the
# bars leave four times that for other seeds (PERF.md, Findings)
FAST_VS_F32_TOL = 0.05
FAST_CPU_TOL = 0.05


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

_L2_FLUSH = []  # one buffer larger than the card's 50 MB L2, made at first use
SPIN_S = 1e-3  # the device spin queued ahead of each timed call's start event


@functools.lru_cache(maxsize=None)
def spin_cycles() -> int:
    """SM clock cycles of `SPIN_S` at the card's highest SM clock."""
    mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"]).splitlines()[0])
    return int(SPIN_S * mhz * 1e6)


def time_ms(fn, runs: int = TIMED_RUNS, cold: bool = True) -> float:
    """Median device time of `fn` in ms: CUDA events around each of `runs`
    calls after a warm-up call.  With `cold` the L2 cache is overwritten
    before each timed call, as a convert leaves it for its next stage (the
    decoder alone streams more than the L2 holds): weights and inputs then
    come from device memory.  Without, a call finds what the call before it
    left in the L2.  A spin of `SPIN_S` on the device follows the flush and
    precedes the start event: the host enqueues `fn`'s work (a wrapper's
    checks, its casts, the ctypes call) while the card spins, so the events
    hold the card's time alone, even for a kernel shorter than that host
    work."""
    import torch

    if cold and not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda"))
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if cold:
            _L2_FLUSH[0].zero_()
        torch.cuda._sleep(spin_cycles())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@functools.lru_cache(maxsize=None)
def card_peaks(name: str) -> tuple[float, float, float]:
    """(fp32 FLOP/s, bf16 dense tensor FLOP/s, memory bytes/s) of the card.
    fp32 is computed from the card itself: SMs × 128 fp32 lanes × 2 (FMA) ×
    max SM clock.  The bf16 tensor rate (dense, no sparsity) and the memory
    rate are NVIDIA's H100 data-sheet figures: SXM 989 TFLOP/s and 3.35 TB/s,
    PCIe 756 and 2.0, NVL 835 and 3.9."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"]).splitlines()[0])
    bf16, bw = (756e12, 2.0e12) if "PCIe" in name else (835e12, 3.9e12) if "NVL" in name else (989e12, 3.35e12)
    return sms * 128 * 2 * mhz * 1e6, bf16, bw


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
            if "Compiling entry function" in line:
                print(f"  {name}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line or "wgmma" in line:
                print(f"  {name}:   {line.strip()}")
        # ptxas waits for every product of a warpgroup when it cannot prove
        # the products' registers untouched while they run: K3's and K4's speed
        check("wgmma.mma_async instructions are serialized" not in report,
              f"csrc/{name}.cu: ptxas serialized the wgmma products (see the report above)")
        if name == "tail" and report:  # a library built before has no report
            # every instance keeps its accumulators and fragments in registers
            spills = [line.strip() for line in report.splitlines() if "spill" in line
                      and "0 bytes spill stores, 0 bytes spill loads" not in line]
            check(not spills, f"csrc/tail.cu spills: {spills}")
            # the name the traces and the roofline readers match
            check("tail_stage_kernel" in report, "csrc/tail.cu: no entry function named tail_stage_kernel")
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


def stft_check(name: str) -> dict:
    import torch

    from openvoice_tpu_torch.audio.stft import host_spectrogram, stft_magnitude_plain
    from openvoice_tpu_torch.ops import stft_cuda

    phase("3a. kernel check: K5 stft_magnitude vs its plain version")
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
    # every other size: the FFT's other instances, n_fft 512 (32 x 16) and
    # 2048 (32 x 64), and the DFT kernel's sizes, each at a 1024-frame bucket,
    # against numpy float64 and the plain version; each is timed cold beside
    # torch.stft at the same size, with its bound
    flop_rate, _, byte_rate = card_peaks(name)
    sizes = {}
    for n_fft, hop in ((512, 128), (2048, 512), (256, 64), (768, 256), (1000, 250), (4096, 1024)):
        x = torch.from_numpy((rng.standard_normal((1, (BUCKET - 1) * hop + n_fft)) * 0.3).astype(np.float32)).cuda()
        before = stft_cuda.launches
        out = stft_cuda.stft_magnitude(x, n_fft, hop, n_fft)
        ref = stft_magnitude_plain(x, n_fft, hop, n_fft)
        torch.cuda.synchronize()
        check(stft_cuda.launches == before + 1, f"n_fft {n_fft}: the wrapper did not launch a kernel once")
        err = float((out - ref).abs().max())
        host = host_spectrogram(x[0].cpu().numpy(), n_fft, hop, n_fft)
        host_err = float(np.abs(out[0].cpu().numpy() - host).max())
        plain_err = float(np.abs(ref[0].cpu().numpy() - host).max())
        ms = time_ms(lambda: stft_cuda.stft_magnitude(x, n_fft, hop, n_fft))
        library_ms = time_ms(stft_library(x, n_fft, hop))
        bound_ms, by = stft_bound(x.shape, n_fft, hop, flop_rate, byte_rate)
        sizes[str(n_fft)] = {"route": stft_cuda.route(n_fft), "hop": hop, "ms": ms, "library_ms": library_ms,
                             "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err}
        print(f"n_fft {n_fft} hop {hop} B=1 ({stft_cuda.route(n_fft)}): out {tuple(out.shape)}  "
              f"max|kernel - plain| {err:.3e}  max|kernel - numpy f64| {host_err:.3e}  (bar {STFT_TOL}; "
              f"max|plain - numpy f64| {plain_err:.3e}); "
              f"kernel {ms:.4f} ms cold  torch.stft {library_ms:.4f} ms  bound {bound_ms:.5f} ms ({by})")
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()), f"n_fft {n_fft}: bad output")
        check(err <= STFT_TOL and host_err <= STFT_TOL, f"n_fft {n_fft}: kernel disagrees with its plain version")
        max_err = max(max_err, err)
    # n_fft 32768: the DFT's table (256 KB) does not fit in shared memory, and
    # the kernel reads it through the read-only cache instead; 4 frames,
    # against numpy float64 only (the plain version's basis would be 4.3 GB)
    n_fft, hop = 32768, 8192
    x = torch.from_numpy((rng.standard_normal((1, 3 * hop + n_fft)) * 0.3).astype(np.float32)).cuda()
    out = stft_cuda.stft_magnitude(x, n_fft, hop, n_fft)
    host_err = float(np.abs(out[0].cpu().numpy() - host_spectrogram(x[0].cpu().numpy(), n_fft, hop, n_fft)).max())
    print(f"n_fft {n_fft} hop {hop} B=1 ({stft_cuda.route(n_fft)}, table from the read-only cache): "
          f"out {tuple(out.shape)}  max|kernel - numpy f64| {host_err:.3e} (bar {STFT_TOL})")
    check(out.shape == (1, 4, n_fft // 2 + 1) and host_err <= STFT_TOL, f"n_fft {n_fft}: kernel disagrees with numpy")

    x = cases[0][1]  # the convert path's shape is the one timed
    b, length = x.shape
    frames, n_freq = (length - 1024) // 256 + 1, 513
    library = stft_library(x, 1024, 256)
    lib_err = float((library() - stft_cuda.stft_magnitude(x, 1024, 256, 1024)).abs().max())
    ms = time_ms(lambda: stft_cuda.stft_magnitude(x, 1024, 256, 1024))
    hot_ms = time_ms(lambda: stft_cuda.stft_magnitude(x, 1024, 256, 1024), cold=False)
    plain_ms = time_ms(lambda: stft_magnitude_plain(x, 1024, 256, 1024))
    library_ms = time_ms(library)
    bound_ms, by = stft_bound(x.shape, 1024, 256, flop_rate, byte_rate)
    print(f"[{b}, {length}] → [{b}, {frames}, {n_freq}]: kernel {ms:.4f} ms ({hot_ms:.4f} with a hot L2)  "
          f"plain {plain_ms:.4f} ms  torch.stft {library_ms:.4f} ms (max diff {lib_err:.2e})")
    print(f"bound {bound_ms:.5f} ms ({by}; {flop_rate / 1e12:.1f} TFLOP/s fp32, {byte_rate / 1e12:.2f} TB/s): "
          f"kernel at {100 * bound_ms / ms:.1f}% of bound")
    return {
        "name": "stft_magnitude", "route": "cuda",
        "source": "openvoice_tpu_torch/csrc/stft.cu",
        "replaces": "openvoice_tpu/ops/stft_pallas.py:75",
        "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms, "hot_ms": hot_ms, "n_fft": sizes,
    }


def stft_library(x, n_fft: int, hop: int):
    """One torch.stft call and the magnitude, the yardstick for K5 at a size
    (win = n_fft); the port never calls it."""
    import torch

    window = torch.hann_window(n_fft, device=x.device)

    def library():
        spec = torch.stft(x, n_fft, hop, n_fft, window=window, center=False, return_complex=True)
        return torch.sqrt(spec.real.square() + spec.imag.square() + 1e-6).transpose(1, 2)

    return library


def stft_bound(shape: tuple, n_fft: int, hop: int, flop_rate: float, byte_rate: float) -> tuple[float, str]:
    """K5's bound in ms on [B, L] audio, and what sets it: the function's
    least work, a real FFT a frame (2.5 N log2 N) and the magnitudes, at the
    card's fp32 rate, against the audio in, the bins out and the window once
    at its memory rate."""
    b, length = shape
    frames, n_freq = (length - n_fft) // hop + 1, n_fft // 2 + 1
    ops = b * frames * (2.5 * n_fft * math.log2(n_fft) + 5 * n_freq)
    nbytes = 4 * (b * length + b * frames * n_freq + n_fft)
    op_ms, byte_ms = ops / flop_rate * 1e3, nbytes / byte_rate * 1e3
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


# -- K1-K4: shared pieces of their checks ---------------------------------------

def redraw(module, gen, gain: float = 1.0):
    """Seeded weights of a working scale (uniform ±gain/√fan_in, biases
    ±0.1), so that every tap moves the result: the converter's own random
    decoder weights are too small for that."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            bound = gain / math.sqrt(p[0].numel()) if p.dim() > 1 else 0.1
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))
    return module.cuda().eval()


def rand_bf16(gen, *shape, scale: float = 0.5):
    import torch

    return (torch.randn(shape, generator=gen) * scale).to(torch.bfloat16).cuda()


def lens_on_card(lengths: list[int]):
    import torch

    return torch.tensor(lengths, dtype=torch.int32, device="cuda")


def agree(label: str, out, ref, mean_tol: float, lengths: list[int] | None = None,
          zero_after: int = 0) -> float:
    """Hold a kernel's result against its plain version's under the two
    bars, and its rows past each length against exact zero."""
    import torch

    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype, f"{label}: {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out.float()).all()), f"{label}: output not finite")
    diff = (out.float() - ref.float()).abs()
    peak = float(ref.float().abs().max())
    worst, mean = float(diff.max()), float(diff.mean())
    print(f"{label}: out {tuple(out.shape)} peak {peak:.4f}  max|kernel - plain| {worst:.3e} "
          f"(bar {KERNEL_MAX_TOL * peak:.3e})  mean {mean:.3e} (bar {mean_tol * peak:.3e})")
    check(worst <= KERNEL_MAX_TOL * peak and mean <= mean_tol * peak,
          f"{label}: kernel disagrees with its plain version")
    for b, n in enumerate(lengths or []):
        check(bool((out[b, n + zero_after:] == 0).all()), f"{label}: rows past the length are not 0")
    return worst


def kernel_entry(kind: str, name: str, source: str, replaces: str, max_err: float, ms: float,
                 hot_ms: float, plain_ms: float, stock_ms: float, flop: float, nbytes: float) -> dict:
    """One kernel's line: its bound is the larger of its operations at the
    card's dense bf16 tensor rate and its bytes (inputs once, outputs once,
    weights once) at the card's memory rate.  `ms`, `plain_ms` and `stock_ms`
    start from a cold L2, `hot_ms` is the kernel with a hot one."""
    _, bf16_rate, byte_rate = card_peaks(kind)
    op_ms, byte_ms = flop / bf16_rate * 1e3, nbytes / byte_rate * 1e3
    bound_ms = max(op_ms, byte_ms)
    print(f"{name}: kernel {ms:.4f} ms ({hot_ms:.4f} with a hot L2)  plain {plain_ms:.4f} ms  "
          f"stock bf16 layers {stock_ms:.4f} ms  "
          f"bound {bound_ms:.4f} ms = max({flop / 1e9:.2f} GFLOP at {bf16_rate / 1e12:.0f} TFLOP/s bf16, "
          f"{nbytes / 1e6:.2f} MB at {byte_rate / 1e12:.2f} TB/s); kernel at {flop / ms / 1e9:.1f} TFLOP/s, "
          f"{100 * bound_ms / ms:.1f}% of bound, {stock_ms / ms:.2f}x the stock layers' speed")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": 0,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if op_ms >= byte_ms else "bytes", "library_ms": None,
        "stock_bf16_ms": stock_ms, "hot_ms": hot_ms,
    }


def numel(packed: dict, keys: tuple) -> int:
    return sum(packed[k].numel() for k in keys)


def wn_flop(frames: int, n_layers: int, k: int, h: int) -> float:
    """L layers of a K-tap H→2H conv and an H→2H 1×1 (H→H on the last)."""
    return 2.0 * frames * (n_layers * (k + 1) * h * 2 * h - h * h)


# a ragged batch of 8 rows at a 512-frame bucket, as the batcher forms them
RAGGED_B8 = [512, 487, 430, 366, 301, 233, 129, 64]


def cluster_line(launch: dict) -> str:
    """K1's or K2's launch as the wrapper planned it and ptxas built it."""
    return (f"cluster launch: R {launch['ranks']}, rows/tile {launch['rows']}/{launch['tile']}, {launch['ctas']} "
            f"CTAs launched, cudaOccupancyMaxActiveClusters {launch['max_clusters']} ({launch['warpgroups']} "
            f"warpgroups, m64n{launch['width']} items, ring {launch['stages']} x {launch['group']} units, "
            f"{launch['registers']} registers, {launch['spill_bytes']} bytes spilled a thread)")


# -- K1 ------------------------------------------------------------------------

def wn_check(kind: str, gen) -> dict:
    import torch

    from openvoice_tpu_torch.nn.wavenet import WN
    from openvoice_tpu_torch.ops import wn_cuda

    phase("3b. kernel check: K1 wn_stack (csrc/wn.cu) vs its plain version")
    h, k, n_layers, gin = 192, 5, 16, 256  # the V2 posterior encoder's WaveNet
    wn = redraw(WN(h, k, n_layers, gin), gen)
    wn16 = copy.deepcopy(wn).to(torch.bfloat16)
    packed = wn_cuda.stack_wn_params(wn)
    max_err, timed = 0.0, None
    for label, t, lengths in [("convert B=1 T=1024", BUCKET, [FRAMES]), ("ragged B=2 T=333", 333, [333, 200]),
                              ("ragged B=8 T=512", 512, RAGGED_B8)]:
        b = len(lengths)
        x, g = rand_bf16(gen, b, t, h), rand_bf16(gen, b, gin, 1, scale=1.0)
        lens = lens_on_card(lengths)
        g_all = wn16.cond_layer(g).reshape(b, n_layers, 2 * h).contiguous()
        out = wn_cuda.wn_stack(x, lens, packed, g_all)
        max_err = max(max_err, agree(label, out, wn_cuda.wn_stack_plain(x, lens, packed, g_all), WN_MEAN_TOL, lengths))
        launch = {**wn_cuda.last_launch, **wn_cuda.kernel_attributes()}
        print(f"{label} {cluster_line(launch)}; live tiles by the exit rule (computed on the host): "
              + ", ".join(str(wn_cuda.live_tiles(n, launch["tile"], t)) for n in lengths)
              + f" of {launch['tiles']}")
        check(launch["max_clusters"] >= 1, "no K1 cluster fits on the card")
        timed = timed or (x, g, lens, g_all, launch)
    x, g, lens, g_all, launch = timed
    # the early exit, measured: at length 0 every tile lies past the length,
    # writes its zeros and returns before any product
    lens0 = lens_on_card([0])
    out0 = wn_cuda.wn_stack(x, lens0, packed, g_all)
    torch.cuda.synchronize()
    check(bool((out0 == 0).all()), "K1 at length 0: output not all zero")
    empty_ms = time_ms(lambda: wn_cuda.wn_stack(x, lens0, packed, g_all))
    mask = (torch.arange(BUCKET, device="cuda") < FRAMES).to(torch.bfloat16)[None, None]
    x_bct = (x.transpose(1, 2) * mask).contiguous()
    stock = wn16(x_bct, mask, g).transpose(1, 2)
    print(f"stock bf16 layers vs kernel: max diff {float((stock.float() - wn_cuda.wn_stack(x, lens, packed, g_all).float()).abs().max()):.3e}")
    nbytes = 2 * (FRAMES * h + BUCKET * h + g_all.numel() + numel(packed, ("w_in", "b_in", "w_rs", "b_rs")))
    ms = time_ms(lambda: wn_cuda.wn_stack(x, lens, packed, g_all))
    # and at the bucket's whole length, where no tile exits: the clusters a
    # launch needs at most, against how many fit on the card
    lens_full = lens_on_card([BUCKET])
    full_ms = time_ms(lambda: wn_cuda.wn_stack(x, lens_full, packed, g_all))
    print(f"K1 at length 0 (every tile exits): {empty_ms:.4f} ms; at {BUCKET} frames (every tile live): "
          f"{full_ms:.4f} ms; against {ms:.4f} at {FRAMES} frames")
    check(empty_ms < 0.5 * ms, f"K1 at length 0: the tiles do not exit early ({empty_ms:.4f} ms against {ms:.4f})")
    entry = kernel_entry(
        kind, "wn_stack", "openvoice_tpu_torch/csrc/wn.cu", "openvoice_tpu/ops/wn_pallas.py:92", max_err, ms,
        time_ms(lambda: wn_cuda.wn_stack(x, lens, packed, g_all), cold=False),
        time_ms(lambda: wn_cuda.wn_stack_plain(x, lens, packed, g_all), 5),
        time_ms(lambda: wn16(x_bct, mask, g)), wn_flop(FRAMES, n_layers, k, h), nbytes)
    return {**entry, "cluster": {**launch, "empty_ms": empty_ms, "full_ms": full_ms}}


# -- K2 ------------------------------------------------------------------------

def coupling_check(kind: str, gen) -> dict:
    import torch

    from openvoice_tpu_torch.nn.flows import ResidualCouplingBlock
    from openvoice_tpu_torch.ops import coupling_cuda as cc

    phase("3c. kernel check: K2 coupling_block (csrc/coupling.cu) vs its plain version")
    c, h, k, n_layers, n_flows, gin = 192, 192, 5, 4, 4, 256  # the V2 flow
    flow = redraw(ResidualCouplingBlock(c, h, k, n_layers, n_flows, gin), gen)
    flow16 = copy.deepcopy(flow).to(torch.bfloat16)
    convs = [layer.enc.cond_layer for layer in flow16.flows[::2]]
    packed = {rev: cc.pack_coupling_block(flow, reverse=rev) for rev in (False, True)}
    max_err, timed = 0.0, None
    for label, t, lengths in [("convert B=1 T=1024", BUCKET, [FRAMES]), ("ragged B=2 T=333", 333, [333, 200]),
                              ("ragged B=8 T=512", 512, RAGGED_B8), ("length 0 B=1 T=1024", BUCKET, [0])]:
        b = len(lengths)
        lens = lens_on_card(lengths)
        live = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[..., None]
        x = rand_bf16(gen, b, t, c) * live
        g = rand_bf16(gen, b, 1, gin, scale=1.0)
        g_all = {rev: cc.coupling_g_stack(flow, g, reverse=rev, convs=convs) for rev in (False, True)}
        fwd = cc.coupling_block(x, lens, packed[False], g_all[False])
        max_err = max(max_err, agree(f"{label} forward", fwd,
                                     cc.coupling_block_plain(x, lens, packed[False], g_all[False]), WN_MEAN_TOL, lengths))
        back = cc.coupling_block(fwd, lens, packed[True], g_all[True])
        max_err = max(max_err, agree(f"{label} reverse", back,
                                     cc.coupling_block_plain(fwd, lens, packed[True], g_all[True]), WN_MEAN_TOL, lengths))
        trip, peak = float((back.float() - x.float()).abs().max()), float(x.float().abs().max())
        print(f"{label} forward then reverse: max |back - x| {trip:.3e} (bar {ROUND_TRIP_TOL * peak:.3e})")
        check(trip <= ROUND_TRIP_TOL * peak, f"{label}: the flow does not invert")
        if not max(lengths):
            check(bool((fwd == 0).all()) and bool((back == 0).all()), f"{label}: output not all zero")
        launch = {**cc.last_launch, **cc.kernel_attributes()}
        print(f"{label} {cluster_line(launch)}")
        check(launch["max_clusters"] >= 1, "no cluster fits on the card")
        timed = timed or (x, g, lens, g_all, launch)
    x, g, lens, g_all, launch = timed
    mask = (torch.arange(BUCKET, device="cuda") < FRAMES).to(torch.bfloat16)[None, None]
    x_bct, g_t = x.transpose(1, 2).contiguous(), g.transpose(1, 2)
    stock = flow16(x_bct, mask, g_t).transpose(1, 2)
    print(f"stock bf16 layers vs kernel (forward): max diff "
          f"{float((stock.float() - cc.coupling_block(x, lens, packed[False], g_all[False]).float()).abs().max()):.3e}")

    def both(fn):
        return lambda: fn(fn(x, lens, packed[False], g_all[False]), lens, packed[True], g_all[True])

    # per direction: S × (pre C/2→H, the WaveNet, post H→C/2); the entry holds
    # both directions, as one convert runs them
    flop = 2 * n_flows * (wn_flop(FRAMES, n_layers, k, h) + 2.0 * FRAMES * 2 * (c // 2) * h)
    weights = numel(packed[False], ("wp", "bp", "w_in", "b_in", "w_rs", "b_rs", "wq", "bq"))
    nbytes = 2 * 2 * (FRAMES * c + BUCKET * c + g_all[False].numel() + weights)
    entry = kernel_entry(
        kind, "coupling_block", "openvoice_tpu_torch/csrc/coupling.cu",
        "openvoice_tpu/ops/coupling_pallas.py:212", max_err, time_ms(both(cc.coupling_block)),
        time_ms(both(cc.coupling_block), cold=False), time_ms(both(cc.coupling_block_plain), 5),
        time_ms(lambda: flow16(flow16(x_bct, mask, g_t), mask, g_t, reverse=True)), flop, nbytes)
    return {**entry, "cluster": launch}


# -- K3 / K4 -------------------------------------------------------------------

KS, DILS = (3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 3, 5))  # the V2 decoder's branches
N_TAPS = sum(2 * k * len(d) for k, d in zip(KS, DILS))      # 126 [C, C] taps a stage


def resblocks(c: int, gen):
    from torch import nn

    from openvoice_tpu_torch.nn.hifigan import ResBlock1

    return redraw(nn.ModuleList(ResBlock1(c, k, d) for k, d in zip(KS, DILS)), gen)


def stock_mrf(rbs, x_bct, mask):
    return sum(rb(x_bct, mask) for rb in rbs) / len(rbs)


def mrf_check(kind: str, gen) -> dict:
    import torch

    from openvoice_tpu_torch.ops import mrf_cuda

    phase("3d. kernel check: K3 mrf_stage (csrc/mrf.cu) vs its plain version")
    max_err, ms, hot_ms, plain_ms, stock_ms, flop, nbytes, stage_ms = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, []
    launch = []
    # V2 stages 0 and 1 of the 10 s clip; a batcher group of 8 ragged rows at
    # bucket 256; the chain's shortest sentence (a 3-word line, 98 frames, in
    # bucket 128); and a ragged batch of each width
    for c, rate in [(256, 8), (128, 64)]:
        rbs = resblocks(c, gen)
        rbs16 = copy.deepcopy(rbs).to(torch.bfloat16)
        packed = mrf_cuda.pack_stage_weights(list(rbs))
        timed = None
        group = [256 * rate - 37 * rate * i for i in range(8)]
        for label, t, lengths in [(f"stage C={c} B=1 T={BUCKET * rate}", BUCKET * rate, [FRAMES * rate]),
                                  (f"group C={c} B=8 T={256 * rate}", 256 * rate, group),
                                  (f"chain C={c} B=1 T={128 * rate}", 128 * rate, [98 * rate]),
                                  (f"ragged C={c} B=2 T=1001", 1001, [1001, 613])]:
            x, lens = rand_bf16(gen, len(lengths), t, c), lens_on_card(lengths)
            out = mrf_cuda.mrf_stage(x, lens, packed)
            max_err = max(max_err, agree(label, out, mrf_cuda.mrf_stage_plain(x, lens, packed), MRF_MEAN_TOL, lengths))
            timed = timed or (x, lens, t, lengths[0])
        x, lens, t, n = timed
        rows, tile, stages, group, width, _ = mrf_cuda.launch_plan(c, t, packed["kernel_sizes"],
                                                                   packed["dilation_sizes"])
        attrs = mrf_cuda.kernel_attributes(width)
        launch.append({"c": c, "rows": rows, "tile": tile, "stages": stages * group, "group": group,
                       "width": width, "warpgroups": mrf_cuda.WARPGROUPS, **attrs})
        print(f"K3 launch C={c}: {rows}/{tile} rows, {stages * group} ring slabs in groups of "
              f"{group}, m64n{width} products, {mrf_cuda.WARPGROUPS} warpgroups, "
              f"{attrs['registers']} registers, {attrs['spill_bytes']} B local, {-(-t // tile)} tiles")
        mask = (torch.arange(t, device="cuda") < n).to(torch.bfloat16)[None, None]
        x_bct = (x.transpose(1, 2) * mask).contiguous()
        stock = stock_mrf(rbs16, x_bct, mask).transpose(1, 2)
        print(f"stock bf16 layers vs kernel: max diff "
              f"{float((stock.float() - mrf_cuda.mrf_stage(x, lens, packed).float()).abs().max()):.3e}")
        times = (time_ms(lambda: mrf_cuda.mrf_stage(x, lens, packed), 10),
                 time_ms(lambda: mrf_cuda.mrf_stage_plain(x, lens, packed), 3),
                 time_ms(lambda: stock_mrf(rbs16, x_bct, mask), 10),
                 time_ms(lambda: mrf_cuda.mrf_stage(x, lens, packed), 10, cold=False))
        print(f"C={c} T={t}: kernel {times[0]:.4f} ms ({times[3]:.4f} with a hot L2)  plain {times[1]:.4f} ms  "
              f"stock bf16 layers {times[2]:.4f} ms")
        ms, plain_ms, stock_ms, hot_ms = ms + times[0], plain_ms + times[1], stock_ms + times[2], hot_ms + times[3]
        stage_ms.append(times[0])
        flop += 2.0 * n * N_TAPS * c * c
        nbytes += 2 * (n * c + t * c + numel(packed, ("w", "b")))
    # the entry holds both stages, as one convert runs them
    entry = kernel_entry(kind, "mrf_stage", "openvoice_tpu_torch/csrc/mrf.cu",
                         "openvoice_tpu/ops/mrf_pallas.py:515", max_err, ms, hot_ms, plain_ms, stock_ms, flop,
                         nbytes)
    return {**entry, "stage_ms": stage_ms, "mrf_launch": launch}


def tail_check(kind: str, gen) -> dict:
    import torch
    import torch.nn.functional as F

    from openvoice_tpu_torch.nn.conv import conv1d, conv_transpose1d
    from openvoice_tpu_torch.ops import tail_cuda

    phase("3e. kernel check: K4 tail_stage (csrc/tail.cu) vs its plain version")
    max_err, ms, hot_ms, plain_ms, stock_ms, flop, nbytes, stage_ms = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, []
    launches_ = []
    u, k_up = 2, 4
    # V2 stages 2 (128 → 64 channels) and 3 (64 → 32, then conv_post and
    # tanh) of the 10 s clip; a batcher group of 8 ragged rows at bucket 256;
    # and a ragged batch
    for c_in, c, rate_in, last in [(128, 64, 64, False), (64, 32, 128, True)]:
        up, rbs = redraw(conv_transpose1d(c_in, c, k_up, u), gen), resblocks(c, gen)
        post = redraw(conv1d(c, 1, 7, bias=False), gen) if last else None
        up16, rbs16 = copy.deepcopy(up).to(torch.bfloat16), copy.deepcopy(rbs).to(torch.bfloat16)
        post16 = copy.deepcopy(post).to(torch.bfloat16) if last else None
        packed = tail_cuda.pack_tail_weights(up, list(rbs), post)
        timed = None
        group = [(256 - 37 * i) * rate_in * u for i in range(8)]
        for label, t_in, lengths in [
                (f"stage {c_in}→{c} B=1 T_in={BUCKET * rate_in}", BUCKET * rate_in, [FRAMES * rate_in * u]),
                (f"group {c_in}→{c} B=8 T_in={256 * rate_in}", 256 * rate_in, group),
                (f"ragged {c_in}→{c} B=2 T_in=501", 501, [1002, 614])]:
            x, lens = rand_bf16(gen, len(lengths), t_in, c_in), lens_on_card(lengths)
            out = tail_cuda.tail_stage(x, lens, packed)
            # the audio has no mask after conv_post: zeros start 3 samples late
            max_err = max(max_err, agree(label, out, tail_cuda.tail_stage_plain(x, lens, packed), MRF_MEAN_TOL,
                                         lengths, zero_after=3 if last else 0))
            timed = timed or (x, lens, t_in, lengths[0], {**tail_cuda.last_launch, **tail_cuda.kernel_attributes(
                c, tail_cuda.last_launch["smem"])})
        x, lens, t_in, n, launch = timed
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        live = tail_cuda.live_tiles(n, launch["tile"], 3 if last else 0, t_in * u)
        slots = max(launch["blocks_per_sm"], 1) * sms
        print(f"K4 launch {c_in}→{c}: {k4_launch_line(launch)}; {launch['tiles']} tiles, of which the exit rule "
              f"leaves {live} live at {FRAMES} frames (computed on the host from the rule, not measured); "
              f"{launch['blocks_per_sm']} block(s) an SM × {sms} SMs: {-(-live // slots)} waves ({live / slots:.2f})")
        check(launch["blocks_per_sm"] >= 1, "no K4 block fits on an SM")
        # the early exit, measured: at length 0 every tile (on the last stage
        # every tile but the first, which conv_post's reach keeps) lies past
        # the length, returns before any product and leaves exact zeros.
        # Without the exit the launch would do the whole grid's work, more
        # than the run at the true length does.
        lens0 = lens_on_card([0])
        out0 = tail_cuda.tail_stage(x, lens0, packed)
        torch.cuda.synchronize()
        check(bool((out0 == 0).all()), f"K4 {c_in}→{c} at length 0: output not all zero")
        empty_ms = time_ms(lambda: tail_cuda.tail_stage(x, lens0, packed), 10)
        mask_in = (torch.arange(t_in, device="cuda") < n // u).to(torch.bfloat16)[None, None]
        mask = (torch.arange(t_in * u, device="cuda") < n).to(torch.bfloat16)[None, None]
        x_bct = (x.transpose(1, 2) * mask_in).contiguous()

        def stock():
            y = stock_mrf(rbs16, up16(F.leaky_relu(x_bct, 0.1)) * mask, mask)
            return torch.tanh(post16(F.leaky_relu(y, 0.01))) if last else y

        print(f"stock bf16 layers vs kernel: max diff "
              f"{float((stock().transpose(1, 2).float() - tail_cuda.tail_stage(x, lens, packed).float()).abs().max()):.3e}")
        times = (time_ms(lambda: tail_cuda.tail_stage(x, lens, packed), 10),
                 time_ms(lambda: tail_cuda.tail_stage_plain(x, lens, packed), 3), time_ms(stock, 10),
                 time_ms(lambda: tail_cuda.tail_stage(x, lens, packed), 10, cold=False))
        print(f"{c_in}→{c} T_in={t_in}: kernel {times[0]:.4f} ms ({times[3]:.4f} with a hot L2), "
              f"{empty_ms:.4f} ms at length 0 (the tiles past it exit)  plain {times[1]:.4f} ms  "
              f"stock bf16 layers {times[2]:.4f} ms")
        check(empty_ms < 0.5 * times[0], f"K4 {c_in}→{c}: at length 0 the tiles do not exit early "
              f"({empty_ms:.4f} ms against {times[0]:.4f} at {n} samples)")
        ms, plain_ms, stock_ms, hot_ms = ms + times[0], plain_ms + times[1], stock_ms + times[2], hot_ms + times[3]
        stage_ms.append(times[0])
        launches_.append({**launch, "empty_ms": empty_ms})
        flop += 2.0 * n * (N_TAPS * c * c + (k_up // u) * c_in * c + (7 * c if last else 0))
        weights = numel(packed, ("w", "b", "up_w", "up_b")) + (packed["post_w"].numel() if last else 0)
        nbytes += 2 * ((n // u) * c_in + t_in * u * (1 if last else c) + weights)
    entry = kernel_entry(kind, "tail_stage", "openvoice_tpu_torch/csrc/tail.cu",
                         "openvoice_tpu/ops/mrf_pallas.py:731", max_err, ms, hot_ms, plain_ms, stock_ms, flop,
                         nbytes)
    return {**entry, "stage_ms": stage_ms, "stage_launch": launches_}


def k4_launch_line(launch: dict) -> str:
    """K4's launch, as `tail_cuda.last_launch` and `kernel_attributes` give it."""
    ring = ("the weight stream resident" if launch["stages"] == 0 else
            f"a ring of {launch['stages']} groups of {launch['group']} slabs")
    return (f"window {launch['rows']} rows, {launch['tile']} kept (halo {launch['halo']}), {ring}, products in "
            f"groups of up to 8, {launch['warpgroups']} warpgroups, {launch['registers']} "
            f"registers, {launch['spill_bytes']} B local a thread, {launch['smem']} B shared")


MELO_FRAMES, MELO_BUCKET = 866, 1024   # the longest prose line at 44.1 kHz, hop 512 (10.06 s), and its bucket


def tail_melo_check(gen) -> dict:
    """3f: K4 at MeloTTS-English's decoder stages 2-4, which no V1 or V2
    decoder gives it: 128 → 64 channels with upsample kernel 8, 64 → 32 with
    kernel 2, 32 → 16 with kernel 2 then conv_post and tanh (stride 2 each;
    inputs at 64, 128 and 256 samples a frame).  Each against its plain
    version at the longest line's frames in its bucket and on a ragged
    batch, at length 0 (the tiles past it exit), and timed."""
    import torch

    from openvoice_tpu_torch.nn.conv import conv1d, conv_transpose1d
    from openvoice_tpu_torch.ops import tail_cuda

    phase("3f. kernel check: K4 tail_stage (csrc/tail.cu) at MeloTTS's stages 2-4 vs its plain version")
    out, u = {"stages": []}, 2
    for c_in, c, k_up, rate_in, last in [(128, 64, 8, 64, False), (64, 32, 2, 128, False), (32, 16, 2, 256, True)]:
        up, rbs = redraw(conv_transpose1d(c_in, c, k_up, u), gen), resblocks(c, gen)
        post = redraw(conv1d(c, 1, 7, bias=False), gen) if last else None
        packed = tail_cuda.pack_tail_weights(up, list(rbs), post)
        worst, timed = 0.0, None
        for label, t_in, lengths in [
                (f"melo {c_in}→{c} k{k_up} B=1 T_in={MELO_BUCKET * rate_in}", MELO_BUCKET * rate_in,
                 [MELO_FRAMES * rate_in * u]),
                (f"melo {c_in}→{c} k{k_up} ragged B=2 T_in=501", 501, [1002, 614])]:
            x, lens = rand_bf16(gen, len(lengths), t_in, c_in), lens_on_card(lengths)
            got = tail_cuda.tail_stage(x, lens, packed)
            worst = max(worst, agree(label, got, tail_cuda.tail_stage_plain(x, lens, packed), MRF_MEAN_TOL,
                                     lengths, zero_after=3 if last else 0))
            timed = timed or (x, lens, {**tail_cuda.last_launch, **tail_cuda.kernel_attributes(
                c, tail_cuda.last_launch["smem"])})
        x, lens, launch = timed
        lens0 = lens_on_card([0])  # made once: a copy from the host inside the timed call would be timed too
        zero = tail_cuda.tail_stage(x, lens0, packed)
        torch.cuda.synchronize()
        check(bool((zero == 0).all()), f"K4 melo {c_in}→{c} at length 0: output not all zero")
        ms = time_ms(lambda: tail_cuda.tail_stage(x, lens, packed), 10)
        empty_ms = time_ms(lambda: tail_cuda.tail_stage(x, lens0, packed), 10)
        print(f"K4 melo launch {c_in}→{c} k{k_up}: {k4_launch_line(launch)}, {launch['tiles']} tiles, "
              f"{launch['blocks_per_sm']} block(s) an SM; {ms:.4f} ms at {MELO_FRAMES} frames, {empty_ms:.4f} ms "
              f"at length 0")
        check(empty_ms < 0.5 * ms, f"K4 melo {c_in}→{c}: at length 0 the tiles do not exit early")
        out["stages"].append({"c_in": c_in, "c": c, "k_up": k_up, "last": last, "max_abs_err": worst, "ms": ms,
                              "empty_ms": empty_ms, **launch})
    return out


def print_windows() -> None:
    """The time windows the wrappers chose in the checks above: rows a block
    holds in shared memory, and the rows of them it keeps (the rest is halo,
    recomputed by the neighbours)."""
    from openvoice_tpu_torch.ops import _frag

    print("\ntime windows (rows held / kept a block):")
    lines = {f"  {kernel} {tuple(sizes)} halo {halo}, {want} wanted: {rows} / {tile} "
             f"({rows / tile:.2f}x recomputation)"
             for (kernel, *sizes, halo, want, _multiples), (rows, tile) in _frag.chosen_windows().items()}
    print("\n".join(sorted(lines)))
    from openvoice_tpu_torch.ops import mrf_cuda

    print("K3 weight ring (slabs of 32·C bytes): " + ", ".join(
        f"C={c} {rows} rows: {n} slabs" for (c, rows), n in sorted(mrf_cuda.chosen_stages().items())))


def sweep(kind: str, only: list[str]) -> None:
    """Time K1-K4 at the main path's shapes over the knobs their wrappers
    have: K1's and K2's ring depth, K3's weight-ring depth
    and tile target, and K4's ring reserve and tile target.  Each variant goes
    through the kernel's whole check, so a variant that disagrees with the
    plain version fails the run.  The wrappers' defaults were chosen from
    this table."""
    import importlib

    import torch

    # K1 and K2: the ring's depth (groups at most; their launch shape is
    # fixed, _frag's CLUSTER_* constants)
    cluster = [{}, {"_MAX_STAGES": 2}, {"_MAX_STAGES": 4}]
    grids = [
        (wn_check, "wn_cuda", cluster),
        (coupling_check, "coupling_cuda", cluster),
        # K3: the ring's depth (one group a stage at C = 128), and a 200-row
        # tile target (a 320-row window and 16 slabs at C = 128; C = 256
        # keeps its 192 rows)
        (mrf_check, "mrf_cuda", [{}, {"_MAX_STAGES": 4}, {"_TILE_TARGET": 200}]),
        # K4: the ring's reserve in bytes (64 KB shrinks stage 2's window to
        # 320 rows), and the tile target (stage 2 keeps its 448 rows; stage 3
        # takes 512 rows at 328, 768 from 640 on)
        (tail_check, "tail_cuda", [{}, {"_RING_RESERVE": 65536}, {"_TILE_TARGET": 328}, {"_TILE_TARGET": 1000}]),
    ]
    if only:
        grids = [grid for grid in grids if grid[1].removesuffix("_cuda") in only]
        check(bool(grids), f"--sweep takes kernels among wn coupling mrf tail, not {only}")
    table = []
    for fn, module, variants in grids:
        mod = importlib.import_module(f"openvoice_tpu_torch.ops.{module}")
        default = {k: getattr(mod, k) for v in variants for k in v}
        for variant in variants:
            for k, v in {**default, **variant}.items():
                setattr(mod, k, v)
            gen = torch.Generator().manual_seed(SEED + 2)  # the same inputs for every variant
            entry = fn(kind, gen)
            table.append((entry["name"], {**default, **variant}, entry["ms"], entry.get("stage_ms", []),
                          entry["stock_bf16_ms"], {**default, **variant} == default,
                          entry.get("cluster") or entry.get("stage_launch") or entry.get("mrf_launch")))
        for k, v in default.items():
            setattr(mod, k, v)
    if not only or "mrf" in only:
        mrf_one_tile()
    if not only or "tail" in only:
        tail_one_tile()
        tail_lengths()
    phase("sweep: kernel ms at the convert shapes (K2 both directions, K3 and K4 both stages)")
    for name, knob, ms, stage_ms, stock_ms, is_default, launch in table:
        stages = f" = {' + '.join(f'{t:.4f}' for t in stage_ms)}" if stage_ms else ""
        setting = "  ".join(f"{k.strip('_').lower()} {v}" for k, v in knob.items())
        if isinstance(launch, dict):  # K1's and K2's cluster line
            full = f", {launch['full_ms']:.4f} ms at {BUCKET} frames" if "full_ms" in launch else ""
            clusters = (f"  [{launch['rows']}/{launch['tile']} rows, {launch['ctas']} CTAs, {launch['max_clusters']} "
                        f"clusters fit, m64n{launch['width']} x {launch['warpgroups']}, ring {launch['stages']} x "
                        f"{launch['group']} units, {launch['registers']} regs, {launch['spill_bytes']} B spilled"
                        f"{full}]")
        elif launch and "width" in launch[0]:   # K3's launch per stage
            clusters = "  [" + "; ".join(
                f"C={st['c']} {st['rows']}/{st['tile']} rows, {st['stages']} slabs by {st['group']}, "
                f"m64n{st['width']} x {st['warpgroups']}, {st['registers']} regs, {st['spill_bytes']} B local"
                for st in launch) + "]"
        elif launch:                  # K4's launch per stage
            clusters = "  [" + "; ".join(
                f"{st['rows']}/{st['tile']} rows, {st['tiles']} tiles, ring {st['stages']} x {st['group']} slabs, "
                f"{st['warpgroups']} WG, {st['registers']} regs, {st['spill_bytes']} B local, "
                f"{st['blocks_per_sm']}/SM, {st['empty_ms']:.4f} ms at length 0"
                for st in launch) + "]"
        else:
            clusters = ""
        print(f"  {name:15s} {setting}: {ms:8.4f} ms{stages}{clusters}  "
              f"(stock bf16 layers {stock_ms:.4f} ms){'  <- default' if is_default else ''}")
    print_windows()


def mrf_one_tile() -> None:
    """K3 on one block's tile against the whole convert shape (114 and 249
    blocks that share the L2): when one block alone takes as long as the
    grid, blocks do not contend for L2 and the time is in each block's own
    path."""
    import torch

    from openvoice_tpu_torch.ops import mrf_cuda

    phase("sweep: K3 on one tile and on the convert shape")
    gen = torch.Generator().manual_seed(SEED + 3)
    for c, t_full in [(256, BUCKET * 8), (128, BUCKET * 64)]:
        packed = mrf_cuda.pack_stage_weights(list(resblocks(c, gen)))
        one = mrf_cuda.launch_plan(c, t_full, packed["kernel_sizes"], packed["dilation_sizes"])[1]
        for t in (one, t_full):
            x, lens = rand_bf16(gen, 1, t, c), lens_on_card([t])
            ms = time_ms(lambda: mrf_cuda.mrf_stage(x, lens, packed), 10)
            print(f"  K3 C={c} T={t:6d} ({-(-t // one)} blocks): {ms:.4f} ms")


def tail_one_tile() -> None:
    """K4 at its default knobs on one block's tile against the whole convert
    shape: when one block alone takes as long as each wave of the grid,
    blocks do not contend for L2 and the time is in each block's own path."""
    import torch

    from openvoice_tpu_torch.nn.conv import conv1d, conv_transpose1d
    from openvoice_tpu_torch.ops import tail_cuda

    phase("sweep: K4 on one tile and on the convert shape")
    gen = torch.Generator().manual_seed(SEED + 3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c_in, c, rate_in, last in [(128, 64, 64, False), (64, 32, 128, True)]:
        post = redraw(conv1d(c, 1, 7, bias=False), gen) if last else None
        packed = tail_cuda.pack_tail_weights(redraw(conv_transpose1d(c_in, c, 4, 2), gen), list(resblocks(c, gen)),
                                             post)
        t_full = BUCKET * rate_in
        x = rand_bf16(gen, 1, t_full, c_in)
        lens = lens_on_card([FRAMES * rate_in * 2])
        tail_cuda.tail_stage(x, lens, packed)
        launch = {**tail_cuda.last_launch, **tail_cuda.kernel_attributes(c, tail_cuda.last_launch["smem"])}
        full = time_ms(lambda: tail_cuda.tail_stage(x, lens, packed), 10)
        live = tail_cuda.live_tiles(FRAMES * rate_in * 2, launch["tile"], 3 if last else 0, t_full * 2)
        waves = -(-live // (launch["blocks_per_sm"] * sms))
        one_x = x[:, : launch["tile"] // 2].contiguous()
        one_lens = lens_on_card([launch["tile"]])
        one = time_ms(lambda: tail_cuda.tail_stage(one_x, one_lens, packed), 10)
        print(f"  K4 {c_in}→{c}: one {launch['rows']}/{launch['tile']}-row tile {one:.4f} ms; convert shape "
              f"{full:.4f} ms = {waves} waves of {full / waves:.4f} ms ({live} live tiles)")


def tail_lengths() -> None:
    """K4 at its default knobs, B = 1, cold, on clips of other lengths and
    buckets than the main path's: the time of both stages beside the tiles,
    the live tiles the exit rule leaves (computed on the host) and the waves
    they take."""
    import torch

    from openvoice_tpu_torch.nn.conv import conv1d, conv_transpose1d
    from openvoice_tpu_torch.ops import tail_cuda

    phase("sweep: K4 at other lengths (bucket, true frames)")
    gen = torch.Generator().manual_seed(SEED + 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stages = []
    for c_in, c, rate_in, last in [(128, 64, 64, False), (64, 32, 128, True)]:
        post = redraw(conv1d(c, 1, 7, bias=False), gen) if last else None
        stages.append((c_in, c, rate_in, last, tail_cuda.pack_tail_weights(
            redraw(conv_transpose1d(c_in, c, 4, 2), gen), list(resblocks(c, gen)), post)))
    for bucket, frames in [(512, 430), (1024, 512), (1024, FRAMES), (1024, 1024), (2048, 1722)]:
        total, parts = 0.0, []
        for c_in, c, rate_in, last, packed in stages:
            t_in, n = bucket * rate_in, frames * rate_in * 2
            x, lens = rand_bf16(gen, 1, t_in, c_in), lens_on_card([n])
            tail_cuda.tail_stage(x, lens, packed)
            launch = {**tail_cuda.last_launch, **tail_cuda.kernel_attributes(c, tail_cuda.last_launch["smem"])}
            ms = time_ms(lambda: tail_cuda.tail_stage(x, lens, packed), 10)
            live = tail_cuda.live_tiles(n, launch["tile"], 3 if last else 0, t_in * 2)
            parts.append(f"{c_in}→{c} {ms:.4f} ms, {launch['tiles']} tiles, {live} live, "
                         f"{live / (launch['blocks_per_sm'] * sms):.2f} waves")
            total += ms
        print(f"  K4 bucket {bucket}, {frames} frames: {total:.4f} ms = " + "; ".join(parts))


def voice(seconds: float, f0: float, seed: int) -> np.ndarray:
    """Speech-like signal: vibrato harmonic tone, syllable-rate envelope, noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * SR)) / SR
    phase_ = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * tt))) / SR
    x = sum(np.sin(k * phase_) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 2.5 * tt), 0, None) ** 0.5
    return (0.3 * x * env + 0.005 * rng.standard_normal(len(tt))).astype(np.float32)


def seed_flow_posts(model, seed: int) -> None:
    """The random init zeroes each coupling's `post` (the flow would be the
    identity): seeded random values instead."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.flow.flows[::2]:
            w = layer.post.weight
            s = 1.0 / math.sqrt(w.shape[1] * w.shape[2])
            w.copy_(torch.empty(w.shape).uniform_(-s, s, generator=gen))
            layer.post.bias.copy_(torch.empty(w.shape[0]).uniform_(-s, s, generator=gen))


def converter():
    """Full-width V2 converter on the card with seeded random weights.  The
    init zeroes each coupling's `post` (the flow would be the identity), so
    those get seeded random values too."""
    from openvoice_tpu_torch import V2_CONVERTER_CONFIG, ToneColorConverter

    tc = ToneColorConverter(cfg=V2_CONVERTER_CONFIG)
    check(tc.device.type == "cuda", f"converter landed on {tc.device}")
    tc.init_random(SEED)
    seed_flow_posts(tc.model, SEED + 1)
    return tc


KERNEL_MODULES = ("stft_cuda", "wn_cuda", "coupling_cuda", "mrf_cuda", "tail_cuda")
KERNEL_NAMES = ("stft_magnitude", "wn_stack", "coupling_block", "mrf_stage", "tail_stage")


def zero_launch_counts() -> None:
    import importlib

    for module in KERNEL_MODULES:
        importlib.import_module(f"openvoice_tpu_torch.ops.{module}").launches = 0


def launch_counts() -> dict:
    import importlib

    return {name: importlib.import_module(f"openvoice_tpu_torch.ops.{module}").launches
            for name, module in zip(KERNEL_NAMES, KERNEL_MODULES)}


def check_audio(tc, out: np.ndarray, n_frames: int) -> None:
    cfg = tc.cfg
    check(out.shape == (n_frames * cfg.upsample_factor,), f"audio shape {out.shape}, frames {n_frames}")
    check(bool(np.isfinite(out).all()), "audio not finite")
    peak = float(np.abs(out).max())
    check(peak <= 1.0, f"audio peak {peak} > 1")
    found = tc.detect_watermark(out, 2)
    print(f"audio {out.shape} ({len(out) / SR:.2f} s), peak {peak:.4f}, rms {float(np.sqrt(np.mean(out ** 2))):.5f}, "
          f"watermark {found!r}")
    check(found == MESSAGE, f"watermark read back {found!r}, wrote {MESSAGE!r}")


def warm_numbers(tc, src: np.ndarray, ses: dict, fast: bool, smi: str) -> dict:
    """Warm timings of one mode: whole convert (host pad, noise, device work,
    readback, watermark) by host clock, eager and as a graph replay (median
    of 5 each, in the order eager, graph, graph, eager); the device part by
    CUDA events per stage; the profiler's launch count and busy share of
    each; the graph convert's wall split into its host parts."""
    import torch

    def convert():
        return tc.convert(src, ses["se_src"], ses["se_tgt"], tau=0.3, seed=SEED, message=MESSAGE, fast=fast)

    torch.cuda.reset_peak_memory_stats()
    blocks = ab_walls(convert, tc)
    walls = {v: statistics.median(ms for w, ms in blocks if w == v) for v in ("eager", "graph")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9  # read before the stage timing's L2 flush buffer exists
    stages = stage_times(tc, src, ses["se_src"], ses["se_tgt"], fast)
    _L2_FLUSH.clear()
    print(f"warm convert of {len(src) / SR:.1f} s, median of 5 a block, blocks in order "
          + ", ".join(f"{v} {ms:.2f} ms" for v, ms in blocks)
          + f"; graph {len(src) / SR / walls['graph'] * 1e3:.1f} audio-s/s; peak device memory {peak_gb:.2f} GB"
          + f"  [{smi}]")
    print("device time by stage (ms, CUDA events, median of 5, each from a cold L2): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    with eager(tc):
        busy_eager = device_profile(convert, walls["eager"], "warm convert, eager")
    busy_graph = device_profile(convert, walls["graph"], "warm convert, graph replay")
    split = host_split(tc, src, ses, fast)
    print("the graph convert's wall by part (ms, host clock, median of 5): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f"  [{smi}]")
    return {"walls_ms": walls, "blocks_ms": blocks, "busy": {"eager": busy_eager, "graph": busy_graph},
            "stages_ms": stages, "host_split_ms": split, "peak_gb": peak_gb}


# -- CUDA graphs (runtime/graphs.py) -----------------------------------------

@contextlib.contextmanager
def eager(*owners):
    """Within: every call of these converters, TTS models or batchers runs
    eagerly (their graphs stay, unused)."""
    saved = [o.graphs.enabled for o in owners]
    for o in owners:
        o.graphs.enabled = False
    try:
        yield
    finally:
        for o, was in zip(owners, saved):
            o.graphs.enabled = was


def graph_state(graphs) -> dict:
    """A GraphCache's numbers: graphs held, captures, replays, capture
    seconds, and the bytes of its device's pool (all owners' graphs)."""
    from openvoice_tpu_torch.runtime.graphs import pool_bytes

    return {"graphs": len(graphs), "captures": graphs.captures, "replays": graphs.replays,
            "capture_s": graphs.capture_seconds, "pool_bytes": pool_bytes(graphs.device)}


def ab_walls(fn, *owners, runs: int = 5) -> list[tuple[str, float]]:
    """Host-clock walls of `fn` in ms, median of `runs` a block, in the
    blocks eager, graph, graph, eager (eager: `owners`' graphs off)."""
    blocks = []
    for variant in ("eager", "graph", "graph", "eager"):
        times = []
        with eager(*owners) if variant == "eager" else contextlib.nullcontext():
            for _ in range(runs):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        blocks.append((variant, statistics.median(times)))
    return blocks


def same_bits(label: str, got, ref) -> None:
    """A graph replay's result against the eager route's on the same inputs:
    bit-equal."""
    got, ref = np.asarray(got), np.asarray(ref)
    check(got.shape == ref.shape, f"{label}: shape {got.shape} against {ref.shape}")
    diff = float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max()) if got.size else 0.0
    print(f"{label}: {'bit-equal' if diff == 0 else f'max diff {diff:.3e}'} ({got.shape})")
    check(diff == 0, f"{label}: the replay is not bit-equal to the eager route")


def expect_replay(label: str, graphs, before: dict, replays: int | None = None) -> dict:
    """The call since `before` captured nothing new and replayed (`replays`
    times where given)."""
    after = graph_state(graphs)
    n = after["replays"] - before["replays"]
    print(f"{label}: {n} replay(s), {after['captures'] - before['captures']} new capture(s); "
          f"{after['graphs']} graphs held, pool {after['pool_bytes'] / 1e6:.1f} MB")
    check(after["captures"] == before["captures"], f"{label}: the repeat captured a new graph")
    check(n > 0 if replays is None else n == replays, f"{label}: {n} replays")
    return after


def eager_convert(tc, audio: np.ndarray, se_src, se_tgt, tau: float, seed: int, fast: bool) -> np.ndarray:
    """The eager route of `convert` on the same inputs, without the graph
    cache: the STFT kernel, then `S.voice_conversion` with a float tau."""
    import torch

    from openvoice_tpu_torch.api import _spec_from_audio
    from openvoice_tpu_torch.models import synthesizer as TS
    from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude
    from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket

    cfg, dev = tc.cfg, tc.device
    padded, n = _spec_from_audio(audio, cfg)
    bucket = round_up_to_bucket(n)
    buf = np.zeros((1, (bucket - 1) * cfg.hop_length + cfg.filter_length), np.float32)
    buf[0, : len(padded)] = padded
    noise = np.random.default_rng(seed).standard_normal((1, bucket, cfg.inter_channels)).astype(np.float32)
    with torch.inference_mode():
        spec = stft_magnitude(torch.from_numpy(buf).to(dev), cfg.filter_length, cfg.hop_length, cfg.win_length)
        out, _ = TS.voice_conversion(tc.model, spec, torch.tensor([n], device=dev), tc._as_g(se_src),
                                     tc._as_g(se_tgt), float(tau), torch.from_numpy(noise).to(dev), fast=fast,
                                     dec_cache=tc._require_dec_cache() if fast else None)
        return out[0, : n * cfg.upsample_factor, 0].cpu().numpy()


def host_split(tc, src: np.ndarray, ses: dict, fast: bool, runs: int = 5) -> dict:
    """The graph convert's steps as `convert` takes them, each by host clock
    (median of `runs`): the host pad, the noise draw, staging + replay +
    the output's clone (enqueued), the readback (waits for the device), the
    watermark."""
    import torch

    from openvoice_tpu_torch import api
    from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket
    from openvoice_tpu_torch.runtime.graphs import GraphKey

    cfg = tc.cfg
    body = functools.partial(api.convert_body, tc.model, cfg, fast, tc._require_dec_cache() if fast else None)
    parts: dict[str, list[float]] = {}
    with torch.inference_mode():
        for _ in range(runs):
            torch.cuda.synchronize()
            marks = [time.perf_counter()]
            padded, n = api._spec_from_audio(src, cfg)
            bucket = round_up_to_bucket(n)
            buf = np.zeros((1, (bucket - 1) * cfg.hop_length + cfg.filter_length), np.float32)
            buf[0, : len(padded)] = padded
            marks.append(time.perf_counter())
            noise = np.random.default_rng(SEED).standard_normal((1, bucket, cfg.inter_channels)).astype(np.float32)
            marks.append(time.perf_counter())
            inputs = {"audio": buf, "lengths": np.asarray([n], np.int64), "g_src": api._g_host(ses["se_src"]),
                      "g_tgt": api._g_host(ses["se_tgt"]), "tau": np.full((1, 1, 1), 0.3, np.float32),
                      "noise": noise}
            out = tc.graphs.run(GraphKey("convert", bucket=bucket, batch=1, fast=fast), body, inputs)
            marks.append(time.perf_counter())
            audio = out[0, : n * cfg.upsample_factor, 0].cpu().numpy()
            marks.append(time.perf_counter())
            tc.add_watermark(audio, MESSAGE)
            marks.append(time.perf_counter())
            for name, a, b in zip(("pad", "noise", "stage + replay (enqueue)", "readback (device wait)",
                                   "watermark"), marks, marks[1:]):
                parts.setdefault(name, []).append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def convert_graph_checks(tc, src: np.ndarray, ses: dict, fast: bool, smi: str) -> dict:
    """Phases 4-5, the graph of one mode: the repeat of the clip's convert
    replays the graph its first convert captured, with the same launches; the
    replay is bit-equal to the eager `S.voice_conversion` route and to
    `convert` with the graphs off; another clip of the bucket with another
    tau, g, length and noise replays and gives the eager result."""
    import torch

    from openvoice_tpu_torch.runtime.graphs import GraphKey

    name = "serving" if fast else "f32"
    key = GraphKey("convert", bucket=BUCKET, batch=1, fast=fast, device=str(tc.device))
    check(key in tc.graphs.keys(), f"the first {name} convert captured no graph {key}")
    expected = ({"stft_magnitude": 1, "wn_stack": 1, "coupling_block": 2, "mrf_stage": 2, "tail_stage": 2}
                if fast else {"stft_magnitude": 1, "wn_stack": 0, "coupling_block": 0, "mrf_stage": 0,
                              "tail_stage": 0})
    kw = dict(tau=0.3, seed=SEED, message="", fast=fast)
    before = graph_state(tc.graphs)
    torch.cuda.synchronize()
    zero_launch_counts()
    replayed = tc.convert(src, ses["se_src"], ses["se_tgt"], **kw)
    torch.cuda.synchronize()
    launches = launch_counts()
    expect_replay(f"{name} convert, repeat", tc.graphs, before, 1)
    print(f"{name} convert replay: kernel launches {launches}")
    check(launches == expected, f"a {name} convert replay must count {expected}, not {launches}")
    same_bits(f"{name} replay against the eager S.voice_conversion route",
              replayed, eager_convert(tc, src, ses["se_src"], ses["se_tgt"], 0.3, SEED, fast))
    with eager(tc):
        same_bits(f"{name} replay against convert with the graphs off",
                  replayed, tc.convert(src, ses["se_src"], ses["se_tgt"], **kw))
    # another clip of the same bucket (775 frames), another tau, the two
    # embeddings swapped, another seed: the graph must not have frozen a value
    other = voice(9.0, 190.0, seed=31)
    kw2 = dict(tau=0.65, seed=SEED + 9, message="", fast=fast)
    before = graph_state(tc.graphs)
    got = tc.convert(other, ses["se_tgt"], ses["se_src"], **kw2)
    expect_replay(f"{name} convert of another clip of the bucket", tc.graphs, before, 1)
    with eager(tc):
        want = tc.convert(other, ses["se_tgt"], ses["se_src"], **kw2)
    same_bits(f"{name} replay with other tau, g, length and noise against eager", got, want)
    check(float(np.abs(got[: len(replayed)] - replayed[: len(got)]).max()) > 0, "the other clip converted alike")
    state = graph_state(tc.graphs)
    per_key = {str(k[:6]): round(g.capture_s, 4) for k, g in tc.graphs._graphs.items()}
    print(f"{name}: converter graphs {state['graphs']} (capture s each {per_key}), {state['capture_s']:.3f} s "
          f"of capture in all, device pool {state['pool_bytes'] / 1e6:.1f} MB  [{smi}]")
    return {**state, "launches_replay": launches}


def main_path(tc, tmp: str, smi: str) -> tuple:
    import torch

    from openvoice_tpu_torch.api import _spec_from_audio
    from openvoice_tpu_torch.audio.io import write_wav

    phase("4. main path: extract_se → convert, V2 full width, f32")
    cfg = tc.cfg
    refs = []
    for i, (secs, f0) in enumerate([(6.0, 110.0), (8.0, 220.0)]):
        refs.append(os.path.join(tmp, f"ref{i}.wav"))
        write_wav(refs[-1], voice(secs, f0, seed=i), SR)
    src = voice(10.0, 150.0, seed=7)
    n_frames = _spec_from_audio(src, cfg)[1]  # 861 at V2's hop 256: bucket 1024
    check(n_frames == FRAMES, f"the 10 s clip has {n_frames} frames, the kernel checks assume {FRAMES}")

    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    se_src = tc.extract_se(refs[:1])
    before = graph_state(tc.graphs)
    se_tgt = tc.extract_se(refs[1:])  # the same bucket (768) and batch: it replays the first one's graph
    replays_se = graph_state(tc.graphs)["replays"] - before["replays"]
    out = tc.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message=MESSAGE)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    print(f"first extract_se ×2 + convert: {first_s:.3f} s; kernel launches {launches}")
    # one STFT launch per extract_se batch and one per convert; the f32 mode
    # runs stock layers behind it
    check(launches == {"stft_magnitude": 3, "wn_stack": 0, "coupling_block": 0, "mrf_stage": 0,
                       "tail_stage": 0}, "the f32 path did not run the STFT kernel 3 times and no other")
    # extract_se: the second file (another clip, another length) replayed the
    # first file's graph; a repeat replays again, bit-equal to eager
    check(replays_se == 1, f"the second extract_se replayed {replays_se} graphs, not 1")
    with eager(tc):
        same_bits("extract_se replay (another clip and length than the capture) against eager",
                  se_tgt, tc.extract_se(refs[1:]))
    before = graph_state(tc.graphs)
    again = tc.extract_se(refs[:1])
    expect_replay("extract_se, repeat", tc.graphs, before, 1)
    same_bits("extract_se replay against its first (eager, capturing) call", again, se_src)

    check(se_src.shape == se_tgt.shape == (1, cfg.gin_channels, 1), f"SE shape {se_src.shape}")
    check(bool(np.isfinite(se_src).all() and np.isfinite(se_tgt).all()), "SE not finite")
    check_audio(tc, out, n_frames)
    ses = {"se_src": se_src, "se_tgt": se_tgt, "refs": refs}
    graphs = convert_graph_checks(tc, src, ses, False, smi)
    return launches, ses, src, {**graphs, **warm_numbers(tc, src, ses, False, smi)}


def main_path_fast(tc, src: np.ndarray, ses: dict, smi: str) -> tuple[dict, dict]:
    import torch

    phase("5. main path, serving mode: convert(fast=True), V2 full width, bf16 through K1-K4")
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    out = tc.convert(src, ses["se_src"], ses["se_tgt"], tau=0.3, seed=SEED, message=MESSAGE, fast=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    print(f"first fast convert (packs the serving cache): {first_s:.3f} s; kernel launches {launches}")
    check(launches == {"stft_magnitude": 1, "wn_stack": 1, "coupling_block": 2, "mrf_stage": 2,
                       "tail_stage": 2}, "one serving convert must launch K5 1, K1 1, K2 2, K3 2, K4 2")
    check_audio(tc, out, FRAMES)
    graphs = {**convert_graph_checks(tc, src, ses, True, smi), **warm_numbers(tc, src, ses, True, smi)}

    # serving against parity on the card, watermark off
    fast = tc.convert(src, ses["se_src"], ses["se_tgt"], tau=0.3, seed=SEED, message="", fast=True)
    f32 = tc.convert(src, ses["se_src"], ses["se_tgt"], tau=0.3, seed=SEED, message="")
    diff, peak = float(np.abs(fast - f32).max()), float(np.abs(f32).max())
    print(f"serving against parity on the card: max |fast - f32| = {diff:.3e} = {diff / peak:.4f} of the "
          f"f32 peak {peak:.5f} (bar {FAST_VS_F32_TOL}); rms of the difference "
          f"{float(np.sqrt(np.mean((fast - f32) ** 2))):.3e}, of the f32 audio {float(np.sqrt(np.mean(f32 ** 2))):.3e}")
    check(diff <= FAST_VS_F32_TOL * peak, "the serving mode strays from the f32 mode")
    return launches, graphs


def stage_times(tc, audio: np.ndarray, se_src, se_tgt, fast: bool) -> dict:
    """Device time of each stage of convert's graph, run as
    models/synthesizer.py runs it in that mode."""
    import torch

    from openvoice_tpu_torch.api import _spec_from_audio
    from openvoice_tpu_torch.models.synthesizer import apply_generator, apply_wn
    from openvoice_tpu_torch.ops.coupling_cuda import coupling_block, coupling_g_stack
    from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude
    from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket

    cfg, model, dev = tc.cfg, tc.model, tc.device
    padded, n = _spec_from_audio(audio, cfg)
    bucket = round_up_to_bucket(n)
    buf = torch.zeros(1, (bucket - 1) * cfg.hop_length + cfg.filter_length, device=dev)
    buf[0, : len(padded)] = torch.from_numpy(padded).to(dev)
    gen = torch.Generator().manual_seed(SEED)
    noise = torch.randn(1, bucket, cfg.inter_channels, generator=gen).to(dev)
    y_mask = (torch.arange(bucket, device=dev) < n).float()[None, :, None]
    g_src, g_tgt = tc._as_g(se_src), tc._as_g(se_tgt)  # [1, 1, gin]

    def stft():
        return stft_magnitude(buf, cfg.filter_length, cfg.hop_length, cfg.win_length)

    with torch.inference_mode():
        if not fast:
            mask, g0 = y_mask.transpose(1, 2), torch.zeros_like(g_src).transpose(1, 2)
            gs, gt = g_src.transpose(1, 2), g_tgt.transpose(1, 2)
            spec, nz = stft().transpose(1, 2), noise.transpose(1, 2)
            z = model.enc_q(spec, mask, g0, 0.3, nz)[0]
            z_hat = model.flow(model.flow(z, mask, g=gs), mask, g=gt, reverse=True)
            return {
                "stft": time_ms(stft, 5),
                "enc_q": time_ms(lambda: model.enc_q(spec, mask, g0, 0.3, nz), 5),
                "flow fwd+rev": time_ms(lambda: model.flow(model.flow(z, mask, g=gs), mask, g=gt, reverse=True), 5),
                "dec": time_ms(lambda: model.dec(z_hat * mask, g=g0, x_mask=mask), 5),
            }
        cache, bf = tc._require_dec_cache(), torch.bfloat16
        enc = cache["enc_q"]
        y16, nz, gs, gt = y_mask.to(bf), noise.to(bf), g_src.to(bf), g_tgt.to(bf)
        g0, tau = torch.zeros_like(gs), torch.tensor(0.3, dtype=bf, device=dev)
        lengths = torch.tensor([n], dtype=torch.int32, device=dev)
        spec = stft().to(bf)

        def enc_q():
            x = enc["pre"](spec.transpose(1, 2)).transpose(1, 2) * y16
            x = apply_wn(model.enc_q.enc, x, y16, g=g0, stacked=cache["wn"]["enc_q"], cond=enc["cond"])
            stats = enc["proj"](x.transpose(1, 2)).transpose(1, 2) * y16
            m, logs = stats[..., : cfg.inter_channels], stats[..., cfg.inter_channels :]
            return ((m + nz * tau * torch.exp(logs)) * y16).contiguous()

        def flow(z):
            g_fwd = coupling_g_stack(model.flow, gs, reverse=False, convs=cache["flow_cond"])
            g_rev = coupling_g_stack(model.flow, gt, reverse=True, convs=cache["flow_cond"])
            z_p = coupling_block(z, lengths, cache["coupling"]["fwd"], g_fwd)
            return coupling_block(z_p, lengths, cache["coupling"]["rev"], g_rev)

        z = enc_q()
        z_hat = flow(z)
        return {
            "stft": time_ms(stft, 5),
            "enc_q (K1)": time_ms(enc_q, 5),
            "flow fwd+rev (K2)": time_ms(lambda: flow(z), 5),
            "dec (K3, K4)": time_ms(lambda: apply_generator(model.dec, z_hat * y16, g=g0, x_mask=y16, packed=cache), 5),
        }


def device_profile(fn, wall_ms: float | None, what: str = "warm convert") -> float | None:
    """torch.profiler over one warm call: the device's busy share of a warm
    call's wall time `wall_ms` (the call is `what`; None: the profiled call's
    own wall, for calls the profiler itself slows), printed with the kernels
    with the most device time, and returned (None when the profiler recorded
    no device time).  (A first profiled call pays the profiler's own
    start-up, so the second one is read.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
    wall_ms = profiled_ms if wall_ms is None else wall_ms

    def kernel(e) -> bool:
        # the kernels' own rows (device_type CUDA): the operators' rows would
        # count the same device time again, and so would the ranges of user
        # annotations on the device's timeline (Optimizer.step#AdamW.step)
        return (e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer."))

    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages() if kernel(e)),
                  reverse=True)
    if not rows or rows[0][0] <= 0:
        print("profiler: no device time recorded (not measured)")
        return None
    # busy: the union of the kernels' intervals on the timeline, which counts
    # kernels that overlap (other streams) once
    busy, end = 0.0, -math.inf
    for t0, t1 in sorted((e.time_range.start, e.time_range.end) for e in prof.events() if kernel(e)):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    busy /= 1e3
    summed = sum(r[0] for r in rows)
    print(f"profiler: {sum(r[1] for r in rows)} kernel launches, {summed:.2f} ms of kernel time covering "
          f"{busy:.2f} ms of the timeline = device busy {100 * busy / wall_ms:.1f}% of the {what}'s {wall_ms:.2f} ms; "
          "top kernels:")
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.3f} ms {count:5d}×  {key[:90]}")
    return busy / wall_ms


def card_vs_cpu(tc, ses: dict) -> None:
    from openvoice_tpu_torch import ToneColorConverter

    phase("6. card against CPU (same port, same weights; 2 s clip, watermark off)")
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

    # serving mode: the card runs the kernels, the CPU their plain versions
    t0 = time.perf_counter()
    fast_cpu = cpu.convert(src, ses["se_src"], ses["se_tgt"], tau=0.3, seed=SEED, message="", fast=True)
    cpu_s = time.perf_counter() - t0
    fast_card = tc.convert(src, ses["se_src"], ses["se_tgt"], tau=0.3, seed=SEED, message="", fast=True)
    diff, peak = float(np.abs(fast_card - fast_cpu).max()), float(np.abs(fast_cpu).max())
    print(f"serving mode: audio max |cuda - cpu| = {diff:.3e} = {diff / peak:.4f} of the peak {peak:.5f} "
          f"(bar {FAST_CPU_TOL}); against f32 on the CPU {float(np.abs(fast_cpu - on_cpu).max()):.3e}; "
          f"CPU convert {cpu_s:.2f} s")
    check(fast_card.shape == fast_cpu.shape and bool(np.isfinite(fast_card).all())
          and diff <= FAST_CPU_TOL * peak, "card and CPU disagree on the serving mode's audio")


# -- the V1 path: base-speaker TTS, then the V1 converter ------------------------

# four sentences of one length and shape, so that their frame counts fall
# into a shared bucket and tts_batched decodes a group of B >= 2
V1_TEXT = ("The morning train left the station early and carried us along the quiet river. "
           "By noon the sun stood high above the fields and the air was warm and still. "
           "We walked down to the water and watched the boats drift slowly past the mill. "
           "In the evening the lights came on across the valley and the town grew quiet.")
SHORT_TEXT = "Hello there, this is a short test of the voice."


def capture_kernel_calls(fn, with_front: bool = False) -> list:
    """Run `fn` once with the entry points of K2, K3 and K4 (with_front: also
    K5 as the batcher looks it up, and K1), as the graph looks them up,
    wrapped to record their arguments."""
    from openvoice_tpu_torch.models import synthesizer as TS
    from openvoice_tpu_torch.nn import hifigan, wavenet
    from openvoice_tpu_torch.serve import batcher

    targets = [(TS, "coupling_block"), (hifigan, "mrf_stage"), (hifigan, "tail_stage")]
    if with_front:
        targets = [(batcher, "stft_magnitude"), (wavenet, "wn_stack")] + targets
    calls, saved = [], []
    for module, name in targets:
        real = getattr(module, name)
        saved.append((module, name, real))

        def wrapped(*args, _real=real, _name=name):
            calls.append((_name, args))
            return _real(*args)

        setattr(module, name, wrapped)
    try:
        fn()
    finally:
        for module, name, real in saved:
            setattr(module, name, real)
    return calls


def group_kernel_checks(calls: list, smi: str) -> dict:
    """Each captured launch of the B >= 2 group against its plain version
    (the existing bars; rows past each length exactly 0; K5 at its absolute
    bar), then timed cold at the group's shape and on its first row alone at
    the same bucket."""
    import torch

    from openvoice_tpu_torch.audio.stft import stft_magnitude_plain
    from openvoice_tpu_torch.ops import coupling_cuda, mrf_cuda, stft_cuda, tail_cuda, wn_cuda

    kernels = {"stft_magnitude": (stft_cuda.stft_magnitude, stft_magnitude_plain, None),
               "wn_stack": (wn_cuda.wn_stack, wn_cuda.wn_stack_plain, WN_MEAN_TOL),
               "coupling_block": (coupling_cuda.coupling_block, coupling_cuda.coupling_block_plain, WN_MEAN_TOL),
               "mrf_stage": (mrf_cuda.mrf_stage, mrf_cuda.mrf_stage_plain, MRF_MEAN_TOL),
               "tail_stage": (tail_cuda.tail_stage, tail_cuda.tail_stage_plain, MRF_MEAN_TOL)}
    times: dict = {}
    for name, args in calls:
        fn, plain, mean_tol = kernels[name]
        x = args[0]
        if name == "stft_magnitude":
            one = (x[:1].contiguous(),) + args[1:]
            lens = []
            label = f"{name} B={x.shape[0]} L={x.shape[1]} n_fft={args[1]}"
            for lab, a in ((label, args), ("  its first row alone (B=1)", one)):
                out, ref = fn(*a), plain(*a)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                print(f"{lab}: out {tuple(out.shape)}  max|kernel - plain| {err:.3e} (bar {STFT_TOL})")
                check(out.shape == ref.shape and err <= STFT_TOL, f"{lab}: kernel disagrees with its plain version")
        else:
            lens = args[1].tolist()
            last = name == "tail_stage" and args[2]["post_w"] is not None
            label = f"{name} B={x.shape[0]} T={x.shape[1]} C={x.shape[2]} lengths {lens}"
            agree(label, fn(*args), plain(*args), mean_tol, lens, zero_after=3 if last else 0)
            one = tuple(a[:1].contiguous() if i in (0, 1, 3) else a for i, a in enumerate(args))
            agree("  its first row alone (B=1)", fn(*one), plain(*one), mean_tol, lens[:1],
                  zero_after=3 if last else 0)
        # the first row's result must not depend on its batchmates
        in_group, alone = fn(*args)[:1].float(), fn(*one).float()
        mates = float((in_group - alone).abs().max())
        bar = STFT_TOL if name == "stft_magnitude" else KERNEL_MAX_TOL * float(alone.abs().max())
        print(f"  its first row in the group against alone: max diff {mates:.3e} (bar {bar:.3e}"
              f"{', bit-equal' if mates == 0 else ''})")
        check(mates <= bar, f"{label}: a row's result depends on its batchmates")
        group_ms, row_ms = time_ms(lambda: fn(*args), 10), time_ms(lambda: fn(*one), 10)
        print(f"  {label}: {group_ms:.4f} ms cold at B={x.shape[0]}, {row_ms:.4f} ms for its first row alone "
              f"(B=1, same bucket)  [{smi}]")
        times.setdefault(name, []).append({"batch": x.shape[0], "t": x.shape[1], "lengths": lens,
                                           "group_ms": group_ms, "row_ms": row_ms, "batchmates_max_diff": mates})
    return times


def coupling_batch_times(args: tuple, smi: str) -> dict:
    """K2 (reverse, the TTS decode's packed weights and conditioning) cold
    at B = 1, 2 and 4 and buckets 256 and 1024, every frame live: how its
    clusters (B·T/64 of them, 30 fit on the card at once) fill waves."""
    import torch

    from openvoice_tpu_torch.ops import coupling_cuda

    _, _, packed, g_all = args
    gen = torch.Generator().manual_seed(SEED + 8)
    out = {}
    for t in (256, 1024):
        for b in (1, 2, 4):
            x = rand_bf16(gen, b, t, packed["wp"].shape[1])
            lens = lens_on_card([t] * b)
            g = g_all[:1].expand(b, *g_all.shape[1:]).contiguous()
            out[f"B={b} T={t}"] = time_ms(lambda: coupling_cuda.coupling_block(x, lens, packed, g), 10)
    print(f"K2 reverse, every frame live, cold ms [{smi}]: "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def tts_stage_times(model, enc, fb: int, noise, fast: bool, cache) -> dict:
    """Device ms (CUDA events, median of 5, cold L2) of the TTS decode's two
    stages: length regulation + reverse flow, and the decoder."""
    import torch

    from openvoice_tpu_torch.models import synthesizer as TS
    from openvoice_tpu_torch.nn.hifigan import apply_generator

    with torch.inference_mode():
        z, y_mask, _, g = TS.tts_latents(model, enc, fb, noise, 0.667, fast, cache)
        flow_ms = time_ms(lambda: TS.tts_latents(model, enc, fb, noise, 0.667, fast, cache), 5)
        if fast:
            m = y_mask.to(z.dtype)
            dec_ms = time_ms(lambda: apply_generator(model.dec, z * m, g=g, x_mask=m, packed=cache), 5)
        else:
            mask, g_t = y_mask.transpose(1, 2), g.transpose(1, 2)
            dec_ms = time_ms(lambda: model.dec(z.transpose(1, 2) * mask, g=g_t, x_mask=mask), 5)
    return {"flow": flow_ms, "dec": dec_ms}


def tts_graph_checks(tts, speaker: int, per_decode: dict, audio_s: float, smi: str) -> dict:
    """Phase 6b's graphs: `tts` and `tts_batched` in both modes.  After a
    first call (which captured), the repeat captures nothing and replays one
    encode and one decode graph a token / frame bucket group (a sentence for
    `tts`), with the launches of the eager call; the replay is bit-equal to
    the call with the graphs off, and so is a call with another speaker (g),
    seed (noise) and speed (length_scale).  Then the warm walls, eager
    against graph (median of 5 a block: eager, graph, graph, eager), and the
    device's busy share of each."""
    import torch

    from openvoice_tpu_torch.api import _encode_rows, _sentence_noise_rngs, frame_groups
    from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket

    out = {}
    for fast in (False, True):
        for name in ("tts", "tts_batched"):
            label = f"{name} {'fast' if fast else 'f32'}"
            fn = getattr(tts, name)
            first = fn(V1_TEXT, None, speaker, fast=fast, seed=SEED)  # captures what the calls above did not
            before = graph_state(tts.graphs)
            torch.cuda.synchronize()
            zero_launch_counts()
            got = fn(V1_TEXT, None, speaker, fast=fast, seed=SEED)
            torch.cuda.synchronize()
            launches = launch_counts()
            tokens, _ = tts._sentence_tokens(V1_TEXT, speaker, "English")
            with torch.inference_mode():
                rows = _encode_rows(tts.model, tokens, speaker, 1.0, _sentence_noise_rngs(SEED, len(tokens)),
                                    tts.device)
            decodes = len(tokens) if name == "tts" else len(frame_groups(rows))
            encodes = len(tokens) if name == "tts" else len({round_up_to_bucket(len(t)) for t in tokens})
            expect_replay(f"{label}, repeat", tts.graphs, before, encodes + decodes)
            want = {k: v * decodes if fast else 0 for k, v in per_decode.items()}
            print(f"{label} replay: {encodes} encode and {decodes} decode graphs, kernel launches {launches}")
            check(launches == want, f"{label}: a replay must count {want}, not {launches}")
            same_bits(f"{label} replay against its first call", got, first)
            with eager(tts):
                same_bits(f"{label} replay against the graphs off", got, fn(V1_TEXT, None, speaker, fast=fast,
                                                                               seed=SEED))
            other = dict(fast=fast, seed=SEED + 3, speed=1.1)
            got = fn(V1_TEXT, None, speaker + 2, **other)
            with eager(tts):
                want_audio = fn(V1_TEXT, None, speaker + 2, **other)
            same_bits(f"{label} with another speaker, seed and speed against the graphs off", got, want_audio)
            blocks = ab_walls(lambda: fn(V1_TEXT, None, speaker, fast=fast, seed=SEED), tts)
            walls = {v: statistics.median(ms for w, ms in blocks if w == v) for v in ("eager", "graph")}
            with eager(tts):
                busy_eager = device_profile(lambda: fn(V1_TEXT, None, speaker, fast=fast, seed=SEED),
                                            walls["eager"], f"{label}, eager")
            busy_graph = device_profile(lambda: fn(V1_TEXT, None, speaker, fast=fast, seed=SEED),
                                        walls["graph"], f"{label}, graph replay")
            print(f"{label} warm walls ({audio_s:.2f} s of audio; ms, median of 5 a block, host clock): "
                  + ", ".join(f"{v} {ms:.2f}" for v, ms in blocks) + f"  [{smi}]")
            out[label] = {"walls_ms": walls, "blocks_ms": blocks, "busy": {"eager": busy_eager, "graph": busy_graph}}
    state = graph_state(tts.graphs)
    print(f"TTS graphs held {state['graphs']}, {state['capture_s']:.3f} s of capture, device pool "
          f"{state['pool_bytes'] / 1e6:.1f} MB  [{smi}]")
    return {**out, "graphs": state}


def v1_tts(smi: str) -> dict:
    """The base-speaker TTS half of the V1 phase; returns its numbers and the
    f32 audio (the V1 converter's source)."""
    import torch

    from openvoice_tpu_torch import BaseSpeakerTTS, v1_base_tts_config
    from openvoice_tpu_torch.api import _encode_rows, _sentence_noise_rngs, _stack_enc_rows, frame_groups
    from openvoice_tpu_torch.text import default_symbols

    phase("6b. V1 path: BaseSpeakerTTS.tts / tts_batched, full width (hidden 192, 6 attention layers, "
          "10 speakers, 512-channel decoder)")
    tts = BaseSpeakerTTS(cfg=v1_base_tts_config(n_vocab=len(default_symbols), n_speakers=10))
    check(tts.device.type == "cuda", f"the TTS landed on {tts.device}")
    tts.init_random(SEED + 4)
    seed_flow_posts(tts.model, SEED + 5)
    model, cfg, speaker = tts.model, tts.cfg, 3
    token_seqs, _ = tts._sentence_tokens(V1_TEXT, speaker, "English")
    check(len(token_seqs) == 4, f"the text split into {len(token_seqs)} sentences, not 4")
    noise_rngs = _sentence_noise_rngs(SEED, len(token_seqs))
    with torch.inference_mode():
        rows = _encode_rows(model, token_seqs, speaker, 1.0, noise_rngs, tts.device)
    groups = frame_groups(rows)
    frames = [int(r["w_ceil"].sum()) for r in rows]
    print(f"sentences: tokens {[len(s) for s in token_seqs]}, frames {frames}; decode groups (frame bucket: "
          f"sentences) {groups}; group sizes {[len(v) for v in groups.values()]}")
    check(any(len(v) >= 2 for v in groups.values()), "no frame bucket holds two sentences: no B >= 2 decode")

    kw = dict(seed=SEED)
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    a32 = tts.tts(V1_TEXT, None, speaker, **kw)
    torch.cuda.synchronize()
    f32_s, launches = time.perf_counter() - t0, launch_counts()
    print(f"first tts (f32): {f32_s:.3f} s, {len(a32) / SR:.2f} s of audio; kernel launches {launches}")
    check(not any(launches.values()), "the f32 TTS launched a kernel")
    n_sent, n_groups = len(token_seqs), len(groups)
    per_decode = {"stft_magnitude": 0, "wn_stack": 0, "coupling_block": 1, "mrf_stage": 2, "tail_stage": 2}
    zero_launch_counts()
    fast = tts.tts(V1_TEXT, None, speaker, fast=True, **kw)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"tts(fast=True), {n_sent} decodes: kernel launches {launches}")
    check(launches == {k: v * n_sent for k, v in per_decode.items()},
          "each serving TTS decode must launch K2 1, K3 2, K4 2")
    zero_launch_counts()
    batched = tts.tts_batched(V1_TEXT, None, speaker, fast=True, **kw)
    torch.cuda.synchronize()
    launches_b = launch_counts()
    print(f"tts_batched(fast=True), {n_groups} decode groups: kernel launches {launches_b}")
    check(launches_b == {k: v * n_groups for k, v in per_decode.items()},
          "each serving decode group must launch K2 1, K3 2, K4 2")
    for label, out in (("tts f32", a32), ("tts fast", fast), ("tts_batched fast", batched)):
        check(out.shape == a32.shape and bool(np.isfinite(out).all()) and float(np.abs(out).max()) <= 1.0,
              f"{label}: shape {out.shape} or values out of range")
    peak = float(np.abs(a32).max())
    d_fast, d_bat = float(np.abs(fast - a32).max()), float(np.abs(batched - fast).max())
    print(f"audio peak {peak:.5f}; max |fast - f32| {d_fast:.3e} = {d_fast / peak:.4f} of the peak; "
          f"max |batched fast - fast| {d_bat:.3e} = {d_bat / peak:.4f} (bars {FAST_VS_F32_TOL})")
    check(d_fast <= FAST_VS_F32_TOL * peak, "the serving TTS strays from the f32 TTS")
    check(d_bat <= FAST_VS_F32_TOL * peak, "tts_batched(fast) disagrees with tts(fast)")
    walls = tts_graph_checks(tts, speaker, per_decode, len(a32) / SR, smi)

    # the B >= 2 group: its kernels against their plain versions, and times
    fb, idxs = next((fb, v) for fb, v in groups.items() if len(v) >= 2)
    g_row = model.emb_g.weight[speaker][None, :]
    cache = tts._require_dec_cache()
    with torch.inference_mode():
        enc = _stack_enc_rows(rows, idxs, g_row)
        noise = torch.randn(len(idxs), fb, cfg.inter_channels, generator=torch.Generator().manual_seed(SEED)).cuda()
        from openvoice_tpu_torch.models import synthesizer as TS

        calls = capture_kernel_calls(lambda: TS.tts_decode(model, enc, fb, noise, fast=True, dec_cache=cache))
        print(f"group of {len(idxs)} at bucket {fb}: {len(calls)} kernel launches captured")
        group_times = group_kernel_checks(calls, smi)
        k2_batches = coupling_batch_times(next(args for name, args in calls if name == "coupling_block"), smi)
        one = _stack_enc_rows(rows, idxs[:1], g_row)
        stages = {f"{mode} {label}": tts_stage_times(model, e, fb, nz, mode == "fast",
                                                     cache if mode == "fast" else None)
                  for mode in ("f32", "fast") for label, e, nz in (("B=1", one, noise[:1]),
                                                                  (f"B={len(idxs)}", enc, noise))}
    print(f"TTS decode stage times at bucket {fb} (ms, CUDA events, median of 5, cold L2) [{smi}]: "
          + "; ".join(f"{k}: flow {v['flow']:.3f}, dec {v['dec']:.3f}" for k, v in stages.items()))

    # card against CPU on one short sentence, both modes
    cpu = BaseSpeakerTTS(cfg=cfg, device="cpu")
    cpu.set_model(copy.deepcopy(model))
    short_tokens, _ = tts._sentence_tokens(SHORT_TEXT, speaker, "English")
    check(len(short_tokens) == 1, "the short text is not one sentence")
    with torch.inference_mode():
        encs = [_encode_rows(m, short_tokens, speaker, 1.0, _sentence_noise_rngs(SEED, 1), m.emb_g.weight.device)[0]
                for m in (model, cpu.model)]
    d_m = float((encs[0]["m_p"].cpu() - encs[1]["m_p"]).abs().max())
    w_card, w_cpu = encs[0]["w_ceil"].cpu(), encs[1]["w_ceil"]
    print(f"short sentence encode: max |m_p cuda - cpu| {d_m:.3e}; ceilings equal: {bool(torch.equal(w_card, w_cpu))} "
          f"({int(w_card.sum())} frames)")
    check(bool(torch.equal(w_card, w_cpu)), "a duration ceiling flipped between card and CPU")
    for mode in (False, True):
        t0 = time.perf_counter()
        on_cpu = cpu.tts(SHORT_TEXT, None, speaker, fast=mode, **kw)
        cpu_s = time.perf_counter() - t0
        on_card = tts.tts(SHORT_TEXT, None, speaker, fast=mode, **kw)
        diff, peak = float(np.abs(on_card - on_cpu).max()), float(np.abs(on_cpu).max())
        name = "serving" if mode else "f32"
        bar = FAST_CPU_TOL * peak if mode else min(CPU_AUDIO_TOL, 1e-3 * peak)
        print(f"short sentence, {name}: max |cuda - cpu| {diff:.3e} = {diff / peak:.2e} of the peak {peak:.5f} "
              f"(bar {bar:.3e}); CPU tts {cpu_s:.2f} s")
        check(on_card.shape == on_cpu.shape and diff <= bar, f"card and CPU disagree on the {name} TTS audio")
    return {"tts": tts, "audio": a32, "groups": [len(v) for v in groups.values()], "bucket": fb,
            "launches_per_decode": per_decode, "group_times": group_times, "stages": stages, "walls_ms": walls,
            "k2_batches": k2_batches}


def v1_convert(tts_audio: np.ndarray, tmp: str, smi: str) -> dict:
    """The converter half of the V1 phase: get_se (and its cache) on the TTS
    audio and a synthetic target, then convert in both modes."""
    import torch

    from openvoice_tpu_torch import V1_CONVERTER_CONFIG, ToneColorConverter, get_se
    from openvoice_tpu_torch.api import _spec_from_audio
    from openvoice_tpu_torch.audio.io import write_wav

    print("\n-- V1 converter (zero_g=False): get_se → convert")
    conv = ToneColorConverter(cfg=V1_CONVERTER_CONFIG)
    check(conv.device.type == "cuda" and conv.version == "v1", f"V1 converter on {conv.device}, {conv.version}")
    conv.init_random(SEED + 6)
    seed_flow_posts(conv.model, SEED + 7)
    src_path, tgt_path = os.path.join(tmp, "tts_base.wav"), os.path.join(tmp, "target.wav")
    write_wav(src_path, tts_audio, SR)
    write_wav(tgt_path, voice(6.0, 210.0, seed=13), SR)
    target_dir = os.path.join(tmp, "processed")
    se_src, name = get_se(src_path, conv, target_dir=target_dir)
    se_tgt, _ = get_se(tgt_path, conv, target_dir=target_dir)
    check("_v1_" in name and os.path.isfile(os.path.join(target_dir, name, "se.npy")), f"no SE cache for {name}")
    zero_launch_counts()
    again, _ = get_se(src_path, conv, target_dir=target_dir)
    check(launch_counts()["stft_magnitude"] == 0 and np.array_equal(again, se_src), "get_se did not read its cache")
    print(f"get_se: {name}, se {se_src.shape}, read back from its cache without a launch")
    src = np.asarray(tts_audio, np.float32)
    n_frames = _spec_from_audio(src, conv.cfg)[1]

    torch.cuda.synchronize()
    zero_launch_counts()
    out32 = conv.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message=MESSAGE)
    torch.cuda.synchronize()
    l32 = launch_counts()
    check(l32 == {"stft_magnitude": 1, "wn_stack": 0, "coupling_block": 0, "mrf_stage": 0, "tail_stage": 0},
          f"the V1 f32 convert launched {l32}")
    zero_launch_counts()
    outf = conv.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message=MESSAGE, fast=True)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"V1 convert of {len(src) / SR:.2f} s ({n_frames} frames): launches f32 {l32}, serving {launches}")
    check(launches == {"stft_magnitude": 1, "wn_stack": 1, "coupling_block": 2, "mrf_stage": 2, "tail_stage": 2},
          "one V1 serving convert must launch K5 1, K1 1, K2 2, K3 2, K4 2")
    check_audio(conv, out32, n_frames)
    check_audio(conv, outf, n_frames)
    fast = conv.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message="", fast=True)
    f32 = conv.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message="")
    diff, peak = float(np.abs(fast - f32).max()), float(np.abs(f32).max())
    print(f"V1 serving against f32: max |fast - f32| {diff:.3e} = {diff / peak:.4f} of the peak {peak:.5f} "
          f"(bar {FAST_VS_F32_TOL})")
    check(diff <= FAST_VS_F32_TOL * peak, "the V1 serving convert strays from the f32 one")
    walls = {}
    for mode in (False, True):
        def one(mode=mode):
            return conv.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message=MESSAGE, fast=mode)

        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            one()
            times.append(time.perf_counter() - t0)
        walls["fast" if mode else "f32"] = statistics.median(times) * 1e3
        print(f"V1 convert {'serving' if mode else 'f32'}: {walls['fast' if mode else 'f32']:.2f} ms warm "
              f"(median of 5)  [{smi}]")
        device_profile(one, walls["fast" if mode else "f32"])
    return {"conv": conv, "ses": {"se_src": se_src, "se_tgt": se_tgt}, "launches": launches, "walls_ms": walls}


# -- phase 8: the serving tier ----------------------------------------------------

N_SERVE = 32          # requests of the batcher's stream
SERVE_BATCH = 8       # its max_batch
WIRE_LSB = 1.0 / 32767.0  # one step of the batcher's int16 wire
# the batcher's group at B = 8, its kernels held and timed against B = 1: six
# clips at a fine bucket (832 frames) and two padded rows of length 0
GROUP_FRAMES = [830, 790, 761, 700, 655, 641, 0, 0]
GROUP_BUCKET = 832
APP_TEXT = "Hello there, this is a short test of the voice. The weather is fine today."


def louder(conv) -> None:
    """Scale a converter's conv_post ×100, in place, and drop its packed
    serving weights: the random decoder's audio peaks near 2e-4, where one
    step of the batcher's int16 wire (3.05e-5) is an eighth of the peak and
    a comparison across the wire would say little.  At ×100 the audio stays
    well inside tanh's linear range."""
    import torch

    with torch.no_grad():
        conv.model.dec.conv_post.weight.mul_(100.0)
    conv.set_model(conv.model)


def serve_clip(seconds: float, f0: float, seed: int) -> np.ndarray:
    """A `voice` clip on the int16 grid: what the PCM mode uploads is then the
    clip itself, and `convert` of it is the batcher's reference."""
    return (np.round(np.clip(voice(seconds, f0, seed), -1.0, 1.0) * 32767.0) / 32767.0).astype(np.float32)


def serve_stream_fields(tc, ses: dict) -> tuple[list[dict], list[np.ndarray]]:
    """32 requests of 2-12 s: even ones in PCM mode at tau 0, odd ones in
    spec mode at tau 0.3 (their spectrograms from the STFT kernel, as
    `convert` computes them, before the counters are zeroed).  Per mode, 8
    clips spread over 2-12 s and 8 that share one fine bucket (PCM 3.0-3.6 s,
    bucket 320; spec 7.5-8.7 s, bucket 768): the planner makes a group of 8
    only of requests that share a bucket."""
    import torch

    from openvoice_tpu_torch.api import _spec_from_audio
    from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude

    cfg = tc.cfg
    rng = np.random.default_rng(SEED + 20)
    half = N_SERVE // 2
    pcm_s = np.concatenate([np.linspace(2.0, 12.0, half // 2), 3.0 + 0.6 * rng.random(half - half // 2)])
    spec_s = np.concatenate([np.linspace(2.0, 12.0, half // 2), 7.5 + 1.2 * rng.random(half - half // 2)])
    seconds = np.stack([rng.permutation(pcm_s), rng.permutation(spec_s)], axis=1).reshape(-1)
    base = dict(g_src=ses["se_src"].reshape(-1), g_tgt=ses["se_tgt"].reshape(-1))
    fields, clips = [], []
    for i, s in enumerate(seconds):
        clip = serve_clip(float(s), 100.0 + 7 * i, seed=100 + i)
        clips.append(clip)
        if i % 2 == 0:
            fields.append(dict(base, audio=clip, tau=0.0, seed=SEED + i))
            continue
        padded, n = _spec_from_audio(clip, cfg)
        spec = stft_magnitude(torch.from_numpy(padded)[None].to(tc.device), cfg.filter_length, cfg.hop_length,
                              cfg.win_length)[0, :n].cpu().numpy()
        fields.append(dict(base, spec=spec, n_frames=n, tau=0.3, seed=SEED + i))
    return fields, clips


def serving_batcher(tc, max_batch: int, mesh=None):
    """A started serving-mode batcher on `tc`'s model (over `mesh` where
    given)."""
    from openvoice_tpu_torch.serve import batcher as B

    batcher = B.ConvertBatcher(tc.model, tc.cfg, max_batch=max_batch, max_wait_ms=5.0, fast=True,
                               device=None if mesh else tc.device, mesh=mesh)
    batcher.start()
    return batcher


def run_stream(tc, fields: list[dict], max_batch: int, capture: bool = False, mesh=None, batcher=None) -> dict:
    """Submit `fields` together to a serving-mode batcher on `tc`'s model
    (`batcher`, which stays running and keeps its graphs, or a new one over
    `mesh` where given, stopped after the run); wait for every result.
    Returns the results, the wall time from the first submit to the last
    result, the run's own metrics snapshot, and the groups it dispatched
    (mode, bucket, rows, padded batch); with `capture`, each group's int16
    wire too (its host copy, every data position's rows)."""
    import torch

    from openvoice_tpu_torch.runtime.profiler import Metrics
    from openvoice_tpu_torch.serve import batcher as B

    own = batcher is None
    batcher = batcher or serving_batcher(tc, max_batch, mesh)
    groups, wires, metrics = [], [], Metrics()
    real_dispatch, real_metrics, real_put = B.ConvertBatcher._dispatch, B.METRICS, batcher._readq.put

    def dispatch(bucket, group, padded_batch):
        groups.append(("pcm" if group[0].audio is not None else "spec", bucket, len(group), padded_batch))
        return real_dispatch(batcher, bucket, group, padded_batch)

    def put(item, *args, **kwargs):
        if item is not None:
            wires.append(item[0])  # a group's host copy (every shard's rows), complete once its events are
        return real_put(item, *args, **kwargs)

    batcher._dispatch = dispatch
    B.METRICS = metrics
    if capture:
        batcher._readq.put = put
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futures = [batcher.submit(B.ConvertRequest(**f)) for f in fields]
        outs = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t0
    finally:
        if own:
            batcher.stop()
        B.METRICS = real_metrics
        batcher.__dict__.pop("_dispatch")
        batcher._readq.__dict__.pop("put", None)
    return {"outs": outs, "wall_s": wall, "metrics": metrics.snapshot(), "groups": groups, "wires": wires}


def serve_bar(ref: np.ndarray) -> float:
    """Serving against serving across the int16 wire: the serving bar of the
    reference's peak, plus the wire's one step (the reference is not
    rounded)."""
    return FAST_VS_F32_TOL * float(np.abs(ref).max()) + WIRE_LSB


def batcher_stream_checks(tc, ses: dict, fields: list[dict], clips: list, b8, b1, smi: str) -> dict:
    """8a's stream on two running batchers (max_batch 8 and 1), which keep
    their graphs from run to run: launches per group, padded rows, each
    result against `convert(fast=True)`, batchmates, a group's replay against
    the same group eager, and the stream's walls eager and as replays."""
    import torch

    audio_s = sum(len(c) for c in clips) / SR
    run_stream(tc, fields[:4], SERVE_BATCH, batcher=b8)  # warm-up: the serving cache, cuDNN's first calls
    torch.cuda.synchronize()
    before_run = graph_state(b8.graphs)
    zero_launch_counts()
    run = run_stream(tc, fields, SERVE_BATCH, capture=True, batcher=b8)
    torch.cuda.synchronize()
    launches = launch_counts()
    after = graph_state(b8.graphs)
    groups = run["groups"]
    n_groups, n_pcm = len(groups), sum(g[0] == "pcm" for g in groups)
    print(f"groups dispatched (mode, bucket, rows, padded batch): {groups}")
    print(f"kernel launches over {n_groups} groups ({n_pcm} PCM): {launches}; graphs captured in the stream "
          f"{after['captures'] - before_run['captures']} (eager first calls), replayed "
          f"{after['replays'] - before_run['replays']}")
    check(n_pcm > 0 and all(n > 0 for n in launches.values()), "the batcher's stream left a kernel unlaunched")
    # launches per dispatched group as counted in this run (K5: per PCM group)
    per_group = {k: v / (n_pcm if k == "stft_magnitude" else n_groups) for k, v in launches.items()}
    check(per_group == {"stft_magnitude": 1, "wn_stack": 1, "coupling_block": 2, "mrf_stage": 2, "tail_stage": 2},
          f"each batcher group must launch K5 1 (PCM groups only), K1 1, K2 2, K3 2, K4 2, not {per_group}")
    print(f"launches per group (K5 per PCM group): {per_group}")
    # the planner pads a group only where a padded row (a bucket's frames)
    # costs less than another dispatch (96 frames), which at these buckets
    # is rare: any padded row must come out exactly 0; the B = 8 group below
    # always holds two
    padded_rows = sum(p - n for _, _, n, p in groups)
    check(max(p for _, _, _, p in groups) == SERVE_BATCH, "no group of 8 formed")
    check(len(run["wires"]) == n_groups, f"{len(run['wires'])} host copies for {n_groups} groups")
    for (_, _, n, p), wire in zip(groups, run["wires"]):
        check(wire.shape[0] == p and bool((wire[n:] == 0).all()), "a padded row of length 0 is not exactly 0")
    print(f"group sizes {sorted(n for _, _, n, _ in groups)}; {padded_rows} padded rows of length 0 "
          f"(each exactly 0)")

    # each result against convert(fast=True) of the same clip, seed and tau
    worst = {"pcm": 0.0, "spec": 0.0}
    for f, clip, out in zip(fields, clips, run["outs"]):
        ref = tc.convert(clip, ses["se_src"], ses["se_tgt"], tau=f["tau"], seed=f["seed"], message="", fast=True)
        mode = "pcm" if "audio" in f else "spec"
        diff = float(np.abs(out - ref).max())
        check(out.shape == ref.shape and diff <= serve_bar(ref), f"a {mode} request strays from its convert")
        worst[mode] = max(worst[mode], diff / float(np.abs(ref).max()))
    print(f"every request against convert(fast=True) of its clip: max |batched - convert| over the peak: "
          f"PCM (tau 0) {worst['pcm']:.4f}, spec (tau 0.3) {worst['spec']:.4f} (bar {FAST_VS_F32_TOL} of the "
          f"peak + one int16 step)")

    # one clip alone, then in a full group of 8 of its length
    alone = run_stream(tc, fields[1:2], SERVE_BATCH, batcher=b8)
    eight_fields = [dict(fields[1], seed=SEED + 50 + k) if k else fields[1] for k in range(8)]
    eight = run_stream(tc, eight_fields, SERVE_BATCH, batcher=b8)
    check([g[2] for g in eight["groups"]] == [8] and [g[2] for g in alone["groups"]] == [1],
          f"groups {alone['groups']} / {eight['groups']}: not 1 and 8")
    d_mates = float(np.abs(alone["outs"][0] - eight["outs"][0]).max())
    peak = float(np.abs(alone["outs"][0]).max())
    print(f"one clip alone (B=1) against the same clip in a group of 8: max diff {d_mates:.3e} = "
          f"{d_mates / peak:.4f} of the peak {peak:.5f} ({d_mates / WIRE_LSB:.1f} int16 steps)")
    check(d_mates <= serve_bar(alone["outs"][0]), "a result depends on its batchmates beyond the serving bar")

    # the group of 8 again replays its graph, bit-equal to the group eager;
    # another 8 of the shape (PCM clips of its bucket, other seeds, taus and
    # embeddings) replays the PCM group's graph and gives the eager result
    for label, fs in (("spec group of 8, repeat", eight_fields),
                      ("PCM group of 8 with other tau, g, lengths and noise",  # 3.16-3.30 s: bucket 320
                       [dict(audio=serve_clip(3.3 - 0.02 * k, 130.0 + 5 * k, seed=300 + k), g_src=fields[0]["g_tgt"],
                             g_tgt=fields[0]["g_src"], tau=0.2 + 0.05 * k, seed=SEED + 70 + k) for k in range(8)])):
        run_stream(tc, fs, SERVE_BATCH, batcher=b8)  # captures the shape where it is new
        before = graph_state(b8.graphs)
        got = run_stream(tc, fs, SERVE_BATCH, batcher=b8)
        check([g[2] for g in got["groups"]] == [8], f"{label}: groups {got['groups']}")
        expect_replay(label, b8.graphs, before, 1)
        with eager(b8):
            want = run_stream(tc, fs, SERVE_BATCH, batcher=b8)
        same_bits(f"{label}: replay against the group eager", np.concatenate(got["outs"]),
                  np.concatenate(want["outs"]))

    # walls, every graph of the stream captured before: max_batch 8 as
    # replays and eager, and max_batch 1 as replays, in the order 8, 8 eager,
    # 1, 1, 8 eager, 8 (the checked run above paid its captures)
    run_stream(tc, fields, 1, batcher=b1)  # captures max_batch 1's shapes
    rates: dict = {SERVE_BATCH: [], 1: [], "eager": []}
    for label, mb in ((SERVE_BATCH, b8), ("eager", b8), (1, b1), (1, b1), ("eager", b8), (SERVE_BATCH, b8)):
        with eager(mb) if label == "eager" else contextlib.nullcontext():
            before = graph_state(mb.graphs)
            r = run_stream(tc, fields, mb.max_batch, batcher=mb)
            state = graph_state(mb.graphs)
        lat = r["metrics"]["latency"]["request_latency"]
        # busy_seconds: the dispatch thread's time inside its calls (host
        # packing, uploads and launches; the device runs behind it)
        dispatch_s = r["metrics"]["counters"]["busy_seconds"]
        rates[label].append({"audio_s_per_s": audio_s / r["wall_s"], "wall_s": r["wall_s"],
                             "groups": len(r["groups"]), "p50_ms": lat["p50_ms"], "p95_ms": lat["p95_ms"],
                             "dispatch_s": dispatch_s, "dispatch_share": dispatch_s / r["wall_s"],
                             "captures": state["captures"] - before["captures"]})
        print(f"max_batch {mb.max_batch}{' eager' if label == 'eager' else ''}: "
              f"{N_SERVE} requests, {audio_s:.1f} s of audio in {r['wall_s']:.3f} s = "
              f"{audio_s / r['wall_s']:.1f} audio-s/s; {len(r['groups'])} groups, the dispatch thread inside "
              f"them {dispatch_s:.3f} s ({100 * dispatch_s / r['wall_s']:.1f}% of the wall); request latency "
              f"p50 {lat['p50_ms']:.1f} ms, p95 {lat['p95_ms']:.1f} ms (METRICS); "
              f"{state['captures'] - before['captures']} graphs captured  [{smi}]")
    busy = {}
    for label in (SERVE_BATCH, "eager"):
        wall_ms = statistics.median(x["wall_s"] for x in rates[label]) * 1e3
        with eager(b8) if label == "eager" else contextlib.nullcontext():
            busy[str(label)] = device_profile(lambda: run_stream(tc, fields, SERVE_BATCH, batcher=b8), wall_ms,
                                              f"{N_SERVE}-request stream at max_batch {SERVE_BATCH}"
                                              f"{', eager' if label == 'eager' else ', graph replays'}")
    state = {"b8": graph_state(b8.graphs), "b1": graph_state(b1.graphs)}
    print(f"batcher graphs after the streams: max_batch 8 {state['b8']['graphs']}, max_batch 1 "
          f"{state['b1']['graphs']}; capture s {state['b8']['capture_s']:.3f} / {state['b1']['capture_s']:.3f}; "
          f"device pool {state['b8']['pool_bytes'] / 1e6:.1f} MB  [{smi}]")
    first = {"wall_s": run["wall_s"], "captures": after["captures"] - before_run["captures"]}
    print(f"the checked stream (its first {first['captures']} shapes captured on the way): {run['wall_s']:.3f} s")
    return {"per_group": per_group, "rates": {str(k): v for k, v in rates.items()}, "first_stream": first,
            "groups": groups,
            "worst": worst, "batchmates": d_mates / peak, "busy": busy, "graphs": state}


def batcher_phase(tc, ses: dict, smi: str) -> dict:
    """8a: the batcher's stream at max_batch 8 and 1, in serving mode."""
    import torch

    from openvoice_tpu_torch.serve import batcher as B

    phase(f"8a. serving tier: ConvertBatcher, V2 full width, serving mode, {N_SERVE} requests of 2-12 s "
          f"(half PCM at tau 0, half spec at tau 0.3), max_batch {SERVE_BATCH}")
    cfg = tc.cfg
    fields, clips = serve_stream_fields(tc, ses)
    b8, b1 = serving_batcher(tc, SERVE_BATCH), serving_batcher(tc, 1)
    try:
        numbers = batcher_stream_checks(tc, ses, fields, clips, b8, b1, smi)
    finally:
        b8.stop()
        b1.stop()

    # the kernels of one B = 8 group (two rows of length 0) against their
    # plain versions, and timed against its first row alone
    rng = np.random.default_rng(SEED + 21)
    n_rows = len(GROUP_FRAMES)
    target = (GROUP_BUCKET - 1) * cfg.hop_length + cfg.filter_length
    pcm = np.zeros((n_rows, target), np.int16)
    for i, n in enumerate(GROUP_FRAMES):
        if n:
            clip = serve_clip(n * cfg.hop_length / SR, 120.0 + 9 * i, seed=200 + i)
            pcm[i, : len(clip)] = np.round(clip * 32767.0).astype(np.int16)
    dev = tc.device
    g = torch.from_numpy(np.repeat(ses["se_src"].reshape(1, 1, -1), n_rows, 0)).to(dev)
    args = (torch.from_numpy(pcm).to(dev), torch.tensor(GROUP_FRAMES, device=dev), g, g,
            torch.full((n_rows, 1, 1), 0.3, device=dev), [SEED + i for i in range(n_rows)])
    cache = B.S.make_dec_cache(tc.model)
    with torch.inference_mode():
        calls = capture_kernel_calls(lambda: B._convert_pcm16(tc.model, cfg, *args, fast=True, dec_cache=cache),
                                     with_front=True)
        print(f"group of {n_rows} at bucket {GROUP_BUCKET}, lengths {GROUP_FRAMES}: {len(calls)} kernel launches "
              f"captured {[name for name, _ in calls]}")
        group_times = group_kernel_checks(calls, smi)
    return {**numbers, "group_times": group_times}


def same_path(label: str, out: np.ndarray, ref: np.ndarray, rel: float = 1e-3, lsb: float = 0.0) -> float:
    """Two runs of the same computation on the card (through HTTP and direct,
    or twice): within `rel` of the reference's peak (plus `lsb`)."""
    check(out.shape == ref.shape and bool(np.isfinite(out).all()), f"{label}: shape {out.shape} vs {ref.shape}")
    peak = float(np.abs(ref).max())
    diff = float(np.abs(out - ref).max())
    print(f"{label}: max diff {diff:.3e} = {diff / peak:.2e} of the peak {peak:.5f} (bar {rel} of it"
          + (f" + {lsb:.2e})" if lsb else ")"))
    check(peak > 0 and diff <= rel * peak + lsb, f"{label}: the two disagree")
    return diff / peak


def server_phase(tts, conv, ses1: dict, tmp: str, smi: str) -> None:
    """8b: the HTTP server (V1 TTS, V1 converter) and the demo app."""
    import base64
    import urllib.request

    from openvoice_tpu_torch.api import tts_convert_batched, tts_convert_single_dispatch
    from openvoice_tpu_torch.audio.io import load_audio, write_wav
    from openvoice_tpu_torch.pipeline.se_extractor import get_se
    from openvoice_tpu_torch.serve.app import VoiceApp
    from openvoice_tpu_torch.serve.server import VoiceService, serve

    phase("8b. serving tier: serve() on 127.0.0.1, port 0 (V1 TTS and V1 converter, full width), then VoiceApp "
          "(watermark off: it moves a sample by more than the int16 wire's step does)")
    conv.enable_watermark = False
    svc = VoiceService(conv, tts_model=tts, max_batch=SERVE_BATCH)
    httpd = serve(svc, port=0)
    port = httpd.server_address[1]

    def post(path: str, body: dict) -> np.ndarray:
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            resp = json.loads(r.read())
        print(f"POST {path}: {r.status}, {resp['num_samples']} samples, {time.perf_counter() - t0:.3f} s")
        check(r.status == 200 and resp["encoding"] == "f32", f"POST {path}: {r.status}")
        return np.frombuffer(base64.b64decode(resp["audio_b64"]), np.float32)

    src, tgt = ses1["se_src"], ses1["se_tgt"]
    try:
        wav = os.path.join(tmp, "serve_src.wav")
        write_wav(wav, voice(4.0, 170.0, seed=17), SR)
        audio = load_audio(wav, sr=SR)[0]
        out = post("/convert", {"audio_path": wav, "src_se": src.reshape(-1).tolist(),
                                "tgt_se": tgt.reshape(-1).tolist(), "tau": 0.0})
        same_path("/convert (the batcher's PCM mode, f32) against convert(tau=0)", out,
                  conv.convert(audio, src, tgt, tau=0.0), lsb=WIRE_LSB)
        out = post("/tts", {"text": SHORT_TEXT})
        same_path("/tts against tts_batched", out, tts.tts_batched(SHORT_TEXT, None, "default"))
        for mode, fn in (("fused", tts_convert_batched), ("single", tts_convert_single_dispatch)):
            out = post("/clone", {"text": SHORT_TEXT, "src_se": src.reshape(-1).tolist(),
                                  "tgt_se": tgt.reshape(-1).tolist(), "tau": 0.3, "seed": 5, "mode": mode})
            same_path(f"/clone {mode} against {fn.__name__}", out,
                      fn(tts, conv, SHORT_TEXT, "default", src, tgt, tau=0.3, seed=5), rel=1e-2)
    finally:
        httpd.shutdown()
        svc.close()

    target = os.path.join(tmp, "app_target.wav")
    write_wav(target, voice(5.0, 230.0, seed=19), SR)
    app = VoiceApp(conv, en_tts=tts, source_ses={"en_default": src})
    cwd = os.getcwd()
    os.chdir(tmp)  # the app caches speaker embeddings under ./processed, as the reference does
    try:
        t0 = time.perf_counter()
        result = app.predict(APP_TEXT, "default", target, agree=True)
        app_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    print(f"VoiceApp.predict: {result.info.strip()!r} in {app_s:.3f} s")
    check(result.info == "Get response successfully \n" and result.audio is not None, result.info)
    target_se, _ = get_se(target, conv, target_dir=os.path.join(tmp, "processed"))
    base = tts.tts_batched(APP_TEXT, None, "default", language="English")
    direct = conv.convert(base, src, target_se, tau=0.3, message="@MyShell")
    same_path("VoiceApp.predict against get_se → tts_batched → convert", result.audio, direct)
    conv.enable_watermark = True


def fused_phase(tts, conv, ses1: dict, smi: str) -> dict:
    """8c: the fused chains on phase 6b's four sentences."""
    import torch

    from openvoice_tpu_torch.api import (
        _encode_rows, _sentence_conv_rngs, _sentence_noise_rngs, _spec_from_audio, _stack_enc_rows, frame_groups,
        tts_convert_batched, tts_convert_single_dispatch, tts_convert_stream,
    )
    from openvoice_tpu_torch.audio.stft import reflect_frames_signal, stft_magnitude_plain
    from openvoice_tpu_torch.models import synthesizer as TS
    from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude
    from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket

    phase("8c. serving tier: the fused TTS → convert chains, V1 TTS and V1 converter (full width), "
          "phase 6b's four sentences")
    src, tgt, speaker = ses1["se_src"], ses1["se_tgt"], 3
    cfg, ccfg, dev = tts.cfg, conv.cfg, tts.device
    token_seqs, _ = tts._sentence_tokens(V1_TEXT, speaker, "English")
    with torch.inference_mode():
        rows = _encode_rows(tts.model, token_seqs, speaker, 1.0, _sentence_noise_rngs(SEED, len(token_seqs)), dev)
    groups = frame_groups(rows)
    totals = [int(r["w_ceil"].sum()) for r in rows]
    gap = int(cfg.sampling_rate * 0.05)

    def staged(fast: bool) -> np.ndarray:
        """The staged truth: tts_batched's sentences, each through the host
        reflect pad, the STFT and `voice_conversion` with the chain's noise."""
        base = tts.tts_batched(V1_TEXT, None, speaker, seed=SEED, fast=fast)
        conv_rngs = _sentence_conv_rngs(SEED, len(token_seqs))
        pieces, off = [], 0
        for i, total in enumerate(totals):
            piece = base[off: off + total * cfg.upsample_factor]
            off += len(piece) + gap
            padded, n = _spec_from_audio(piece, ccfg)
            fb = round_up_to_bucket(max(total, 1))
            spec = torch.zeros(1, fb, ccfg.spec_channels, device=dev)
            spec[0, :n] = stft_magnitude(torch.from_numpy(padded)[None].to(dev), ccfg.filter_length,
                                         ccfg.hop_length, ccfg.win_length)[0, :n]
            noise = conv_rngs[i].standard_normal((fb, ccfg.inter_channels)).astype(np.float32)
            with torch.inference_mode():
                audio, _ = TS.voice_conversion(conv.model, spec, torch.tensor([n], device=dev), conv._as_g(src),
                                               conv._as_g(tgt), 0.3, torch.from_numpy(noise)[None].to(dev),
                                               fast=fast, dec_cache=conv._require_dec_cache() if fast else None)
            pieces += [audio[0, : n * ccfg.upsample_factor, 0].cpu().numpy(), np.zeros(gap, np.float32)]
        return np.concatenate(pieces)

    kw = dict(seed=SEED, tau=0.3, message="")
    per_group_want = {"stft_magnitude": 1, "wn_stack": 1, "coupling_block": 3, "mrf_stage": 4, "tail_stage": 4}
    outs = {}
    for fast in (False, True):
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        outs[fast] = tts_convert_batched(tts, conv, V1_TEXT, speaker, src, tgt, fast=fast, **kw)
        torch.cuda.synchronize()
        wall, launches = time.perf_counter() - t0, launch_counts()
        name = "serving" if fast else "f32"
        print(f"tts_convert_batched ({name}), {len(groups)} decode groups {[len(v) for v in groups.values()]}: "
              f"{wall:.3f} s, kernel launches {launches}  [{smi}]")
        want = {k: (v if fast else int(k == "stft_magnitude")) * len(groups) for k, v in per_group_want.items()}
        check(launches == want, f"the {name} chain's launches are {launches}, not {want}")
        if fast:  # launches per decode group as counted in this run
            per_group = {k: v / len(groups) for k, v in launches.items()}
        same_path(f"tts_convert_batched ({name}) against the staged truth", outs[fast], staged(fast),
                  rel=FAST_VS_F32_TOL if fast else 1e-3)
    same_path("tts_convert_batched serving against f32", outs[True], outs[False], rel=FAST_VS_F32_TOL)

    single = tts_convert_single_dispatch(tts, conv, V1_TEXT, speaker, src, tgt, **kw)
    same_path("tts_convert_single_dispatch, run twice", tts_convert_single_dispatch(
        tts, conv, V1_TEXT, speaker, src, tgt, **kw), single)
    stats: dict = {}
    forced = tts_convert_single_dispatch(tts, conv, V1_TEXT, speaker, src, tgt, frames_per_token=0.05,
                                         stats=stats, **kw)
    check(stats == {"sentences": len(token_seqs), "overflow_sentences": len(token_seqs)}, f"overflow stats {stats}")
    same_path("its overflow fallback (every sentence past a 0.05-frame cap) against tts_convert_batched",
              forced, outs[True])
    chunks = list(tts_convert_stream(tts, conv, V1_TEXT, speaker, src, tgt, **kw))
    check(len(chunks) == len(token_seqs), f"{len(chunks)} streamed chunks")
    same_path("tts_convert_stream joined against tts_convert_single_dispatch", np.concatenate(chunks), single,
              rel=FAST_VS_F32_TOL)

    # the chain's STFT: each row's reflect-padded signal gathered on the card,
    # then K5 against its plain version on the same signal
    fb, idxs = max(groups.items(), key=lambda kv: len(kv[1]))  # the largest group: per-row reflect at B > 1
    with torch.inference_mode():
        enc = _stack_enc_rows(rows, idxs, tts.model.emb_g.weight[speaker][None, :])
        noise = torch.randn(len(idxs), fb, cfg.inter_channels, generator=torch.Generator().manual_seed(SEED)).to(dev)
        audio, y_mask = TS.tts_decode(tts.model, enc, fb, noise, fast=True, dec_cache=tts._require_dec_cache())
        y_frames = y_mask[..., 0].sum(dim=-1).to(torch.int32)
        signal = reflect_frames_signal(audio[..., 0], y_frames * cfg.upsample_factor, ccfg.filter_length,
                                       ccfg.hop_length)
        k5 = stft_magnitude(signal, ccfg.filter_length, ccfg.hop_length, ccfg.win_length)
        plain = stft_magnitude_plain(signal, ccfg.filter_length, ccfg.hop_length, ccfg.win_length)
        err = float((k5 - plain).abs().max())
        ms = time_ms(lambda: stft_magnitude(signal, ccfg.filter_length, ccfg.hop_length, ccfg.win_length))
    print(f"masked_linear_spectrogram's STFT at B={len(idxs)}, bucket {fb}, lengths {y_frames.tolist()} frames: "
          f"signal {tuple(signal.shape)}, max|K5 - plain| {err:.3e} (bar {STFT_TOL}); K5 {ms:.4f} ms cold  [{smi}]")
    check(err <= STFT_TOL, "K5 disagrees with its plain version on the fused chain's signal")
    graphs = chain_graph_checks(tts, conv, src, tgt, speaker, smi)
    return {"per_group": per_group, "groups": [len(v) for v in groups.values()], "graphs": graphs}


def chain_graph_checks(tts, conv, src, tgt, speaker: int, smi: str) -> dict:
    """8c, the graphs: every chain in both modes (its first call captured
    each shape it needed) repeated, with no new capture and the same
    launches as its eager call, bit-equal to it; tts_convert_batched again
    with another seed, tau and speed, bit-equal to eager; warm walls eager
    against graph, the busy share of tts_convert_batched both ways, and the
    chains' graphs, capture seconds and the pool."""
    import torch

    from openvoice_tpu_torch.api import tts_convert_batched, tts_convert_single_dispatch, tts_convert_stream

    graphs = tts.chain_graphs(conv)
    chains = {
        "tts_convert_batched": lambda **kw: tts_convert_batched(tts, conv, V1_TEXT, speaker, src, tgt, **kw),
        "tts_convert_single_dispatch": lambda **kw: tts_convert_single_dispatch(tts, conv, V1_TEXT, speaker, src,
                                                                                tgt, **kw),
        "tts_convert_stream": lambda **kw: np.concatenate(list(tts_convert_stream(tts, conv, V1_TEXT, speaker, src,
                                                                                   tgt, **kw))),
    }
    out: dict = {}
    for fast in (False, True):
        mode = "serving" if fast else "f32"
        for name, chain in chains.items():
            kw = dict(seed=SEED, tau=0.3, message="", fast=fast)
            chain(**kw)  # captures the shapes this call needs that no earlier call did
            torch.cuda.synchronize()
            before = graph_state(graphs)
            zero_launch_counts()
            got = chain(**kw)
            torch.cuda.synchronize()
            launches = launch_counts()
            expect_replay(f"{name} ({mode}), repeat", graphs, before)
            with eager(tts, conv):
                zero_launch_counts()
                want = chain(**kw)
                torch.cuda.synchronize()
                eager_launches = launch_counts()
            same_bits(f"{name} ({mode}): replay against the chain eager", got, want)
            print(f"{name} ({mode}): launches as replays {launches}, eager {eager_launches}")
            check(launches == eager_launches, f"{name} ({mode}): a replay counts other launches than eager")
            if name == "tts_convert_batched":
                other = dict(kw, seed=SEED + 3, tau=0.55, speed=1.15)
                chain(**other)
                before = graph_state(graphs)
                got = chain(**other)
                expect_replay(f"{name} ({mode}) with another seed, tau and speed", graphs, before)
                with eager(tts, conv):
                    want = chain(**other)
                same_bits(f"{name} ({mode}) with another seed, tau and speed: replay against eager", got, want)
            walls = ab_walls(lambda: chain(**kw), tts, conv, runs=3)
            by = {v: statistics.median(ms for k, ms in walls if k == v) for v in ("eager", "graph")}
            entry = {"walls_ms": walls, "launches": launches}
            if name == "tts_convert_batched":
                entry["busy"] = {"graph": device_profile(lambda: chain(**kw), by["graph"], f"{name} ({mode}), graph")}
                with eager(tts, conv):
                    entry["busy"]["eager"] = device_profile(lambda: chain(**kw), by["eager"],
                                                            f"{name} ({mode}), eager")
            print(f"{name} ({mode}): warm walls ms (median of 3 a block: eager, graph, graph, eager) "
                  f"{[round(ms, 2) for _, ms in walls]}  [{smi}]")
            out[f"{name}_{mode}"] = entry
    state = graph_state(graphs)
    print(f"fused chains' graphs: {state['graphs']} held, {state['captures']} captures in "
          f"{state['capture_s']:.3f} s, {state['replays']} replays; device pool {state['pool_bytes'] / 1e9:.3f} GB  "
          f"[{smi}]")
    return {**out, "state": state}


def streaming_phase(tc, ses: dict, smi: str) -> dict:
    """8d: convert_streaming of a 60 s clip against one-shot convert, both
    modes, and the peak device memory of each."""
    import torch

    phase("8d. serving tier: convert_streaming (896-frame chunks, halo 109) of a 60 s clip against one-shot "
          "convert, V2 full width")
    from openvoice_tpu_torch.runtime.graphs import pool_bytes

    src, tgt = ses["se_src"], ses["se_tgt"]
    clip60 = voice(60.0, 140.0, seed=23)
    clip45 = voice(45.0, 170.0, seed=37)
    kw = dict(tau=0.3, seed=SEED, message="")
    for fast in (False, True):
        streamed = tc.convert_streaming(clip60, src, tgt, fast=fast, **kw)
        one = tc.convert(clip60, src, tgt, fast=fast, **kw)
        name = "serving" if fast else "f32"
        same_path(f"60 s streamed against one-shot ({name})", streamed, one,
                  rel=FAST_VS_F32_TOL if fast else 1e-3)
        # f32 also at the JAX suite's golden bar
        check(fast or bool(np.all(np.abs(streamed - one) <= 2e-5 + 1e-4 * np.abs(one))),
              "f32 streaming misses atol 2e-5 / rtol 1e-4 against one-shot")
        # every window of a repeat replays the window graph, bit-equal to the
        # windows run eagerly; so does a 45 s clip with another tau, seed and
        # the embeddings swapped
        chunks = -(-(len(streamed) // tc.cfg.upsample_factor) // 896)
        before = graph_state(tc.graphs)
        again = tc.convert_streaming(clip60, src, tgt, fast=fast, **kw)
        expect_replay(f"{name} streaming, repeat ({chunks} windows)", tc.graphs, before, chunks)
        same_bits(f"{name} streaming replay against its first call", again, streamed)
        with eager(tc):
            same_bits(f"{name} streaming replay against the windows eager", again,
                      tc.convert_streaming(clip60, src, tgt, fast=fast, **kw))
        kw2 = dict(tau=0.55, seed=SEED + 11, message="", fast=fast)
        before = graph_state(tc.graphs)
        got = tc.convert_streaming(clip45, tgt, src, **kw2)
        expect_replay(f"{name} streaming of a 45 s clip", tc.graphs, before)
        with eager(tc):
            same_bits(f"{name} streaming with other tau, g, length and noise against eager", got,
                      tc.convert_streaming(clip45, tgt, src, **kw2))
    _L2_FLUSH.clear()
    memory = {}
    clip240 = voice(240.0, 140.0, seed=29)
    for label, fn in (("streaming 60 s", lambda: tc.convert_streaming(clip60, src, tgt, **kw)),
                      ("streaming 240 s", lambda: tc.convert_streaming(clip240, src, tgt, **kw)),
                      ("one-shot 60 s", lambda: tc.convert(clip60, src, tgt, fast=True, **kw))):
        for variant in ("graph", "eager"):
            with eager(tc) if variant == "eager" else contextlib.nullcontext():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
            memory[f"{label}, {variant}"] = {"peak_gb": peak / 1e9, "above_resident_gb": (peak - resident) / 1e9,
                                             "wall_s": wall}
            print(f"{label} (serving mode, {variant}): peak device memory allocated {peak / 1e9:.3f} GB, "
                  f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident before it; "
                  f"{wall:.3f} s  [{smi}]")
    memory["graph pool_gb"] = pool_bytes(tc.device) / 1e9
    memory["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    print(f"the device's graph pool {memory['graph pool_gb']:.3f} GB (a replay's temporaries live there, "
          f"not in the allocated peak), reserved in all {memory['reserved_gb']:.3f} GB  [{smi}]")
    check(memory["streaming 240 s, eager"]["above_resident_gb"]
          <= 1.25 * memory["streaming 60 s, eager"]["above_resident_gb"],
          "streaming's device memory grows with the clip's length")
    # a replay allocates next to nothing outside the pool: 1 MB of slack
    # keeps a ratio of two near-zero numbers from deciding
    check(memory["streaming 240 s, graph"]["above_resident_gb"]
          <= 1.25 * memory["streaming 60 s, graph"]["above_resident_gb"] + 1e-3,
          "streaming's device memory grows with the clip's length (graph replays)")
    return memory


# -- phase 9: converter training -----------------------------------------------------

TRAIN_STEPS = 4            # the first run's steps; the resumed run goes on to RESUME_STEPS
RESUME_STEPS = 6
TRAIN_BATCH = 8            # train()'s defaults: B 8, 128-frame segments, 32-frame decoder slice
TRAIN_SEGMENT = 128
OVERFIT_STEPS = 20
TRAIN_METRIC_TOL = 1e-4    # card against CPU: each loss, relative
TRAIN_GRAD_F64_TOL = 1e-10  # card against CPU in f64: each gradient leaf, of the leaf's peak
TRAIN_GRAD_F32_RATIO = 3.0  # f32 gradients' median leaf distance from f64: the card's over the CPU's, D and G each
QUALITY_TOL = 1e-4         # mcd / se_cosine / dataset SEs: K5 on the card against the CPU's plain path


def write_train_set(root: str) -> None:
    """2 speakers × 2 WAV files of 8 s at 22,050 Hz, from seeded voices."""
    from openvoice_tpu_torch.audio.io import write_wav

    for s, f0 in enumerate((120.0, 210.0)):
        os.makedirs(os.path.join(root, f"speaker{s}"))
        for i in range(2):
            write_wav(os.path.join(root, f"speaker{s}", f"utt{i}.wav"), voice(8.0, f0 + 15.0 * i, seed=40 + 2 * s + i),
                      SR)


def same_tree(a, b) -> bool:
    """Bitwise equality of two state dicts (nested dicts and lists of
    tensors and plain values), wherever their tensors live."""
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(map(same_tree, a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    return a == b


def same_state(a, b) -> bool:
    """Two GAN train states hold the same weights, optimizer states and steps, bit for bit."""
    return all(x.step == y.step and same_tree(x.model.state_dict(), y.model.state_dict())
               and same_tree(x.opt.state_dict(), y.opt.state_dict()) for x, y in ((a.gen, b.gen), (a.disc, b.disc)))


def leaves_moved(before, after) -> list[str]:
    """The names of the leaves of module `after` that still equal module `before`'s."""
    import torch

    now = after.state_dict()
    return [k for k, v in before.state_dict().items() if torch.equal(v, now[k])]


def gan_run(root: str, ckpt: str, steps: int, smi: str) -> tuple:
    """One `train()` call on the card: → (state, {step: wall s}, {step: metrics}).
    Each step's wall ends at its on_step (after a synchronise): it holds the
    step, the batch's upload and any checkpoint saved at that step; the first
    also the init (or the resume) and the first batch."""
    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG
    from openvoice_tpu_torch.training.loop import train

    walls, metrics, last = {}, {}, [time.perf_counter()]

    def on_step(step, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls[step], last[0] = now - last[0], now
        metrics[step] = {k: float(v) for k, v in m.items()}

    state = train(root, V2_CONVERTER_CONFIG, steps=steps, batch_size=TRAIN_BATCH, segment_frames=TRAIN_SEGMENT,
                  adversarial=True, ckpt_dir=ckpt, ckpt_every=2, log_every=0, seed=SEED, on_step=on_step)
    for step in sorted(walls):
        print(f"  step {step}: {walls[step] * 1e3:.1f} ms  " + ", ".join(f"{k} {v:.5g}" for k, v in metrics[step].items())
              + f"  [{smi}]")
    return state, walls, metrics


def first_batch(root: str, cfg, batch: int, converter=None) -> tuple:
    """The first batch `ConverterDataset` gives (seed SEED), through the
    prefetch worker thread as `train()` takes it."""
    from openvoice_tpu_torch.training.data import ConverterDataset, PrefetchIterator

    ds = ConverterDataset(root, cfg, batch, TRAIN_SEGMENT, seed=SEED, converter=converter)
    with PrefetchIterator(iter(ds)) as it:
        return next(it)


def train_gan(root: str, tmp: str, smi: str, kind: str) -> dict:
    """9.1-9.2: the data, the short GAN run and its resume, and the step's numbers."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch.ckpt import native_io as CIO
    from openvoice_tpu_torch.training import train as T

    phase(f"9. training: V2 converter at full width, GAN recipe, B {TRAIN_BATCH}, {TRAIN_SEGMENT}-frame segments, "
          f"32-frame decoder slice; train() {TRAIN_STEPS} steps, then resumed to {RESUME_STEPS}")
    write_train_set(root)
    ckpt = os.path.join(tmp, "ckpt")
    torch.cuda.synchronize()
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    first, walls, metrics = gan_run(root, ckpt, TRAIN_STEPS, smi)  # left as the step-4 checkpoint saved it
    check(sorted(metrics) == list(range(1, TRAIN_STEPS + 1)), f"on_step saw {sorted(metrics)}")
    check(CIO.latest_step(ckpt) == TRAIN_STEPS, f"latest checkpoint {CIO.latest_step(ckpt)}")
    second, walls2, metrics2 = gan_run(root, ckpt, RESUME_STEPS, smi)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = launch_counts()
    print(f"resumed run: on_step saw {sorted(metrics2)}; kernel launches in both runs {launches}; "
          f"peak device memory {peak_gb:.2f} GB  [{smi}]")
    check(sorted(metrics2) == list(range(TRAIN_STEPS + 1, RESUME_STEPS + 1)), "the resumed run did not see [5, 6]")
    check(not any(launches.values()), "the train step launched a kernel: it runs on stock layers, as JAX's does")
    all_metrics = {**metrics, **metrics2}
    check(all(math.isfinite(v) for m in all_metrics.values() for v in m.values()), "a loss is not finite")
    check(second.gen.step == second.disc.step == RESUME_STEPS, "steps counted wrong")

    # the step-4 state back from its checkpoint, bit for bit
    template = T.init_gan_train_state(cfg, torch.Generator().manual_seed(SEED + 9))
    loaded = CIO.load_checkpoint(os.path.join(ckpt, f"step_{TRAIN_STEPS}"), template=template)
    same = same_state(first, loaded)
    fresh = T.init_gan_train_state(cfg, torch.Generator().manual_seed(SEED))  # the loop's init
    still_g = leaves_moved(fresh.gen.model, second.gen.model)
    still_d = leaves_moved(fresh.disc.model, second.disc.model)
    n_g, n_d = len(fresh.gen.model.state_dict()), len(fresh.disc.model.state_dict())
    print(f"step-{TRAIN_STEPS} checkpoint loads bit for bit: {same}; leaves moved since init: "
          f"G {n_g - len(still_g)}/{n_g} (unmoved: {still_g}), D {n_d - len(still_d)}/{n_d} (unmoved: {still_d})")
    check(same, "the loaded checkpoint differs from the state saved")
    check(len(still_g) < n_g and len(still_d) < n_d, "G or D did not move")
    del first, template, loaded, fresh

    # the warm step alone, on one fixed batch, as replays of the graph
    # train() captured for its shape and eager: walls, profiler, FLOPs
    spec, audio, lengths, g = (torch.from_numpy(a).cuda() for a in first_batch(root, cfg, TRAIN_BATCH))
    gen = torch.Generator().manual_seed(SEED + 5)

    def step():
        T.gan_train_step(second, cfg, spec, audio, lengths, g, gen, segment_frames=32)
        torch.cuda.synchronize()

    before = graph_state(second.graphs)
    step()
    expect_replay("the warm GAN step of train()'s shape", second.graphs, before, 1)
    with eager(second):
        step()
    blocks: dict[str, list[float]] = {"eager": [], "graph": []}
    for variant in ("eager", "graph", "graph", "eager"):
        with eager(second) if variant == "eager" else contextlib.nullcontext():
            for _ in range(5):
                t0 = time.perf_counter()
                step()
                blocks[variant].append((time.perf_counter() - t0) * 1e3)
    step_ms, eager_ms = statistics.median(blocks["graph"]), statistics.median(blocks["eager"])
    step_walls = blocks["graph"]
    busy = device_profile(step, None, "profiled warm GAN step, graph replay")
    with eager(second):
        busy_eager = device_profile(step, None, "profiled warm GAN step, eager")
        with FlopCounterMode(display=False) as counter:
            step()
    flop = counter.get_total_flops()
    backward = sum(n for op, n in counter.get_flop_counts()["Global"].items() if "backward" in str(op))
    f32_rate = card_peaks(kind)[0]
    bound_ms = flop / f32_rate * 1e3
    loop_warm = [walls[s] * 1e3 for s in sorted(walls)[1:]] + [walls2[s] * 1e3 for s in sorted(walls2)[1:]]
    print(f"train() step walls (ms, first of each run holds its init and its graph's capture): "
          f"{[round(w * 1e3, 1) for w in walls.values()]} then {[round(w * 1e3, 1) for w in walls2.values()]}; "
          f"median of the warm ones {statistics.median(loop_warm):.1f} ms (steps 2 and 4 hold a checkpoint save)")
    print(f"warm GAN step alone: graph replay {step_ms:.1f} ms, eager {eager_ms:.1f} ms (median of 10 each, blocks "
          f"of 5: eager, graph, graph, eager: {[round(w, 1) for w in blocks['graph']]} / "
          f"{[round(w, 1) for w in blocks['eager']]}); {flop / 1e12:.3f} TFLOP (matmuls and convolutions, forward and "
          f"backward, torch.utils.flop_counter; convolution backward {backward / 1e12:.3f}); f32 bound "
          f"{bound_ms:.2f} ms at {f32_rate / 1e12:.1f} TFLOP/s = {100 * bound_ms / step_ms:.1f}% of the replayed "
          f"step  [{smi}]")
    return {"state": second, "loop_step_ms": {**{s: w * 1e3 for s, w in walls.items()},
                                              **{s: w * 1e3 for s, w in walls2.items()}},
            "loop_warm_median_ms": statistics.median(loop_warm), "step_ms": step_ms, "step_walls_ms": step_walls,
            "eager_step_ms": eager_ms, "eager_step_walls_ms": blocks["eager"], "busy_share": busy,
            "busy_share_eager": busy_eager, "tflop": flop / 1e12, "f32_bound_ms": bound_ms, "peak_gb": peak_gb,
            "metrics": all_metrics}


def train_overfit(root: str, smi: str) -> list[float]:
    """9.3: 20 mel/KL steps at lr 1e-3 on one fixed batch with fixed draws."""
    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch.training import train as T

    state = T.init_train_state(cfg, torch.Generator().manual_seed(SEED + 3), lr=1e-3)
    spec, audio, lengths, g = (torch.from_numpy(a).cuda() for a in first_batch(root, cfg, TRAIN_BATCH))
    mels, walls = [], []
    for _ in range(OVERFIT_STEPS):
        t0 = time.perf_counter()
        state, m = T.train_step(state, cfg, spec, audio, lengths, g, torch.Generator().manual_seed(42), lr=1e-3)
        mels.append(float(m["mel"]))  # reads back: the step has ended
        walls.append((time.perf_counter() - t0) * 1e3)
    first, last = statistics.mean(mels[:5]), statistics.mean(mels[-5:])
    print(f"mel/KL overfit, {OVERFIT_STEPS} steps at lr 1e-3: mel {[round(v, 4) for v in mels]}; mean of the first 5 "
          f"{first:.4f}, of the last 5 {last:.4f}; warm step (a graph replay) {statistics.median(walls[1:]):.1f} ms, "
          f"the first (eager, then the capture) {walls[0]:.1f} ms; the state's graphs {graph_state(state.graphs)}  "
          f"[{smi}]")
    check(all(math.isfinite(v) for v in mels) and last < first, "the mel/KL steps did not lower the mel loss")
    return mels


def train_graph_checks(root: str, smi: str) -> dict:
    """9.3b: each train step at full V2 width, B 8, three steps from one
    state as graph replays (the first call eager, then captured) against
    the steps with the graphs off.

    In f64 every loss and every parameter leaf within TRAIN_GRAD_F64_TOL of
    its peak.  In f32 two eager runs need not agree (cuDNN's backward
    algorithms may sum in any order), and over three steps one f32 sum that
    rounds across a leaky-ReLU kink sends a run onto one of a few nearby
    trajectories: how far two runs end apart depends on which each took,
    and a single pair of runs does not measure the spread.  So in f32
    (a) each run's three steps against the f64 run: the replays' median
    leaf no farther than TRAIN_GRAD_F32_RATIO times the eager run's (9.4's
    bar); (b) one more step from one state, copied from the replayed run
    into two eager states: the replay's losses and median leaf within
    TRAIN_GRAD_F32_RATIO times the two eager steps' spread.  A loss of one
    step moves by one f32 rounding now and then (the generator's losses go
    through the discriminator's update), and two eager steps may agree
    exactly: the losses' spread is taken as at least f32's epsilon."""
    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch.api import resolve_device
    from openvoice_tpu_torch.training import train as T

    base = T.init_gan_train_state(cfg, torch.Generator().manual_seed(SEED + 6), device="cpu")
    seed_flow_posts(base.gen.model, SEED + 7)
    host = first_batch(root, cfg, TRAIN_BATCH)
    dev = resolve_device(None)
    out: dict = {}

    def fresh(gan: bool, dtype, graphs_on: bool):
        gen = T.make_train_state(copy.deepcopy(base.gen.model).to(dev, dtype))
        state = T.GanTrainState(gen=gen, disc=T.make_train_state(copy.deepcopy(base.disc.model).to(dev, dtype))) \
            if gan else gen
        state.graphs.enabled = graphs_on
        return state

    def parts(state) -> tuple:
        return (state.gen, state.disc) if isinstance(state, T.GanTrainState) else (state,)

    def leaves(state) -> list:
        return [p.detach().double().cpu() for part in parts(state) for p in part.model.parameters()]

    def steps(state, gan: bool, args: list, n: int, seed: int) -> tuple[list[dict], list]:
        draws = torch.Generator().manual_seed(seed)
        losses = []
        for _ in range(n):
            _, m = (T.gan_train_step if gan else T.train_step)(state, cfg, *args, draws, segment_frames=32)
            losses.append({k: float(v) for k, v in m.items()})
        return losses, leaves(state)

    def loss_distance(a: list, b: list) -> float:
        return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30) for x, y in zip(a, b) for k in y)

    def median_leaf(a: list, b: list) -> float:
        return statistics.median(leaf_distances(a, b).values())

    for gan in (False, True):
        name = "gan_train_step" if gan else "train_step"
        runs = {}
        for dtype in (torch.float64, torch.float32):
            args = [torch.from_numpy(a.copy()) for a in host]
            args = [a.to(dtype) if a.is_floating_point() else a for a in args]
            graphed = fresh(gan, dtype, True)
            t0 = time.perf_counter()
            runs[dtype, "graph"] = steps(graphed, gan, args, 3, SEED + 8)
            torch.cuda.synchronize()
            graph_s = time.perf_counter() - t0
            gs = graph_state(graphed.graphs)
            check((gs["captures"], gs["replays"]) == (1, 2) and all(p.step == 3 for p in parts(graphed)),
                  f"{name}: three calls took {[p.step for p in parts(graphed)]} steps, {gs['captures']} captures, "
                  f"{gs['replays']} replays")
            runs[dtype, "eager"] = steps(fresh(gan, dtype, False), gan, args, 3, SEED + 8)
            if dtype == torch.float32:
                # one more step from one state: the replayed run's, copied into two eager states
                copies = []
                for _ in range(2):
                    st = fresh(gan, dtype, False)
                    for dst, src in zip(parts(st), parts(graphed)):
                        dst.model.load_state_dict(src.model.state_dict())
                        dst.opt.load_state_dict(copy.deepcopy(src.opt.state_dict()))
                        dst.step = src.step
                    copies.append(st)
                one = {k: steps(st, gan, args, 1, SEED + 9) for k, st in (("graph", graphed), ("a", copies[0]),
                                                                          ("b", copies[1]))}
                check(graphed.graphs.replays == 3, "the fourth step did not replay")
            del graphed
        f64_d = {"loss": loss_distance(runs[torch.float64, "graph"][0], runs[torch.float64, "eager"][0]),
                 "worst_leaf": grad_worst(runs[torch.float64, "graph"][1], runs[torch.float64, "eager"][1],
                                          [""] * len(runs[torch.float64, "eager"][1]))[0]}
        truth = runs[torch.float64, "eager"][1]
        traj = {k: median_leaf(runs[torch.float32, k][1], truth) for k in ("graph", "eager")}
        step_d = {"loss": loss_distance(one["graph"][0], one["a"][0]),
                  "median_leaf": median_leaf(one["graph"][1], one["a"][1])}
        spread = {"loss": loss_distance(one["b"][0], one["a"][0]), "median_leaf": median_leaf(one["b"][1], one["a"][1])}
        print(f"{name}, B {TRAIN_BATCH}, three steps from one state, replays against eager: f64 worst loss "
              f"{f64_d['loss']:.3e}, worst leaf {f64_d['worst_leaf']:.3e} of its peak (bar {TRAIN_GRAD_F64_TOL}); f32 "
              f"median leaf from f64: replays {traj['graph']:.3e}, eager {traj['eager']:.3e} (bar "
              f"{TRAIN_GRAD_F32_RATIO}× eager's); capture {gs['capture_s']:.3f} s (f32), three f32 steps as graph "
              f"{graph_s:.2f} s  [{smi}]")
        print(f"{name}, one more f32 step from one state: the replay against eager, loss {step_d['loss']:.3e}, "
              f"median leaf {step_d['median_leaf']:.3e}; two eager steps: loss {spread['loss']:.3e}, median leaf "
              f"{spread['median_leaf']:.3e} (bars {TRAIN_GRAD_F32_RATIO}× those, the loss's at least "
              f"{TRAIN_GRAD_F32_RATIO}× f32's epsilon)  [{smi}]")
        check(f64_d["loss"] <= TRAIN_GRAD_F64_TOL and f64_d["worst_leaf"] <= TRAIN_GRAD_F64_TOL,
              f"{name}: the replays stray from eager in f64")
        check(traj["graph"] <= TRAIN_GRAD_F32_RATIO * traj["eager"],
              f"{name}: the f32 replays stray from f64 farther than eager does")
        check(step_d["loss"] <= TRAIN_GRAD_F32_RATIO * max(spread["loss"], torch.finfo(torch.float32).eps)
              and step_d["median_leaf"] <= TRAIN_GRAD_F32_RATIO * spread["median_leaf"],
              f"{name}: a replayed f32 step strays from eager beyond two eager steps' spread")
        out[name] = {"f64": f64_d, "f32_from_f64": traj, "f32_step": step_d, "f32_step_spread": spread,
                     "capture_s": gs["capture_s"]}
    return out


def grad_worst(got: list, ref: list, names: list[str]) -> tuple[float, str]:
    """The worst leaf's max |got − ref| over its peak |ref|, and its name."""
    rows = []
    for name, a, b in zip(names, got, ref):
        peak, err = float(b.abs().max()), float((a - b).abs().max())
        rows.append((err / peak if peak > 0 else (0.0 if err == 0 else math.inf), name))
    return max(rows)


def grad_distance(got: list, ref: list) -> float:
    """‖got − ref‖ over ‖ref‖, each norm over every element of every leaf."""
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, ref))
    return math.sqrt(num / sum(float((b ** 2).sum()) for b in ref))


def leaf_distances(got: list, ref: list) -> dict[int, float]:
    """`grad_distance` of each leaf whose reference is not all zeros, by index."""
    return {j: grad_distance([a], [b]) for j, (a, b) in enumerate(zip(got, ref)) if b.any()}


def train_card_vs_cpu(root: str, smi: str, seed: int = SEED + 4, tf32_control: bool = False) -> dict:
    """9.4: one GAN step at full width, B = 1, on the card and on the CPU from
    the same weights, noise and starts, TF32 off: the losses of D and of G
    through the fixed D (f32), every gradient leaf of both in f64, D's and
    G's gradients in f32, then a whole f32 step's metrics.

    The f32 bar: the discriminators are leaky-ReLU stacks whose random-init
    activations sit near the kink, and one f32 pre-activation that rounds to
    the other side of zero scales its gradient element by 10; the change
    flows into every leaf upstream of it in that sub-network.  Which sums
    flip differs between the card's cuDNN and the CPU, so the worst leaf and
    a norm over all leaves show the flips, not the precision.  The median
    leaf's distance from f64 shows the precision: the card's is held to
    TRAIN_GRAD_F32_RATIO times the CPU's, for D and for G.  In f64 no sum
    sits that close to a kink, and each leaf is held to TRAIN_GRAD_F64_TOL
    of its peak.  With `tf32_control` the card's f32 pass is made again with
    TF32 on, the leaves farthest from f64 are printed, and the readings are
    returned unchecked (the caller checks them over several seeds) without
    the whole step."""
    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch.training import train as T

    gen = torch.Generator().manual_seed(seed)
    cpu = T.init_gan_train_state(cfg, gen, device="cpu")
    seed_flow_posts(cpu.gen.model, seed + 2)
    card = T.GanTrainState(gen=T.make_train_state(copy.deepcopy(cpu.gen.model).cuda()),
                           disc=T.make_train_state(copy.deepcopy(cpu.disc.model).cuda()))
    card_dev = next(card.gen.model.parameters()).device
    batch = [torch.from_numpy(a[:1].copy()) for a in first_batch(root, cfg, TRAIN_BATCH)]
    noise, u = T.host_draws(cfg, 1, batch[0].shape[1], gen)
    starts = T.starts_from_u(u, batch[2], 32)
    d_names = [n for n, _ in cpu.disc.model.named_parameters()]
    g_names = [n for n, _ in cpu.gen.model.named_parameters()]

    def pieces(state, dev, dtype=torch.float32):
        gm, dm = (state.gen.model, state.disc.model) if dtype == torch.float32 else \
            (copy.deepcopy(state.gen.model).to(dtype), copy.deepcopy(state.disc.model).to(dtype))
        spec, audio, lengths, g = (a.to(dev) if a.dtype == torch.int32 else a.to(dev, dtype) for a in batch)
        fwd = T._generator_forward(gm, cfg, spec, audio, lengths, g, None, 32, noise.to(dev, dtype),
                                   starts.to(dev))
        d_loss = T.discriminator_loss(dm, fwd.target, fwd.audio_hat)
        d_grads = T.grads_of(d_loss, dm)
        g_loss, m = T.generator_loss(dm, fwd, cfg)
        g_grads = T.grads_of(g_loss, gm)
        losses = {"disc": float(d_loss.detach()), "gen_total": float(g_loss.detach()),
                  **{k: float(v.detach()) for k, v in m.items()}}
        return losses, [gr.double().cpu() for gr in d_grads], [gr.double().cpu() for gr in g_grads]

    t0 = time.perf_counter()
    ref = pieces(cpu, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    got = pieces(card, card_dev)
    loss_rel = {k: abs(got[0][k] - v) / abs(v) for k, v in ref[0].items()}
    ref64, got64 = pieces(cpu, torch.device("cpu"), torch.float64), pieces(card, card_dev, torch.float64)
    if tf32_control:
        matmul = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=True):
                tf32 = pieces(card, card_dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
    rows = {}
    for part, i, names in (("D", 1, d_names), ("G", 2, g_names)):
        cpu_leaves, card_leaves = leaf_distances(ref[i], ref64[i]), leaf_distances(got[i], ref64[i])
        rows[part] = {"f64 card vs cpu, worst leaf": grad_worst(got64[i], ref64[i], names)[0],
                      "f32 card vs cpu, worst leaf": grad_worst(got[i], ref[i], names)[0],
                      "f32 cpu vs f64, norm": grad_distance(ref[i], ref64[i]),
                      "f32 card vs f64, norm": grad_distance(got[i], ref64[i]),
                      "f32 cpu vs f64, median leaf": statistics.median(cpu_leaves.values()),
                      "f32 card vs f64, median leaf": statistics.median(card_leaves.values())}
        rows[part]["f32 ratio"] = rows[part]["f32 card vs f64, median leaf"] / rows[part]["f32 cpu vs f64, median leaf"]
        if tf32_control:
            rows[part]["tf32 card vs f64, norm"] = grad_distance(tf32[i], ref64[i])
            rows[part]["tf32 card vs f64, median leaf"] = statistics.median(leaf_distances(tf32[i], ref64[i]).values())
            rows[part]["tf32 ratio"] = rows[part]["tf32 card vs f64, median leaf"] / rows[part]["f32 cpu vs f64, median leaf"]
            rows[part]["tf32 losses, worst relative"] = max(abs(tf32[0][k] - v) / abs(v) for k, v in ref[0].items())
            far = sorted(((card_leaves[j], cpu_leaves[j], names[j]) for j in card_leaves), reverse=True)[:5]
            print(f"  {part} leaves farthest from f64 on the card (card, cpu): "
                  + "; ".join(f"{n} {x:.2e}, {y:.2e}" for x, y, n in far))
    print(f"card against CPU, seed {seed}, fixed D, f32 losses relative: "
          f"{', '.join(f'{k} {v:.2e}' for k, v in loss_rel.items())} (bar {TRAIN_METRIC_TOL}); CPU {cpu_s:.1f} s  [{smi}]")
    for part, r in rows.items():
        print(f"  {part} gradients (worst leaf: max err / peak; else norms over all leaves): "
              + "; ".join(f"{k} {v:.3e}" for k, v in r.items())
              + f"  (bars: f64 worst leaf {TRAIN_GRAD_F64_TOL}, f32 ratio {TRAIN_GRAD_F32_RATIO})")
    if tf32_control:
        return rows
    check(all(v <= TRAIN_METRIC_TOL for v in loss_rel.values()), "card and CPU disagree on a training loss")
    check(all(r["f64 card vs cpu, worst leaf"] <= TRAIN_GRAD_F64_TOL for r in rows.values()),
          "card and CPU disagree on a gradient leaf in f64")
    check(all(r["f32 ratio"] <= TRAIN_GRAD_F32_RATIO for r in rows.values()),
          "the card's f32 gradients stray from the CPU's by more than f32 rounding")

    # a whole f32 step from the same states (the pieces above left them as they were)
    metrics = []
    for state, dev in ((cpu, torch.device("cpu")), (card, card_dev)):
        spec, audio, lengths, g = (a.to(dev) for a in batch)
        _, m = T.gan_train_step(state, cfg, spec, audio, lengths, g, segment_frames=32, noise=noise.to(dev), u=u)
        metrics.append({k: float(v) for k, v in m.items()})
    step_rel = {k: abs(metrics[1][k] - v) / abs(v) for k, v in metrics[0].items()}
    print(f"card against CPU, one gan_train_step: relative {', '.join(f'{k} {v:.2e}' for k, v in step_rel.items())} "
          f"(bar {TRAIN_METRIC_TOL})")
    check(all(v <= TRAIN_METRIC_TOL for v in step_rel.values()), "card and CPU disagree on a step's metrics")
    return {"losses_rel": loss_rel, "step_rel": step_rel, "grads": rows}


def trained_weights(trained, root: str, tmp: str, smi: str) -> dict:
    """9.5: the trained converter through the kernels, as
    benchmarks/train_real_demo.py uses it, and the quality metrics and the
    SE-conditioned dataset with K5 on the card against the CPU."""
    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch import ToneColorConverter
    from openvoice_tpu_torch.audio.io import write_wav
    from openvoice_tpu_torch.training.quality import mcd, se_cosine

    tc = ToneColorConverter(cfg=cfg, enable_watermark=False)
    tc.set_model(trained)  # packs the serving cache again from the trained weights
    cpu = ToneColorConverter(cfg=cfg, device="cpu", enable_watermark=False)
    cpu.set_model(copy.deepcopy(trained).cpu())
    ref_wav = os.path.join(tmp, "train_ref.wav")
    write_wav(ref_wav, voice(6.0, 260.0, seed=50), SR)
    src = voice(4.0, 150.0, seed=51)

    torch.cuda.synchronize()
    zero_launch_counts()
    se_tgt = tc.extract_se([ref_wav])
    se_src = tc.extract_se([os.path.join(root, "speaker0", "utt0.wav")])
    f32 = tc.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message="")
    f32_launches = launch_counts()
    zero_launch_counts()
    fast = tc.convert(src, se_src, se_tgt, tau=0.3, seed=SEED, message="", fast=True)
    torch.cuda.synchronize()
    fast_launches = launch_counts()
    diff, peak = float(np.abs(fast - f32).max()), float(np.abs(f32).max())
    print(f"trained weights: extract_se ×2 + convert f32 launched {f32_launches}; convert(fast=True) launched "
          f"{fast_launches}; max |fast - f32| = {diff:.3e} = {diff / peak:.4f} of the f32 peak {peak:.3e} "
          f"(bar {FAST_VS_F32_TOL})")
    check(f32_launches == {"stft_magnitude": 3, "wn_stack": 0, "coupling_block": 0, "mrf_stage": 0,
                           "tail_stage": 0}, "extract_se ×2 + f32 convert must launch K5 3 times and nothing else")
    check(fast_launches == {"stft_magnitude": 1, "wn_stack": 1, "coupling_block": 2, "mrf_stage": 2,
                            "tail_stage": 2}, "the trained serving convert must launch K5 1, K1 1, K2 2, K3 2, K4 2")
    check(bool(np.isfinite(fast).all()) and fast.shape == f32.shape and diff <= FAST_VS_F32_TOL * peak,
          "the trained converter's serving mode strays from its f32 mode")

    # quality metrics and the SE-conditioned dataset: K5 on the card, counted
    torch.cuda.synchronize()
    zero_launch_counts()
    q_card = {"mcd": mcd(src, f32, SR), "se_cosine": se_cosine(tc, f32, se_tgt)}
    batch_card = first_batch(root, cfg, TRAIN_BATCH, converter=tc)
    torch.cuda.synchronize()
    launches = launch_counts()
    q_cpu = {"mcd": mcd(src, f32, SR, device="cpu"), "se_cosine": se_cosine(cpu, f32, se_tgt)}
    batch_cpu = first_batch(root, cfg, TRAIN_BATCH, converter=cpu)
    speakers = len({float(row[0, 0]) for row in batch_cpu[3]})
    g_diff = float(np.abs(batch_card[3] - batch_cpu[3]).max())
    g_peak = float(np.abs(batch_cpu[3]).max())
    q_diff = {k: abs(q_card[k] - v) / max(abs(v), 1e-12) if k == "mcd" else abs(q_card[k] - v) for k, v in q_cpu.items()}
    print(f"quality on the card {q_card}, on the CPU {q_cpu}: mcd relative {q_diff['mcd']:.2e}, se_cosine absolute "
          f"{q_diff['se_cosine']:.2e} (bar {QUALITY_TOL}); dataset g (worker thread, {speakers} speakers) "
          f"max |card - cpu| {g_diff:.2e} of peak {g_peak:.4f}; launches {launches}")
    check(all(v <= QUALITY_TOL for v in q_diff.values()), "the quality metrics disagree between card and CPU")
    check(g_peak > 0 and g_diff <= QUALITY_TOL * g_peak, "the dataset's SEs disagree between card and CPU")
    check(launches == {"stft_magnitude": 3 + speakers, "wn_stack": 0, "coupling_block": 0, "mrf_stage": 0,
                       "tail_stage": 0}, f"mcd (2), se_cosine (1) and the dataset ({speakers}) must launch K5 only")
    for a, c in zip(batch_card[:3], batch_cpu[:3]):
        check(np.array_equal(a, c), "the dataset's spectrograms or audio differ between card and CPU runs")
    return {"quality_card": q_card, "quality_cpu": q_cpu, "quality_diff": q_diff, "dataset_g_diff": g_diff,
            "launches": launches, "fast_vs_f32": diff / peak}


def training_phase(tmp: str, smi: str, kind: str) -> dict:
    import torch

    from openvoice_tpu_torch.runtime.graphs import pool_bytes

    t0 = time.perf_counter()
    root = os.path.join(tmp, "train_set")
    run = train_gan(root, tmp, smi, kind)
    mels = train_overfit(root, smi)
    graphs = train_graph_checks(root, smi)
    cvc = train_card_vs_cpu(root, smi)
    kernels = trained_weights(run.pop("state").gen.model, root, tmp, smi)
    pool_gb = pool_bytes("cuda:0") / 1e9
    print(f"training phase: {time.perf_counter() - t0:.1f} s; the graph pool after it {pool_gb:.3f} GB, "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved in all  [{smi}]")
    return {**run, "overfit_mel": mels, "graphs": graphs, "pool_gb": pool_gb, "card_vs_cpu": cvc, **kernels}


# -- phase 10: audio formats and the mesh tier --------------------------------------

# a lossy codec's decode of the 10 s clip against the WAV decode, time-aligned:
# the SNR floor in dB (this clip measured mp3 128 kbps 25.7, Vorbis q0.4
# 29.6, AAC 128 kbps 42.5 with the libraries of one x86 host; the floors
# leave 5-7 dB for other library versions)
CODEC_SNR_DB = {"mp3": 20.0, "ogg": 24.0, "m4a": 35.0}
SE_COSINE_MIN = 0.9    # a lossy clip's speaker embedding against the WAV clip's
MESH_ATOL, MESH_RTOL = 2e-5, 1e-4  # the JAX suite's distributed bar (tests/test_distributed.py)
MESH_FRAMES = [861, 700, 512, 430, 300, 200, 600, 172]  # the 2-rank convert round's rows, bucket 1024
CHILD_TIMEOUT_S = 420


def aligned_snr(a: np.ndarray, ref: np.ndarray, max_lag: int = 4096) -> tuple[int, float]:
    """(lag, SNR in dB) of `a` against `ref` at the lag of their peak
    cross-correlation within ±max_lag samples (a codec's delay)."""
    n = len(ref)
    m = 1 << int(np.ceil(np.log2(len(a) + n)))
    xc = np.fft.irfft(np.fft.rfft(a, m) * np.conj(np.fft.rfft(ref, m)), m)
    lags = np.r_[np.arange(0, max_lag + 1), np.arange(-max_lag, 0)]
    lag = int(lags[np.argmax(xc[lags % m])])
    seg = a[lag : lag + n] if lag >= 0 else np.concatenate([np.zeros(-lag, a.dtype), a])[:n]
    err = np.pad(seg, (0, n - len(seg))) - ref
    return lag, float(10 * np.log10(np.sum(ref.astype(np.float64) ** 2) / max(np.sum(err.astype(np.float64) ** 2),
                                                                           1e-30)))


def codecs() -> dict:
    """Build the codec libraries from audio/native_src and report which codecs this
    machine has (a missing system library is reported, not failed)."""
    from openvoice_tpu_torch.audio import _native_build, ffdec, flac, mp3, ogg, opus

    t0 = time.perf_counter()
    built = [_native_build.build("ovt_audio").name]
    if _native_build.ffmpeg_found():
        built.append(_native_build.build("ovt_ffdec").name)
    print(f"built {built} with {_native_build._cxx()} in {time.perf_counter() - t0:.2f} s")
    mpg123 = True
    try:  # the decoder answers -3 before it opens the file where libmpg123 is absent
        mp3.read_mp3(os.path.join(tempfile.gettempdir(), "no-such-file.mp3"))
    except ValueError as exc:
        mpg123 = "code -3" not in str(exc)
    found = {"flac": flac.available(), "mp3 decode (libmpg123)": mpg123,
             "mp3 encode (libmp3lame)": mp3.encoder_available(),
             "ogg (libvorbis, libvorbisfile)": ogg.available(),
             "m4a/aac/mp4/… (ffmpeg)": ffdec.available(), "opus (libopus)": opus.available()}
    print("codecs: " + ", ".join(f"{k} {'yes' if v else 'ABSENT'}" for k, v in found.items()))
    check(found["flac"], "the in-repo FLAC codec did not build")
    return found


def audio_formats_phase(tc, ses: dict, tmp: str, smi: str) -> dict:
    """10a: every available format of a 10 s clip through load_audio →
    extract_se_from_file → convert(fast=True), held against the WAV clip."""
    import base64
    import urllib.error
    import urllib.request

    import torch

    from openvoice_tpu_torch.audio import ffdec, flac, mp3, ogg
    from openvoice_tpu_torch.audio.io import load_audio, write_wav
    from openvoice_tpu_torch.serve import server as tserver

    phase("10a. audio formats: a 10 s clip written as wav, flac, mp3, ogg, m4a through load_audio → "
          "extract_se_from_file → convert(fast=True), V2 full width")
    found = codecs()
    clip = voice(10.0, 140.0, seed=31)
    writers = {"wav": write_wav, "flac": flac.write_flac}
    if found["mp3 encode (libmp3lame)"]:
        writers["mp3"] = mp3.write_mp3
    if found["ogg (libvorbis, libvorbisfile)"]:
        writers["ogg"] = ogg.write_ogg
    if found["m4a/aac/mp4/… (ffmpeg)"]:
        writers["m4a"] = ffdec.write_m4a
    runs, decode_ms, convert_launches = {}, {}, {}
    expected = {"stft_magnitude": 1, "wn_stack": 1, "coupling_block": 2, "mrf_stage": 2, "tail_stage": 2}
    for fmt, write in writers.items():
        path = os.path.join(tmp, f"clip.{fmt}")
        write(path, clip, SR)
        try:
            t0 = time.perf_counter()
            audio, _ = load_audio(path, sr=SR)
            decode_ms[fmt] = (time.perf_counter() - t0) * 1e3
        except ValueError as exc:  # mp3 written but libmpg123 absent: the decoder answers -3
            check(fmt == "mp3" and "code -3" in str(exc), f"{fmt} decode failed: {exc}")
            print(f"{fmt}: written, not decodable here (libmpg123 absent)")
            continue
        torch.cuda.synchronize()
        zero_launch_counts()
        se = tc.extract_se_from_file(path)
        torch.cuda.synchronize()
        se_launches = launch_counts()
        zero_launch_counts()
        out = tc.convert(audio, ses["se_src"], se, tau=0.3, seed=SEED, message="", fast=True)
        torch.cuda.synchronize()
        launches = launch_counts()
        check(se_launches["stft_magnitude"] == 1 and sum(se_launches.values()) == 1,
              f"{fmt}: extract_se_from_file launched {se_launches}")
        check(launches == expected, f"{fmt}: convert(fast=True) launched {launches}, not {expected}")
        check(bool(np.isfinite(out).all()) and out.shape[0] % tc.cfg.upsample_factor == 0, f"{fmt}: bad audio")
        runs[fmt] = (audio, se.reshape(-1), out)
        convert_launches[fmt] = launches
        print(f"{fmt}: {os.path.getsize(path)} bytes, decoded {len(audio)} samples in {decode_ms[fmt]:.2f} ms; "
              f"launches extract_se {se_launches['stft_magnitude']} K5, convert {launches}")
    wav_audio, wav_se, wav_out = runs["wav"]
    flac_audio, _, flac_out = runs["flac"]
    # FLAC's PCM16 grid: llround(x · 32767) encoded, read back × 2⁻¹⁵
    scaled = np.clip(clip.astype(np.float64), -1.0, 1.0) * 32767.0
    grid = (np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)).astype(np.float32) * np.float32(2.0 ** -15)
    check(np.array_equal(flac_audio, grid), "FLAC is not lossless at PCM16")
    check(float(np.abs(flac_audio - wav_audio).max()) <= 1.5 / 32768.0, "FLAC and WAV decodes differ by > 1 LSB")
    d = float(np.abs(flac_out - wav_out).max())
    check(flac_out.shape == wav_out.shape and d <= FAST_VS_F32_TOL * float(np.abs(wav_out).max()),
          "the FLAC clip's convert strays from the WAV clip's")
    agreement = {"flac": {"decode": "lossless at PCM16", "convert_max_over_peak": d / float(np.abs(wav_out).max())}}
    for fmt, floor in CODEC_SNR_DB.items():
        if fmt not in runs:
            continue
        audio, se, out = runs[fmt]
        lag, snr = aligned_snr(audio, wav_audio)
        cos = float(np.dot(se, wav_se) / (np.linalg.norm(se) * np.linalg.norm(wav_se)))
        _, out_snr = aligned_snr(out, wav_out)
        agreement[fmt] = {"decode_lag": lag, "decode_snr_db": snr, "se_cosine": cos, "convert_snr_db": out_snr}
        print(f"{fmt} against wav: decode lag {lag} samples, SNR {snr:.2f} dB (floor {floor}); speaker embedding "
              f"cosine {cos:.5f} (floor {SE_COSINE_MIN}); converted audio SNR {out_snr:.2f} dB")
        check(snr >= floor and cos >= SE_COSINE_MIN, f"{fmt} strays from the WAV clip beyond its codec's bar")

    # serve(): format mp3 at 64 kbps (a 400 where the encoder is absent)
    svc = tserver.VoiceService(tc, max_batch=2, device=tc.device)
    httpd = tserver.serve(svc, port=0)
    try:
        src = os.path.join(tmp, "clip.mp3" if "mp3" in runs else "clip.wav")
        body = {"audio_path": src, "tgt_se": ses["se_tgt"].reshape(-1).tolist(), "format": "mp3", "kbps": 64}
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/convert",
                                     data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                code, resp = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, resp = e.code, json.loads(e.read())
    finally:
        httpd.shutdown()
        svc.close()
    if found["mp3 encode (libmp3lame)"]:
        check(code == 200 and resp["encoding"] == "mp3" and resp["kbps"] == 64, f"serve() mp3 answered {code}")
        path = os.path.join(tmp, "answer.mp3")
        with open(path, "wb") as f:
            f.write(base64.b64decode(resp["audio_b64"]))
        n = resp["num_samples"]
        served = len(load_audio(path)[0]) if "mp3" in runs else n
        check(n <= served <= n + 4608, f"the served mp3 decodes to {served} samples, not {n} + codec padding")
        print(f"serve(): /convert of {os.path.basename(src)} answered format mp3 at kbps {resp['kbps']} "
              f"({len(resp['audio_b64'])} base64 bytes, {served} samples decoded for {n})")
    else:
        check(code == 400, f"serve() answered mp3 without an encoder with {code}")
        print("serve(): mp3 answered 400 (libmp3lame absent)")
    # the kernels line's counts: those measured on the FLAC clip, which every card decodes
    return {"codecs": found, "decode_ms": decode_ms, "agreement": agreement, "launches": convert_launches["flac"]}


def mesh_close(label: str, got, ref) -> float:
    d = (got - ref).abs()
    ok = bool((d <= MESH_ATOL + MESH_RTOL * ref.abs()).all())
    worst = float(d.max())
    print(f"{label}: max |diff| {worst:.3e}, peak {float(ref.abs().max()):.4f} (bar atol {MESH_ATOL}, "
          f"rtol {MESH_RTOL})")
    check(got.shape == ref.shape and ok, f"{label} strays from the single-device convert")
    return worst


def wall_ms(fn, runs: int = 3) -> float:
    import torch

    fn()
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def mesh_phase(tc, ses: dict, smi: str) -> dict:
    """10b: the one-process mesh on the card."""
    import torch

    from openvoice_tpu_torch.api import _spec_from_audio
    from openvoice_tpu_torch.models import synthesizer as S
    from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude
    from openvoice_tpu_torch.runtime.mesh import make_mesh
    from openvoice_tpu_torch.runtime.multihost import HeartbeatMonitor
    from openvoice_tpu_torch.runtime.parallel import TensorParallel
    from openvoice_tpu_torch.runtime.sequence_parallel import required_halo, voice_conversion_sp

    cfg, dev = tc.cfg, tc.device
    phase(f"10b. one-process mesh on {dev}: sequence- and tensor-parallel convert (1×2), the batcher over 2×1")
    padded, n = _spec_from_audio(voice(10.0, 150.0, seed=7), cfg)
    x = torch.from_numpy(padded)[None].to(dev)
    spec = torch.zeros(1, BUCKET, cfg.spec_channels, device=dev)
    with torch.inference_mode():
        spec[:, :n] = stft_magnitude(x, cfg.filter_length, cfg.hop_length, cfg.win_length)[:, :n]
    lens = torch.tensor([n], device=dev)
    g_src, g_tgt = (torch.from_numpy(ses[k].reshape(1, 1, -1)).to(dev) for k in ("se_src", "se_tgt"))
    noise = torch.randn(1, BUCKET, cfg.inter_channels, generator=torch.Generator().manual_seed(SEED + 40)).to(dev)
    mesh = make_mesh(2, data=1, model=2, devices=[dev, dev])
    halo = required_halo(cfg)
    check(BUCKET // 2 >= halo, f"a {BUCKET // 2}-frame shard is shorter than the halo {halo}")
    zero_launch_counts()
    with torch.inference_mode():
        def single():
            return S.voice_conversion(tc.model, spec, lens, g_src, g_tgt, 0.3, noise)[0]

        def sp():
            return voice_conversion_sp(tc.model, spec, lens, g_src, g_tgt, 0.3, noise, mesh=mesh).gather()

        tp_model = TensorParallel(tc.model, cfg, mesh)

        def tp():
            return tp_model.convert(spec, lens, g_src, g_tgt, 0.3, noise).gather()

        ref = single()
        sp_err = mesh_close(f"sequence parallel, 2 shards of {BUCKET // 2} frames (halo {halo})", sp(), ref)
        tp_err = mesh_close("tensor parallel, 2 model positions", tp(), ref)
        walls = {"single": wall_ms(single), "sp": wall_ms(sp), "tp": wall_ms(tp)}
        # where the threads' time goes: the device's busy share of each wall,
        # and the walls again with the interpreter handing its lock between
        # threads every 10 µs (default 5 ms)
        busy = {k: device_profile(fn, walls[k], f"{k} f32 convert") for k, fn in
                (("single", single), ("sp", sp), ("tp", tp))}
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            fine = {"sp": wall_ms(sp), "tp": wall_ms(tp)}
        finally:
            sys.setswitchinterval(interval)
    launched = launch_counts()
    check(launched["stft_magnitude"] == 0 and sum(launched.values()) == 0,
          f"the f32 mesh converts launched {launched}: they run stock layers")
    print(f"walls (ms, median of 3, host clock to a synchronise): single-device f32 {walls['single']:.2f}, "
          f"sequence parallel {walls['sp']:.2f}, tensor parallel {walls['tp']:.2f}; with a 10 µs switch interval "
          f"sequence parallel {fine['sp']:.2f}, tensor parallel {fine['tp']:.2f}  [{smi}]")

    fields, _ = serve_stream_fields(tc, ses)
    eight = fields[:8]
    bmesh = make_mesh(2, data=2, model=1, devices=[dev, dev])
    bm = serving_batcher(tc, SERVE_BATCH, bmesh)  # keeps its graphs from run to run
    try:
        run_stream(tc, eight[:2], SERVE_BATCH, batcher=bm)  # warm-up
        single_run = run_stream(tc, eight, SERVE_BATCH)
        torch.cuda.synchronize()
        zero_launch_counts()
        run = run_stream(tc, eight, SERVE_BATCH, capture=True, batcher=bm)
        torch.cuda.synchronize()
        launches = launch_counts()
        groups = run["groups"]
        n_groups, n_pcm = len(groups), sum(g[0] == "pcm" for g in groups)
        per_shard = {k: v / (2 * (n_pcm if k == "stft_magnitude" else n_groups)) for k, v in launches.items()}
        print(f"mesh batcher: groups (mode, bucket, rows, padded batch) {groups}; launches {launches}")
        check(per_shard == {"stft_magnitude": 1, "wn_stack": 1, "coupling_block": 2, "mrf_stage": 2,
                            "tail_stage": 2},
              f"each shard of a group must launch K5 1 (PCM), K1 1, K2 2, K3 2, K4 2, not {per_shard}")
        check(len(run["wires"]) == n_groups, f"{len(run['wires'])} host copies for {n_groups} groups")
        zero_rows = 0
        for (_, _, rows, _), wire in zip(groups, run["wires"]):
            check(wire.shape[0] % 2 == 0 and bool((wire[rows:] == 0).all()),
                  "a padded row of length 0 is not exactly 0")
            zero_rows += wire.shape[0] - rows
        worst = 0.0
        for one, got in zip(single_run["outs"], run["outs"]):
            d = float(np.abs(got - one).max())
            check(got.shape == one.shape and d <= serve_bar(one), "the mesh batcher strays from the single batcher")
            worst = max(worst, d / float(np.abs(one).max()))
        print(f"mesh batcher against the single-device batcher, 8 requests: max diff over the peak {worst:.4f}; "
              f"{zero_rows} padded rows of length 0, each exactly 0; launches per shard of a group {per_shard}; "
              f"walls single {single_run['wall_s'] * 1e3:.1f} ms, mesh {run['wall_s'] * 1e3:.1f} ms  [{smi}]")
        # a group of 8 of one clip's length: each data position's shard
        # replays its device's graph, bit-equal to the shards eager
        same = [dict(eight[1], seed=SEED + 80 + k, tau=0.2 + 0.05 * k) for k in range(8)]
        run_stream(tc, same, SERVE_BATCH, batcher=bm)  # captures the shape where it is new
        before = graph_state(bm.graphs)
        zero_launch_counts()
        got = run_stream(tc, same, SERVE_BATCH, batcher=bm)
        torch.cuda.synchronize()
        replay_launches = launch_counts()
        check([g[2] for g in got["groups"]] == [8], f"mesh batcher groups {got['groups']}")
        expect_replay("mesh batcher, a group of 8 over 2 data positions", bm.graphs, before, 2)
        with eager(bm):
            zero_launch_counts()
            want = run_stream(tc, same, SERVE_BATCH, batcher=bm)
            torch.cuda.synchronize()
            eager_launches = launch_counts()
        same_bits("mesh batcher, a group of 8: the shards' replays against the shards eager",
                  np.concatenate(got["outs"]), np.concatenate(want["outs"]))
        check(replay_launches == eager_launches, f"mesh batcher replay launches {replay_launches} against eager "
                                                 f"{eager_launches}")
        mesh_graphs = graph_state(bm.graphs)
    finally:
        bm.stop()
    dp = dp_convert_checks(tc, ses, bmesh, smi)
    mon = HeartbeatMonitor(timeout_s=30.0)
    check(mon.beat(), "heartbeat failed")
    mon.inject_failure()
    check(not mon.beat(), "an injected failure still beat")
    print("heartbeat: beat True, after inject_failure False")
    return {"sp_max_err": sp_err, "tp_max_err": tp_err, "walls_ms": walls, "busy_share": busy,
            "walls_ms_switch_10us": fine, "per_shard": per_shard,
            "batcher_walls_ms": {"single": single_run["wall_s"] * 1e3, "mesh": run["wall_s"] * 1e3},
            "batcher_worst": worst, "batcher_graphs": mesh_graphs, "dp_convert": dp}


def dp_convert_checks(tc, ses: dict, mesh, smi: str) -> dict:
    """10b, the data-parallel convert (`data_parallel_convert` with replicas
    kept across calls, serving mode, 4 rows over the 2 data positions of
    `mesh`): the repeat replays each position's graph, with the eager
    launches (K1 1, K2 2, K3 2, K4 2 a position), bit-equal to the
    positions eager; walls eager against graph."""
    import torch

    from openvoice_tpu_torch.runtime.parallel import data_parallel_convert, make_replicas

    cfg, dev = tc.cfg, tc.device
    gen = torch.Generator().manual_seed(SEED + 41)
    frames = [FRAMES, 775, 640, 512]
    spec = torch.rand(4, BUCKET, cfg.spec_channels, generator=gen)
    for i, n in enumerate(frames):
        spec[i, n:] = 0.0
    lens = torch.tensor(frames)
    g_src = torch.from_numpy(np.repeat(ses["se_src"].reshape(1, 1, -1), 4, axis=0))
    g_tgt = torch.from_numpy(np.repeat(ses["se_tgt"].reshape(1, 1, -1), 4, axis=0))
    taus = torch.tensor([0.3, 0.5, 0.0, 0.7]).reshape(4, 1, 1)
    noise = torch.randn(4, BUCKET, cfg.inter_channels, generator=gen)
    args = [a.to(dev) for a in (spec, lens, g_src, g_tgt, taus, noise)]
    replicas = make_replicas(tc.model, {dev}, fast=True)
    (rep,) = replicas.values()

    def call():
        with torch.inference_mode():
            out = data_parallel_convert(tc.model, mesh, *args, fast=True, replicas=replicas).gather()
        return out[..., 0].float().cpu().numpy()

    call()  # captures
    torch.cuda.synchronize()
    before = graph_state(rep.graphs)
    zero_launch_counts()
    got = call()
    torch.cuda.synchronize()
    launches = launch_counts()
    expect_replay("data-parallel convert over 2 positions, repeat", rep.graphs, before, 2)
    rep.graphs.enabled = False
    try:
        zero_launch_counts()
        want = call()
        torch.cuda.synchronize()
        eager_launches = launch_counts()
    finally:
        rep.graphs.enabled = True
    same_bits("data-parallel convert: the positions' replays against the positions eager", got, want)
    per_position = {"stft_magnitude": 0, "wn_stack": 1, "coupling_block": 2, "mrf_stage": 2, "tail_stage": 2}
    check(launches == eager_launches == {k: 2 * v for k, v in per_position.items()},
          f"data-parallel convert launches {launches} as replays, {eager_launches} eager")
    walls = ab_walls(call, rep, runs=3)
    print(f"data-parallel convert, 4 rows at bucket {BUCKET} over 2 positions on {dev}: launches {launches}; walls ms "
          f"(median of 3 a block: eager, graph, graph, eager) {[round(ms, 2) for _, ms in walls]}  [{smi}]")
    return {"launches": launches, "walls_ms": walls, "graphs": graph_state(rep.graphs)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_children(world: int, backend: str, timeout_s: float = CHILD_TIMEOUT_S) -> list[dict]:
    """`world` processes of this script in child mode on cuda:0; each prints
    one ``child-result`` JSON line.  A child that fails or hangs fails the
    phase; every child is stopped before this returns."""
    addr = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-child", addr, str(world), str(r),
                               backend], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = [""] * world
    try:
        deadline = time.time() + timeout_s
        for r, p in enumerate(procs):
            outs[r], _ = p.communicate(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if not line.startswith("child-result "):
                print(f"  [rank {r}] {line}")
        lines = [ln for ln in out.splitlines() if ln.startswith("child-result ")]
        check(p.returncode == 0 and len(lines) == 1, f"{backend} rank {r} of {world} failed (exit {p.returncode})")
        results.append(json.loads(lines[0][len("child-result "):]))
    return results


def two_rank_phase(smi: str) -> dict:
    """10c: two ranks on cuda:0 over gloo, then one NCCL rank."""
    phase("10c. two processes on cuda:0 over gloo (NCCL refuses two ranks on one device): initialize → "
          "global_mesh → make_global_batch, a data-parallel B = 8 GAN step at full width, a data-parallel "
          "serving-mode convert round; then an NCCL group at world size 1")
    t0 = time.perf_counter()
    gloo = spawn_children(2, "gloo")
    nccl = spawn_children(1, "nccl")[0]
    print(f"2-rank gloo: {json.dumps(gloo)}  [{smi}]")
    print(f"1-rank nccl: {json.dumps(nccl)}  [{smi}]")
    print(f"two-process phase: {time.perf_counter() - t0:.1f} s")
    return {"gloo": gloo, "nccl": nccl}


def child_main(addr: str, world: int, rank: int, backend: str) -> int:
    """One rank of 10c (``chip_smoke.py --mesh-child``)."""
    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch.models import synthesizer as S
    from openvoice_tpu_torch.runtime import multihost as MH
    from openvoice_tpu_torch.runtime.mesh import GroupComm
    from openvoice_tpu_torch.runtime.parallel import data_parallel_convert, make_replicas
    from openvoice_tpu_torch.training import train as T
    from openvoice_tpu_torch.training.data import make_global_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    topo = MH.initialize(addr, world, rank, device="cuda:0", backend=backend, timeout_s=CHILD_TIMEOUT_S)
    check((topo.process_id, topo.num_processes) == (rank, world), f"topology {topo}")
    mesh = MH.global_mesh(model_parallel=1)
    check(mesh.shape == {"data": world, "model": 1} and mesh.local_coords() == [(rank, 0)], f"mesh {mesh}")
    dev = mesh.devices[rank, 0]
    out: dict = {"rank": rank, "backend": torch.distributed.get_backend(), "device": str(dev)}

    local = torch.arange(4, dtype=torch.float32)[:, None] + 10.0 * rank
    batch = make_global_batch(local, mesh)
    total = float(batch.sum())
    check(abs(total - sum(6.0 + 40.0 * r for r in range(world))) < 1e-4, f"global sum {total}")
    check(torch.equal(batch.gather().cpu()[:, 0], torch.cat([torch.arange(4.0) + 10.0 * r for r in range(world)])),
          "gathered batch")
    comm = GroupComm(mesh, "data", (rank, 0))
    x = torch.full((3,), float(rank + 1), device=dev)
    check(float(comm.all_reduce(x)[0]) == world * (world + 1) / 2, "all_reduce")
    shifted = comm.shift(x, 1)
    check(float(shifted[0]) == (rank if rank > 0 else 0.0), "shift")
    check(MH.HeartbeatMonitor(timeout_s=60.0).beat(), "heartbeat")

    # a data-parallel serving-mode convert round, against this process alone
    tc_model = S.init_synthesizer(cfg, torch.Generator().manual_seed(SEED)).eval()
    seed_flow_posts(tc_model, SEED + 1)
    model = tc_model.to(dev)
    n_rows = 4 * world
    frames = MESH_FRAMES[:n_rows]
    gen = torch.Generator().manual_seed(SEED + 60)
    spec = torch.rand(n_rows, BUCKET, cfg.spec_channels, generator=gen)
    for i, n in enumerate(frames):
        spec[i, n:] = 0.0
    lens = torch.tensor(frames)
    g_src = torch.randn(n_rows, 1, cfg.gin_channels, generator=gen) * 0.1
    g_tgt = torch.randn(n_rows, 1, cfg.gin_channels, generator=gen) * 0.1
    noise = torch.randn(n_rows, BUCKET, cfg.inter_channels, generator=gen)
    rows = slice(4 * rank, 4 * rank + 4)
    replicas = make_replicas(model, {dev}, fast=True)  # its graph replays from the second round on
    cache = replicas[dev].dec_cache
    with torch.inference_mode():
        ref = S.voice_conversion(model, *(a.to(dev) for a in (spec, lens, g_src, g_tgt)), 0.3, noise.to(dev),
                                 fast=True, dec_cache=cache)[0]

        def dp_round():
            args = [make_global_batch(a[rows], mesh) for a in (spec, lens, g_src, g_tgt, noise)]
            return data_parallel_convert(model, mesh, *args[:4], 0.3, args[4], fast=True, replicas=replicas)

        dp_round()
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        got = dp_round()
        torch.cuda.synchronize()
        out["convert_round_ms"] = (time.perf_counter() - t0) * 1e3
        out["convert_round_launches"] = launch_counts()
        whole = got.gather()
    check(out["convert_round_launches"] == {"stft_magnitude": 0, "wn_stack": 1, "coupling_block": 2, "mrf_stage": 2,
                                            "tail_stage": 2}, f"a rank's round launched {out['convert_round_launches']}")
    peak = float(ref.abs().max())
    out["convert_round_max_over_peak"] = float((whole - ref).abs().max()) / peak
    check(out["convert_round_max_over_peak"] <= FAST_VS_F32_TOL, "the data-parallel round strays from one process")
    if world == 1:
        torch.distributed.destroy_process_group()
        print("child-result " + json.dumps(out), flush=True)
        return 0

    # one data-parallel GAN step at full width, B = 8 (4 a rank), against
    # the one-process step on the whole batch: in f64 the losses and every
    # gradient leaf each update applies; in f32 a warm step's wall
    b_tr = TRAIN_BATCH
    tr = torch.Generator().manual_seed(SEED + 61)
    tr_spec = torch.rand(b_tr, TRAIN_SEGMENT, cfg.spec_channels, generator=tr, dtype=torch.float64)
    tr_audio = torch.randn(b_tr, TRAIN_SEGMENT * cfg.hop_length, generator=tr, dtype=torch.float64) * 0.1
    tr_len = torch.tensor([TRAIN_SEGMENT - (7 * i) % 40 for i in range(b_tr)])
    tr_g = torch.randn(b_tr, 1, cfg.gin_channels, generator=tr, dtype=torch.float64) * 0.1
    mine = slice(rank * b_tr // world, (rank + 1) * b_tr // world)
    seen, apply = [], T._apply_grads

    def record(state, grads, lr):
        seen.append([g.detach().clone() for g in grads])
        apply(state, grads, lr)

    def gan_step(dtype, dp: bool):
        state = T.init_gan_train_state(cfg, torch.Generator().manual_seed(SEED + 62), 2e-4, dev)
        for part in state:
            part.model.to(dtype)
        args = [a if a.dtype == torch.int64 else a.to(dtype) for a in (tr_spec, tr_audio, tr_len, tr_g)]
        draws = torch.Generator().manual_seed(SEED + 63)
        if dp:
            args = [make_global_batch(a[mine], mesh) for a in args]
            return state, lambda: T.gan_train_step(state, cfg, *args, draws, lr=2e-4, mesh=mesh)[1]
        args = [a.to(dev) for a in args]
        state.graphs.enabled = False  # the reference: each update recorded as it runs, eager
        return state, lambda: T.gan_train_step(state, cfg, *args, draws, lr=2e-4)[1]

    T._apply_grads = record
    try:
        runs = []
        for dp in (True, False):
            seen.clear()
            _, step = gan_step(torch.float64, dp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = {k: float(v) for k, v in step().items()}
            torch.cuda.synchronize()
            runs.append((metrics, [list(s) for s in seen], (time.perf_counter() - t0) * 1e3))
    finally:
        T._apply_grads = apply
    (m_dp, g_dp, ms_dp), (m_ref, g_ref, _) = runs
    worst = 0.0
    for k in m_ref:
        check(abs(m_dp[k] - m_ref[k]) <= TRAIN_GRAD_F64_TOL * max(1.0, abs(m_ref[k])), f"metric {k}")
    check(len(g_dp) == len(g_ref) == 2, "the GAN step applies two updates")
    for a_list, r_list in zip(g_dp, g_ref):
        for a, r in zip(a_list, r_list):
            peak = float(r.abs().max())
            err = float((a - r).abs().max())
            worst = max(worst, err / peak if peak else err)
            check(err <= TRAIN_GRAD_F64_TOL * peak or err == 0.0, "a data-parallel gradient leaf strays in f64")
    out["gan_f64"] = {"metrics": m_dp, "worst_leaf_over_peak": worst, "step_ms": ms_dp}
    _, step32 = gan_step(torch.float32, True)
    step32()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step32()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["gan_f32_step_ms"] = statistics.median(walls)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("child-result " + json.dumps(out), flush=True)
    return 0


def mesh_tier_phase(tc, ses: dict, tmp: str, smi: str) -> dict:
    t0 = time.perf_counter()
    formats = audio_formats_phase(tc, ses, tmp, smi)
    one = mesh_phase(tc, ses, smi)
    two = two_rank_phase(smi)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return {"formats": formats, "one_process": one, "two_process": two}


# -- phase 11: the CLI and the elastic tier ------------------------------------------

ELASTIC_SEED = SEED + 70
ELASTIC_DEVICE = "cuda:0"    # every process of phase 11 (NCCL refuses two ranks on one device: gloo)
ELASTIC_HEARTBEAT_S = 60.0   # a dead gloo peer makes the survivor's collective raise at once
ELASTIC_TIMEOUT_S = 300.0    # one sub-phase's worlds, every attempt (each child is stopped by then)
ELASTIC_FRAMES = [300, 240, 180, 120, 260, 200, 160, 100]  # 11c's and 11e's requests
ELASTIC_TRAIN_STEPS = 8
# 11b: rank 1 sits out the first round; frames 861/700 take bucket 1024, then 512
ROUND_FRAMES = [861, 700, 512, 430, 300]
ROUND_IDS = {0: [[0, 1], [2]], 1: [[], [3, 4]]}
ROUND_LAUNCHES = {"stft_magnitude": 0, "wn_stack": 1, "coupling_block": 2, "mrf_stage": 2, "tail_stage": 2}


def self_argv() -> list[str]:
    """How this script starts one of its own child processes."""
    return [sys.executable, os.path.abspath(__file__)]


def config_json(cfg, path: str) -> None:
    """`cfg` as a reference-format config.json (what ``--config`` reads)."""
    import dataclasses

    data_keys = ("sampling_rate", "filter_length", "hop_length", "win_length", "n_speakers", "add_blank")
    fields = dataclasses.asdict(cfg)
    model = {k: v for k, v in fields.items() if k not in data_keys + ("n_vocab", "spec_channels")}
    with open(path, "w") as f:
        json.dump({"_version_": "v2" if cfg.zero_g else "v1", "data": {k: fields[k] for k in data_keys},
                   "model": model}, f)


def elastic_model():
    """Phase 11's full-width V2 converter on the CPU: seeded random weights,
    the flow's posts seeded, conv_post ×100 (as `louder`: the audio stands
    well above the parity bar and the int16 wire's step)."""
    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch.models import synthesizer as S

    model = S.init_synthesizer(cfg, torch.Generator().manual_seed(ELASTIC_SEED)).eval()
    seed_flow_posts(model, ELASTIC_SEED + 1)
    with torch.no_grad():
        model.dec.conv_post.weight.mul_(100.0)
    return model


def elastic_requests(frames: list[int], seed: int) -> list[dict]:
    """Spectrogram-mode requests as the WorkLog stores them."""
    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg

    rng = np.random.default_rng(seed)
    return [{"spec": (np.abs(rng.standard_normal((nf, cfg.spec_channels))) * 0.3).astype(np.float32),
             "n_frames": nf, "g_src": (rng.standard_normal(cfg.gin_channels) * 0.1).astype(np.float32),
             "g_tgt": (rng.standard_normal(cfg.gin_channels) * 0.1).astype(np.float32), "tau": 0.3,
             "seed": seed * 100 + i} for i, nf in enumerate(frames)]


def one_process_truth(model, req: dict, fast: bool = False, cache=None):
    """One request converted alone on the model's device, in its own
    bucket, with the distributed service's noise (its live frames from
    ``default_rng(seed)``) → audio [n_frames · upsample] on the host."""
    import torch

    from openvoice_tpu_torch.models import synthesizer as S
    from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket

    cfg = model.cfg
    dev = next(model.parameters()).device
    nf = int(req["n_frames"])
    bucket = round_up_to_bucket(nf)
    spec = np.zeros((1, bucket, cfg.spec_channels), np.float32)
    spec[0, :nf] = req["spec"]
    noise = np.zeros((1, bucket, cfg.inter_channels), np.float32)
    noise[0, :nf] = np.random.default_rng(int(req["seed"])).standard_normal((nf, cfg.inter_channels))
    g_src, g_tgt = (torch.from_numpy(np.asarray(req[k], np.float32).reshape(1, 1, -1)).to(dev)
                    for k in ("g_src", "g_tgt"))
    with torch.inference_mode():
        audio, _ = S.voice_conversion(model, torch.from_numpy(spec).to(dev), torch.tensor([nf], device=dev), g_src,
                                      g_tgt, float(req["tau"]), torch.from_numpy(noise).to(dev), fast=fast,
                                      dec_cache=cache)
    return audio[0, : nf * cfg.upsample_factor, 0].float().cpu().numpy()


def parity_close(label: str, out: np.ndarray, ref: np.ndarray) -> float:
    """f32 against f32 on the card: within the port's parity-mode audio bar."""
    check(out.shape == ref.shape and bool(np.isfinite(out).all()), f"{label}: shape {out.shape} vs {ref.shape}")
    err = float(np.abs(out - ref).max())
    check(err <= CPU_AUDIO_TOL, f"{label}: max |diff| {err:.3e} over the bar {CPU_AUDIO_TOL} (peak "
                                f"{float(np.abs(ref).max()):.4f})")
    return err


def write_reference_pth(model, path: str) -> None:
    """The model as a reference training script saves it: the WaveNets',
    upsamples' and resblocks' convs weight-normed as (weight_g, weight_v),
    beside an iteration count and a numpy learning rate."""
    import torch

    sd = {}
    gen = torch.Generator().manual_seed(ELASTIC_SEED + 2)
    for key, value in model.state_dict().items():
        normed = ".enc." in key or key.startswith(("dec.ups.", "dec.resblocks."))
        if normed and key.endswith(".weight") and value.any():
            v = value * (1.0 + torch.rand(value.shape[0], 1, 1, generator=gen))
            prefix = key[: -len(".weight")]
            sd[prefix + ".weight_g"] = torch.sqrt(torch.sum(value * value, dim=(1, 2), keepdim=True))
            sd[prefix + ".weight_v"] = v
        else:
            sd[key] = value.clone()
    torch.save({"model": sd, "iteration": 1000, "learning_rate": np.float64(2e-4)}, path)


def cli_phase(tmp: str, smi: str) -> dict:
    """11a: the CLI in process, then its server as a process."""
    import signal
    import threading
    import urllib.request

    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch import ToneColorConverter, tools
    from openvoice_tpu_torch.audio.io import load_audio, write_wav
    from openvoice_tpu_torch.ckpt import native_io as CIO

    phase("11a. CLI: convert-ckpt of a reference-format .pth (weight norm, a numpy scalar) → extract-se "
          "--device cuda:0 (K5) → serve --ckpt <converted dir> --port 0 as a process, one /convert against convert()")
    t0 = time.perf_counter()
    model = elastic_model()
    pth, conv_dir = os.path.join(tmp, "reference.pth"), os.path.join(tmp, "converted")
    config = os.path.join(tmp, "config.json")
    config_json(cfg, config)
    write_reference_pth(model, pth)
    check(tools.main(["convert-ckpt", pth, conv_dir, "--config", config, "--device", ELASTIC_DEVICE]) == 0,
          "convert-ckpt")
    back = CIO.load_checkpoint(conv_dir)["model"]
    fold = max(float((back[k] - v).abs().max() / max(float(v.abs().max()), 1e-30))
               for k, v in model.state_dict().items())
    print(f"convert-ckpt: {len(back)} tensors; weight norm folded back to the model's weights within {fold:.2e} of "
          "each tensor's peak")
    check(set(back) == set(model.state_dict()) and fold <= 1e-6, "the converted weights are not the model's")

    wav, se_path = os.path.join(tmp, "cli_src.wav"), os.path.join(tmp, "cli_se.npy")
    write_wav(wav, serve_clip(4.0, 150.0, seed=71), SR)
    torch.cuda.synchronize()
    zero_launch_counts()
    check(tools.main(["extract-se", wav, "--ckpt", pth, "--config", config, "--device", ELASTIC_DEVICE, "--no-vad",
                      "--out", se_path]) == 0, "extract-se")
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"extract-se launches: {launches}")
    check(launches["stft_magnitude"] >= 1 and all(launches[k] == 0 for k in KERNEL_NAMES[1:]),
          f"extract-se launched {launches}")
    tc = ToneColorConverter(config_path=config, device=ELASTIC_DEVICE)
    check(tc.cfg == cfg, "config.json does not give back the model's config")
    check(tc.load_ckpt(pth) == {"missing": [], "unexpected": []}, "the reference .pth reports keys")
    se_cli, se_ref = np.load(se_path), tc.extract_se_from_file(wav, vad=False)
    check(se_cli.shape == (1, cfg.gin_channels, 1) and float(np.abs(se_cli - se_ref).max()) <= SE_TOL,
          "extract-se disagrees with extract_se_from_file")
    tgt = (np.random.default_rng(72).standard_normal(cfg.gin_channels) * 0.1).astype(np.float32)

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-m", "openvoice_tpu_torch.tools", "serve", "--ckpt", conv_dir,
                             "--config", config, "--device", ELASTIC_DEVICE, "--port", "0"], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    ready = threading.Event()

    def read() -> None:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving on"):
                ready.set()
        ready.set()

    threading.Thread(target=read, daemon=True).start()
    try:
        check(ready.wait(CHILD_TIMEOUT_S) and lines and lines[-1].startswith("serving on"),
              "serve did not start:\n" + "\n".join(lines))
        url = lines[-1].split()[-1]
        t1 = time.perf_counter()
        body = json.dumps({"audio_path": wav, "src_se": se_ref.reshape(-1).tolist(), "tgt_se": tgt.tolist(),
                           "tau": 0.0}).encode()
        req = urllib.request.Request(url + "/convert", data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            resp = json.loads(r.read())
        served = np.frombuffer(base64.b64decode(resp["audio_b64"]), np.float32)
        post_s = time.perf_counter() - t1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"serve exited {proc.returncode} on SIGTERM:\n" + "\n".join(lines))
    direct = tc.convert(load_audio(wav, sr=SR)[0], se_ref, tgt, tau=0.0)
    same_path("11a serve --ckpt <dir> /convert against convert(tau=0) of the .pth", served, direct, lsb=WIRE_LSB)
    wall = time.perf_counter() - t0
    print(f"11a: {wall:.1f} s (the /convert round trip {post_s:.3f} s)  [{smi}]")
    return {"wall_s": wall, "launches_extract_se": launches, "post_s": post_s}


def round_child(addr: str, rank: int) -> int:
    """One rank of 11b (``chip_smoke.py --elastic-child round``)."""
    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch.runtime import multihost as MH
    from openvoice_tpu_torch.runtime.elastic import dist_request
    from openvoice_tpu_torch.serve import distributed as D

    MH.initialize(addr, 2, rank, device=ELASTIC_DEVICE, backend="gloo", timeout_s=CHILD_TIMEOUT_S)
    mesh = MH.global_mesh(model_parallel=1)
    svc = D.DistributedConvertService(elastic_model(), cfg, mesh, fast=True, device=ELASTIC_DEVICE)
    rep = next(iter(svc.replicas.values()))
    model, cache = rep.model, rep.dec_cache
    reqs = elastic_requests(ROUND_FRAMES, seed=73)
    captured = []
    real = D.data_parallel_convert

    def capture(*args, **kwargs):
        captured.append(real(*args, **kwargs))
        return captured[-1]

    D.data_parallel_convert = capture
    out: dict = {"rank": rank, "rounds": []}
    for ids in ROUND_IDS[rank]:
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        outs = svc.convert_round([dist_request(reqs[i]) for i in ids])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        check(launches == ROUND_LAUNCHES, f"rank {rank}: a round launched {launches}")
        rows = captured[-1].local()[..., 0]
        pad_max = float(rows[len(ids):].abs().max()) if rows.shape[0] > len(ids) else 0.0
        check(pad_max == 0.0, f"rank {rank}: a row of length 0 came out {pad_max}")
        worst = 0.0
        for i, got in zip(ids, outs):
            ref = one_process_truth(model, reqs[i], fast=True, cache=cache)
            check(got.shape == ref.shape, f"request {i}: shape {got.shape} vs {ref.shape}")
            worst = max(worst, float(np.abs(got - ref).max()) / float(np.abs(ref).max()))
        check(worst <= FAST_VS_F32_TOL, f"rank {rank}: a request strays {worst} of its peak from one process")
        out["rounds"].append({"requests": ids, "rows": int(rows.shape[0]),
                              "bucket": int(captured[-1].shape[1]) // cfg.upsample_factor, "wall_ms": wall_ms,
                              "launches": launches, "max_over_peak": worst, "padded_rows_max": pad_max})
    # each round again: every position's rows replay the graph the round's
    # first call captured, with the eager launches, bit-equal to the round
    # with the replicas' graphs off; both ranks make the same calls
    out["replays"] = []
    for ids in ROUND_IDS[rank]:
        reqs_i = [dist_request(reqs[i]) for i in ids]
        before = graph_state(rep.graphs)
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        got = svc.convert_round(reqs_i)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        expect_replay(f"rank {rank}, round {ids} again", rep.graphs, before, 1)
        check(launches == ROUND_LAUNCHES, f"rank {rank}: a replayed round launched {launches}")
        for r in svc.replicas.values():
            r.graphs.enabled = False
        try:
            t0 = time.perf_counter()
            want = svc.convert_round(reqs_i)
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for r in svc.replicas.values():
                r.graphs.enabled = True
        for i, a, b in zip(ids, got, want):
            same_bits(f"rank {rank}, request {i}: the replayed round against the round eager", a, b)
        out["replays"].append({"requests": ids, "replay_ms": replay_ms, "eager_ms": eager_ms,
                               "launches": launches})
    out["graphs"] = graph_state(rep.graphs)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("child-result " + json.dumps(out), flush=True)
    return 0


def spawn_elastic_round(timeout_s: float = CHILD_TIMEOUT_S) -> list[dict]:
    """The two ranks of 11b; every child is stopped before this returns."""
    addr = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([*self_argv(), "--elastic-child", "round", addr, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [""] * 2
    try:
        deadline = time.time() + timeout_s
        for r, p in enumerate(procs):
            outs[r], _ = p.communicate(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if not line.startswith("child-result "):
                print(f"  [rank {r}] {line}")
        lines = [ln for ln in out.splitlines() if ln.startswith("child-result ")]
        check(p.returncode == 0 and len(lines) == 1, f"11b rank {r} failed (exit {p.returncode})")
        results.append(json.loads(lines[0][len("child-result "):]))
    return results


def distributed_phase(smi: str) -> dict:
    """11b: two ranks of DistributedConvertService(fast=True) on cuda:0."""
    phase("11b. DistributedConvertService(fast=True), two ranks on cuda:0 over gloo, V2 full width: two rounds, "
          "rank 1 passes [] in the first; K1 1, K2 2, K3 2, K4 2 a rank a round; each request against one process")
    t0 = time.perf_counter()
    ranks = spawn_elastic_round()
    for r in ranks:
        for rnd in r["rounds"]:
            print(f"rank {r['rank']}: requests {rnd['requests']}, {rnd['rows']} rows at bucket {rnd['bucket']}, "
                  f"{rnd['wall_ms']:.1f} ms, max |diff| {rnd['max_over_peak']:.2e} of the peak, padded rows "
                  f"max {rnd['padded_rows_max']}, launches {rnd['launches']}  [{smi}]")
        for rnd in r["replays"]:
            print(f"rank {r['rank']}: requests {rnd['requests']} again: as replays {rnd['replay_ms']:.1f} ms, eager "
                  f"{rnd['eager_ms']:.1f} ms, launches {rnd['launches']} (bit-equal)  [{smi}]")
        print(f"rank {r['rank']}: its replica's graphs {r['graphs']}")
    wall = time.perf_counter() - t0
    print(f"11b: {wall:.1f} s")
    return {"wall_s": wall, "ranks": ranks}


def elastic_child(mode: str, args: list[str]) -> int:
    """One worker of 11c-11e (``chip_smoke.py --elastic-child worker|train|live
    <dir> <coordinator|none> <world> <pid> [die_spec] [data_root]``), on cuda:0
    over gloo.  It writes its pid to ``<dir>/pid.<pid>`` first, so that the
    smoke run can kill it."""
    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch.runtime.elastic import train_worker_main, worker_main
    from openvoice_tpu_torch.serve.elastic_live import live_worker_main

    if mode == "round":
        return round_child(args[0], int(args[1]))
    state, coord, world, pid = args[0], None if args[1] == "none" else args[1], int(args[2]), int(args[3])
    os.makedirs(state, exist_ok=True)
    with open(os.path.join(state, f"pid.{pid}"), "w") as f:
        f.write(str(os.getpid()))
    die = None
    if len(args) > 4 and args[4] != "none":
        die_pid, n, marker = args[4].split(":", 2)
        if pid == int(die_pid) and not os.path.exists(marker):
            open(marker, "w").close()
            die = int(n)
    kw = dict(coordinator=coord, num_processes=world, process_id=pid, heartbeat_timeout_s=ELASTIC_HEARTBEAT_S,
              device=ELASTIC_DEVICE, backend="gloo")
    if mode == "worker":
        worker_main(state, cfg, max_batch=2, round_sleep_s=1.0, die_after_round=die, **kw)
    elif mode == "train":
        train_worker_main(args[5], state, cfg, steps=ELASTIC_TRAIN_STEPS, batch_size=4, segment_frames=TRAIN_SEGMENT,
                          ckpt_every=4, adversarial=False, die_after_step=die, **kw)
    elif mode == "live":
        live_worker_main(state, cfg, max_batch=2, die_after_done=die, **kw)
    else:
        raise SmokeFailure(f"unknown elastic child {mode}")
    return 0


def elastic_cmd(mode: str, state: str, *extra: str):
    def cmd(coordinator, world, pid):
        return [*self_argv(), "--elastic-child", mode, state, coordinator or "none", str(world), str(pid), *extra]
    return cmd


def print_history(sup) -> None:
    for n, h in enumerate(sup.history):
        print(f"  attempt {n + 1}: world {h['world']}, exit codes {h['rcs']}")
        for pid, text in enumerate(h["outs"]):
            for line in text.strip().splitlines()[-3:]:
                print(f"    [{pid}] {line}")


def elastic_convert_phase(tmp: str, smi: str) -> dict:
    """11c: a Supervisor's world of 2 loses a worker to SIGKILL mid-stream."""
    import threading

    import torch

    from openvoice_tpu_torch.runtime.elastic import EX_TEMPFAIL, Supervisor, WorkLog

    phase("11c. elastic convert: Supervisor, 2 workers on cuda:0 (f32, gloo), 8 requests; worker 1 SIGKILLed after "
          "the first done/ file; the shrunk world of 1 finishes; each result against one process")
    t0 = time.perf_counter()
    zero_launch_counts()
    state = os.path.join(tmp, "elastic")
    model = elastic_model()
    log = WorkLog(state)
    log.write_params(model)
    reqs = elastic_requests(ELASTIC_FRAMES, seed=74)
    log.write_requests(reqs)
    sup = Supervisor(state, elastic_cmd("worker", state), world=2, max_restarts=2)
    result: dict = {}
    runner = threading.Thread(target=lambda: result.update(ok=sup.run(timeout_s=ELASTIC_TIMEOUT_S)), daemon=True)
    runner.start()
    killed_at = None
    while runner.is_alive() and killed_at is None:
        if log.done_ids() and not sup.history and os.path.exists(os.path.join(state, "pid.1")):
            with open(os.path.join(state, "pid.1")) as f:
                os.kill(int(f.read()), 9)
            killed_at = len(log.done_ids())
        time.sleep(0.05)
    runner.join(ELASTIC_TIMEOUT_S + 30)
    print_history(sup)
    check(result.get("ok"), "the elastic convert did not finish")
    check(killed_at is not None, "no worker was killed")
    first = sup.history[0]
    check(first["world"] == 2 and first["rcs"][1] == -9 and first["rcs"][0] == EX_TEMPFAIL,
          f"attempt 1: {first['rcs']} (want [75, -9])")
    check([h["world"] for h in sup.history[1:]] == [1], f"worlds {[h['world'] for h in sup.history]}")
    model = model.to(ELASTIC_DEVICE)
    worst = max(parity_close(f"11c request {i}", log.load_result(i), one_process_truth(model, r))
                for i, r in enumerate(reqs))
    wall = time.perf_counter() - t0
    print(f"11c: killed worker 1 after {killed_at} done; worlds {[h['world'] for h in sup.history]}; "
          f"max |diff| against one process {worst:.3e} (bar {CPU_AUDIO_TOL}); launches here {launch_counts()} "
          f"(f32 spectrogram input: none); {wall:.1f} s  [{smi}]")
    del model
    torch.cuda.empty_cache()
    return {"wall_s": wall, "worlds": [h["world"] for h in sup.history], "killed_after_done": killed_at,
            "max_abs_err": worst}


def elastic_train_phase(tmp: str, smi: str) -> dict:
    """11d: a TrainSupervisor's world of 2 loses worker 1 after step 6."""
    import threading

    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch.ckpt import native_io as CIO
    from openvoice_tpu_torch.runtime.elastic import EX_TEMPFAIL, TrainSupervisor
    from openvoice_tpu_torch.training import train as T

    phase(f"11d. elastic training: TrainSupervisor, 2 workers on cuda:0 (gloo), the mel/KL step at V2 full width, "
          f"B 4 a process, {ELASTIC_TRAIN_STEPS} steps, a checkpoint every 4; worker 1 dies after step 6; the "
          "relaunch resumes from step_4")
    t0 = time.perf_counter()
    zero_launch_counts()
    root, ckpt = os.path.join(tmp, "elastic_train_set"), os.path.join(tmp, "elastic_ckpt")
    write_train_set(root)
    marker = os.path.join(tmp, "elastic_train.marker")
    sup = TrainSupervisor(ckpt, ELASTIC_TRAIN_STEPS, elastic_cmd("train", ckpt, f"1:6:{marker}", root), world=2,
                          max_restarts=2)
    result: dict = {}
    runner = threading.Thread(target=lambda: result.update(ok=sup.run(timeout_s=ELASTIC_TIMEOUT_S)), daemon=True)
    runner.start()
    step4 = os.path.join(ckpt, "step_4", CIO.STATE_FILE)
    while not sup.history and runner.is_alive():
        time.sleep(0.02)
    written = os.stat(step4).st_ino if os.path.exists(step4) else None
    runner.join(ELASTIC_TIMEOUT_S + 30)
    print_history(sup)
    check(result.get("ok"), "the elastic training did not reach its step")
    first = sup.history[0]
    check(os.path.exists(marker) and first["world"] == 2 and first["rcs"][1] == 9 and first["rcs"][0] == EX_TEMPFAIL,
          f"attempt 1: {first['rcs']} (want [75, 9])")
    check([h["world"] for h in sup.history[1:]] == [1], f"worlds {[h['world'] for h in sup.history]}")
    check(written is not None and os.stat(step4).st_ino == written, "the relaunch wrote step 4 again: no resume")
    check(CIO.latest_step(ckpt) == ELASTIC_TRAIN_STEPS, f"latest step {CIO.latest_step(ckpt)}")
    payload = CIO.load_checkpoint(os.path.join(ckpt, f"step_{ELASTIC_TRAIN_STEPS}"))
    state = T.init_train_state(cfg, torch.Generator().manual_seed(0), 0.0, ELASTIC_DEVICE)
    state.model.load_state_dict(payload["model"])
    rng = np.random.default_rng(75)
    spec = torch.from_numpy((np.abs(rng.standard_normal((2, 64, cfg.spec_channels))) * 0.3).astype(np.float32))
    audio = torch.from_numpy((rng.standard_normal((2, 64 * cfg.hop_length)) * 0.1).astype(np.float32))
    dev = ELASTIC_DEVICE
    _, metrics = T.train_step(state, cfg, spec.to(dev), audio.to(dev), torch.tensor([64, 50], device=dev),
                              torch.zeros(2, 1, cfg.gin_channels, device=dev), torch.Generator().manual_seed(5),
                              segment_frames=32, lr=0.0)
    losses = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(v) for v in losses.values()), f"step {ELASTIC_TRAIN_STEPS}'s probe loss {losses}")
    wall = time.perf_counter() - t0
    print(f"11d: worlds {[h['world'] for h in sup.history]}, resumed from step_4 to step "
          f"{CIO.latest_step(ckpt)}, probe loss {losses}; launches here {launch_counts()} (the train step: none); "
          f"{wall:.1f} s  [{smi}]")
    del state
    torch.cuda.empty_cache()
    return {"wall_s": wall, "worlds": [h["world"] for h in sup.history], "probe_loss": losses}


def live_phase(tmp: str, smi: str) -> dict:
    """11e: LiveSupervisor + serve_elastic, a worker dies after 2 done."""
    import threading
    import urllib.request

    import torch

    from openvoice_tpu_torch import V2_CONVERTER_CONFIG as cfg
    from openvoice_tpu_torch.serve.elastic_live import ElasticConvertClient, LiveSupervisor, LiveWorkLog, serve_elastic

    phase("11e. live elastic serving: LiveSupervisor (2 workers on cuda:0, f32, gloo) + serve_elastic, 8 requests "
          "over HTTP one every 0.4 s; worker 1 dies after 2 done; every answer against one process")
    t0 = time.perf_counter()
    zero_launch_counts()
    state = os.path.join(tmp, "live")
    model = elastic_model()
    log = LiveWorkLog(state)
    log.write_params(model)
    marker = os.path.join(tmp, "live.marker")
    sup = LiveSupervisor(state, elastic_cmd("live", state, f"1:2:{marker}"), world=2, max_restarts=2)
    result: dict = {}
    runner = threading.Thread(target=lambda: result.update(ok=sup.run(timeout_s=ELASTIC_TIMEOUT_S)), daemon=True)
    runner.start()
    httpd = serve_elastic(ElasticConvertClient(state, cfg))
    port = httpd.server_address[1]
    reqs = elastic_requests(ELASTIC_FRAMES, seed=76)
    answers: list = [None] * len(reqs)
    errors: list = []
    latency: list = [None] * len(reqs)

    def post(i: int) -> None:
        r = reqs[i]
        body = json.dumps({"spec_b64": base64.b64encode(r["spec"].tobytes()).decode(), "n_frames": r["n_frames"],
                           "src_se": r["g_src"].tolist(), "tgt_se": r["g_tgt"].tolist(), "tau": r["tau"],
                           "seed": r["seed"], "timeout": ELASTIC_TIMEOUT_S}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/convert", data=body,
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=ELASTIC_TIMEOUT_S + 10) as resp:
                answers[i] = np.frombuffer(base64.b64decode(json.loads(resp.read())["audio_b64"]), np.float32)
            latency[i] = time.perf_counter() - t
        except Exception as exc:  # noqa: BLE001 — reported by the check below
            errors.append((i, repr(exc)))

    threads = []
    try:
        for i in range(len(reqs)):
            th = threading.Thread(target=post, args=(i,), daemon=True)
            th.start()
            threads.append(th)
            time.sleep(0.4)
        for th in threads:
            th.join(ELASTIC_TIMEOUT_S + 20)
    finally:
        log.signal_stop()
        runner.join(ELASTIC_TIMEOUT_S + 30)
        httpd.shutdown()
    print_history(sup)
    check(not errors, f"requests failed: {errors}")
    check(result.get("ok"), "the live world did not drain")
    check(os.path.exists(marker), "the injected death never fired")
    check([h["world"] for h in sup.history] == [2, 1], f"worlds {[h['world'] for h in sup.history]}")
    model = model.to(ELASTIC_DEVICE)
    worst = max(parity_close(f"11e request {i}", answers[i], one_process_truth(model, r)) for i, r in enumerate(reqs))
    wall = time.perf_counter() - t0
    print(f"11e: worlds {[h['world'] for h in sup.history]}, request latency s "
          f"{[round(x, 3) for x in latency]}, max |diff| against one process {worst:.3e} (bar {CPU_AUDIO_TOL}); "
          f"launches here {launch_counts()} (f32 spectrogram input: none); {wall:.1f} s  [{smi}]")
    del model
    torch.cuda.empty_cache()
    return {"wall_s": wall, "worlds": [h["world"] for h in sup.history], "max_abs_err": worst,
            "latency_s": latency}


def kill_children() -> list[int]:
    """SIGKILL every process this one started that still runs (a failed
    sub-phase can leave a supervisor's workers behind); returns their pids."""
    me, left = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue  # gone, or not readable
        if ppid == me:
            left.append(int(entry))
            try:
                os.kill(int(entry), 9)
            except ProcessLookupError:
                pass
    return left


def elastic_tier_phase(tmp: str, smi: str) -> dict:
    t0 = time.perf_counter()
    try:
        out = {"cli": cli_phase(tmp, smi), "distributed": distributed_phase(smi),
               "elastic_convert": elastic_convert_phase(tmp, smi), "elastic_train": elastic_train_phase(tmp, smi),
               "live": live_phase(tmp, smi)}
    finally:
        left = kill_children()
        if left:
            print(f"phase 11: killed child processes still running: {left}")
    check(not left, "phase 11 left child processes running")
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 11: {out['wall_s']:.1f} s")
    return out


# -- phase 12: the installed port -----------------------------------------------------

INSTALLED_SEED = SEED + 120
INSTALLED_F32_TOL = 1e-5  # of the peak: the same f32 demo from the installed copy and the repository's, one card
# each demo's launches from the installed copy, by the counters (what the earlier phases count for the same calls:
# an extract_se batch or an f32 convert K5 1; a TTS decode group K2 1 (reverse), K3 2, K4 2)
INSTALLED_LAUNCHES = {
    "v2_conversion": {"stft_magnitude": 3},  # get_se of the source and of the reference, then convert (f32)
    "v1_tts": {"stft_magnitude": 3, "coupling_block": 1, "mrf_stage": 2, "tail_stage": 2},  # one sentence, one
    # serving-mode decode group; get_se of the TTS audio and of the reference, then convert (f32)
    "external_tts": {"stft_magnitude": 3},  # get_se of the reference, then one source: extract_se, convert (f32)
    "watermark_robustness": {},  # no model
    "extract-se": {"stft_magnitude": 1},
}
# fused_chain: each chain call (a frame group of tts_convert_batched, a token group of the single dispatch, a
# sentence of the stream, an overflow re-run) is one decode + STFT + serving convert (8c's "fused group")
FUSED_CALL_LAUNCHES = {"stft_magnitude": 1, "wn_stack": 1, "coupling_block": 3, "mrf_stage": 4, "tail_stage": 4}


def installed_argv(data: str) -> dict[str, list[str]]:
    """Each demo's arguments in phase 12 (no --device: the card is the
    default); outputs land under the working directory."""
    pth, config = os.path.join(data, "v2.pth"), os.path.join(data, "v2.json")
    src, ref = os.path.join(data, "source.wav"), os.path.join(data, "reference.flac")
    return {
        "v2_conversion": ["--ckpt", pth, "--config", config, "--source", src, "--reference", ref,
                          "--output", "outputs/v2.wav"],
        "v1_tts": ["--reference", ref, "--speed", "0.3", "--output", "outputs/v1.wav"],  # ~4 s for get_se
        "external_tts": ["--sources", src, "--reference", ref, "--outdir", "outputs/external"],
        "fused_chain": ["--converter-ckpt", pth, "--converter-config", config, "--output-dir", "outputs/fused"],
        "watermark_robustness": ["--audio", ref],
    }


def run_main(label: str, main_fn, argv: list[str]) -> dict:
    """``main_fn(argv)`` (a demo's or the CLI's) with the launch counters
    zeroed just before: its wall (the card synchronised at both ends) and
    launches."""
    import torch

    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    check(main_fn(argv) == 0, f"{label} failed")
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0, "launches": launch_counts()}


def run_demo(name: str, argv: list[str], cwd: str) -> dict:
    """`run_main` of one demo in a fresh directory ``cwd/name``, where its
    outputs and its SE cache (``processed/``) land."""
    import importlib

    main_fn = importlib.import_module(f"openvoice_tpu_torch.demos.{name}").main
    here = os.getcwd()
    os.makedirs(os.path.join(cwd, name))
    os.chdir(os.path.join(cwd, name))
    try:
        return run_main(f"demo {name}", main_fn, argv)
    finally:
        os.chdir(here)


def check_launches(label: str, got: dict, want: dict) -> None:
    expected = {k: want.get(k, 0) for k in KERNEL_NAMES}
    check(got == expected, f"{label} launched {got}, expected {expected}")


def fused_calls(label: str, got: dict) -> int:
    """The number n of chain calls whose launches `got` is, n·FUSED_CALL_LAUNCHES."""
    n = got["stft_magnitude"]
    check(n >= 4 and got == {k: n * v for k, v in FUSED_CALL_LAUNCHES.items()},
          f"{label}: {got} is not n ≥ 4 chain calls of {FUSED_CALL_LAUNCHES}")
    return n


def installed_child(site: str, data: str) -> int:
    """Phase 12's child: the port from `site` alone, in a fresh working
    directory; builds the kernels and the codec library there, runs each
    demo and extract-se, and prints one ``INSTALLED {...}`` line."""
    root = os.path.dirname(os.path.abspath(__file__))
    check(all(os.path.abspath(p or os.curdir) != root for p in sys.path), "the repository is on sys.path")
    import openvoice_tpu_torch
    from openvoice_tpu_torch import tools
    from openvoice_tpu_torch.audio import _native_build
    from openvoice_tpu_torch.ops import _nvcc

    package = os.path.join(site, "openvoice_tpu_torch")
    check(os.path.dirname(openvoice_tpu_torch.__file__) == package,
          f"openvoice_tpu_torch came from {openvoice_tpu_torch.__file__}, not {package}")
    build_dir = os.path.join(package, "csrc", "build")
    check(not os.path.exists(build_dir), f"{build_dir} exists before the first use")
    names = _nvcc.kernel_names()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:
        codec = pool.submit(_native_build.build, "ovt_audio")
        list(pool.map(_nvcc.build, names))
        codec.result()
    build_s = time.perf_counter() - t0
    libraries = sorted(os.listdir(build_dir))
    for path in [_nvcc.library_path(name) for name in names] + [_native_build.library_path("ovt_audio")]:
        check(path.exists() and str(path.parent) == build_dir, f"{path} was not built into {build_dir}")
    print(f"built {names} and libovt_audio from {package}'s own sources in {build_s:.2f} s: {libraries}")

    demos = {}
    for name, argv in installed_argv(data).items():
        with contextlib.redirect_stdout(io.StringIO()) as said:
            demos[name] = run_demo(name, argv, os.getcwd())
        print(said.getvalue().rstrip())
        print(f"{name}: {demos[name]['wall_s']:.2f} s, launches {demos[name]['launches']}", flush=True)
    for row in ("untouched", "PCM16 round-trip"):  # the watermark demo's table, on the FLAC clip
        check(f"{row:42s} OK  '@MyShell'" in said.getvalue().splitlines(), f"the watermark demo's {row!r} row failed")
    se_path = os.path.abspath("se_cli.npy")
    ref = os.path.join(data, "reference.flac")
    cli = ["extract-se", ref, "--config", os.path.join(data, "v2.json"), "--ckpt", os.path.join(data, "v2.pth")]
    demos["extract-se"] = run_main("extract-se", tools.main, [*cli, "--out", se_path])
    script = os.path.join(site, "bin", "openvoice-tpu-torch")
    t0 = time.perf_counter()
    out = subprocess.run([script, *cli, "--out", "se_script.npy"], capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S)
    check(out.returncode == 0, f"{script} exited {out.returncode}:\n{out.stdout}{out.stderr}")
    script_s = time.perf_counter() - t0
    se_diff = float(np.abs(np.load("se_script.npy") - np.load(se_path)).max())
    print(f"{script} extract-se: {script_s:.2f} s, its SE within {se_diff:.2e} of tools.main's")
    check(se_diff <= SE_TOL, "the installed command's SE disagrees with tools.main's")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("openvoice_tpu", "jax"))
    check(not loaded, f"the installed port loaded {loaded}")
    print("INSTALLED " + json.dumps({"build_s": build_s, "libraries": libraries, "demos": demos,
                                     "script_s": script_s, "script_se_diff": se_diff}), flush=True)
    return 0


def pip(*args: str, cwd: str | None = None) -> float:
    """``python -m pip <args>`` offline; returns its seconds."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pip", *args, "--no-index", "--disable-pip-version-check",
                          "--no-cache-dir", "-q"], cwd=cwd, capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"pip {args[0]} exited {out.returncode}:\n{out.stdout}{out.stderr}")
    return time.perf_counter() - t0


def installed_phase(tmp: str, smi: str) -> dict:
    """12: the port built as a wheel from a copy of the tree, installed with
    pip into a directory outside the repository, and driven there by a child
    process that sees only that directory: every demo and extract-se at full
    width; the launches against INSTALLED_LAUNCHES; v2_conversion's and
    fused_chain's outputs against the same demos on the repository's copy."""
    import shutil

    from openvoice_tpu_torch.audio.flac import write_flac
    from openvoice_tpu_torch.audio.io import load_audio, write_wav

    phase("12. the installed port: a wheel of the tree, pip install --target outside the repository, a child "
          "process with only that directory on its path builds K1-K5 and libovt_audio there and runs the five "
          "demos and extract-se at full width (V2 ckpt with conv_post ×100; V1 random)")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tree, site, data = (os.path.join(tmp, f"phase12_{d}") for d in ("tree", "site", "data"))
    os.makedirs(tree)
    for name in ("pyproject.toml", "README.md", "LICENSE"):
        shutil.copy(os.path.join(root, name), tree)
    for package in ("openvoice_tpu", "openvoice_tpu_torch"):
        shutil.copytree(os.path.join(root, package), os.path.join(tree, package),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
    wheel_s = pip("wheel", ".", "--no-deps", "--no-build-isolation", "-w", "dist", cwd=tree)
    (wheel,) = [os.path.join(tree, "dist", f) for f in os.listdir(os.path.join(tree, "dist"))]
    install_s = pip("install", "--no-deps", "--target", site, wheel)
    csrc = os.listdir(os.path.join(site, "openvoice_tpu_torch", "csrc"))
    print(f"wheel {os.path.basename(wheel)} ({os.path.getsize(wheel) / 1e6:.2f} MB) in {wheel_s:.2f} s, installed "
          f"in {install_s:.2f} s; csrc: {sorted(csrc)}")
    check(os.path.exists(os.path.join(site, "bin", "openvoice-tpu-torch")), "pip installed no openvoice-tpu-torch")

    os.makedirs(data)
    model = elastic_model()
    write_reference_pth(model, os.path.join(data, "v2.pth"))
    config_json(model.cfg, os.path.join(data, "v2.json"))
    write_wav(os.path.join(data, "source.wav"), voice(10.0, 140.0, seed=INSTALLED_SEED), SR)
    write_flac(os.path.join(data, "reference.flac"), voice(6.0, 220.0, seed=INSTALLED_SEED + 1), SR)

    child_cwd, repo_cwd = os.path.join(tmp, "phase12_child"), os.path.join(tmp, "phase12_repo")
    os.makedirs(child_cwd)
    env = {**os.environ, "PYTHONPATH": site, "PIP_DISABLE_PIP_VERSION_CHECK": "1"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-P", os.path.abspath(__file__), "--installed-child", site, data],
                          cwd=child_cwd, env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    print("\n".join("  | " + line for line in proc.stdout.splitlines() if not line.startswith("INSTALLED ")))
    check(proc.returncode == 0, f"the installed child exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    child = json.loads(next(line for line in proc.stdout.splitlines() if line.startswith("INSTALLED "))[10:])
    print(f"child process: {child_s:.1f} s, the libraries built in {child['build_s']:.2f} s  [{smi}]")

    for name, want in INSTALLED_LAUNCHES.items():
        check_launches(f"installed {name}", child["demos"][name]["launches"], want)
    n = fused_calls("installed fused_chain", child["demos"]["fused_chain"]["launches"])

    # the same two demos on the repository's copy, in this process, same card and weights
    argv = installed_argv(data)
    repo = {name: run_demo(name, argv[name], repo_cwd) for name in ("v2_conversion", "fused_chain")}
    check_launches("repository v2_conversion", repo["v2_conversion"]["launches"], INSTALLED_LAUNCHES["v2_conversion"])
    check(repo["fused_chain"]["launches"] == child["demos"]["fused_chain"]["launches"],
          f"fused_chain launched {repo['fused_chain']['launches']} from the repository, "
          f"{child['demos']['fused_chain']['launches']} installed")

    def wav(cwd: str, path: str) -> np.ndarray:
        return load_audio(os.path.join(cwd, path), sr=None)[0]

    agreement = {}
    for path, rel in (("v2_conversion/outputs/v2.wav", INSTALLED_F32_TOL),
                      ("fused_chain/outputs/fused/demo_chain_single.wav", FAST_CPU_TOL),
                      ("fused_chain/outputs/fused/demo_chain_stream.wav", FAST_CPU_TOL)):
        agreement[path] = same_path(f"installed against the repository, {path}", wav(child_cwd, path),
                                    wav(repo_cwd, path), rel=rel)
    wall = time.perf_counter() - t_phase
    walls = {name: round(d["wall_s"], 3) for name, d in child["demos"].items()}
    print(f"phase 12: {wall:.1f} s (wheel {wheel_s:.2f} s, install {install_s:.2f} s, child {child_s:.1f} s, build "
          f"{child['build_s']:.2f} s); demo walls installed {walls}, repository "
          f"{ {k: round(v['wall_s'], 3) for k, v in repo.items()} }; fused_chain {n} chain calls  [{smi}]")
    return {"wall_s": wall, "wheel_s": wheel_s, "install_s": install_s, "child_s": child_s, **child,
            "repo_walls": {k: v["wall_s"] for k, v in repo.items()}, "fused_calls": n, "agreement": agreement}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run needs a CUDA card", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are real f32
    torch.backends.cudnn.allow_tf32 = False

    if sys.argv[1:2] == ["--mesh-child"]:  # one rank of phase 10c, started by the smoke run itself
        addr, world, rank, backend = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
        return child_main(addr, world, rank, backend)
    if sys.argv[1:2] == ["--elastic-child"]:  # one process of phase 11b-11e, started by the smoke run itself
        return elastic_child(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--installed-child"]:  # phase 12's child, started by the smoke run itself
        return installed_child(sys.argv[2], sys.argv[3])
    smi, kind = toolchain()
    if sys.argv[1:] == ["--tf32-control"]:  # the train step runs no kernel of the port: nothing to build
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "train_set")
            write_train_set(root)
            phase("9.4 with a TF32 control: one B = 1 GAN step's gradients, card against CPU, three seeds")
            rows = [r for i in range(3) for r in train_card_vs_cpu(root, smi, SEED + 4 + 10 * i, True).values()]
        check(all(r["f64 card vs cpu, worst leaf"] <= TRAIN_GRAD_F64_TOL for r in rows),
              "card and CPU disagree on a gradient leaf in f64")
        check(all(r["f32 ratio"] <= TRAIN_GRAD_F32_RATIO for r in rows),
              "the card's f32 gradients stray from the CPU's by more than f32 rounding")
        check(all(r["tf32 ratio"] > TRAIN_GRAD_F32_RATIO for r in rows), "the f32 gradient bar let TF32 through")
        print(smi)
        return 0
    build()
    if sys.argv[1:2] == ["--sweep"]:
        with torch.inference_mode():
            sweep(kind, sys.argv[2:])
        print(smi)
        return 0
    if sys.argv[1:] == ["--elastic"]:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps({"elastic_tier": elastic_tier_phase(tmp, smi)}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--melo-tail"]:
        with torch.inference_mode():
            print(json.dumps({"k4_melo": tail_melo_check(torch.Generator().manual_seed(SEED + 3))}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--installed"]:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps({"installed": installed_phase(tmp, smi)}))
        print(smi)
        return 0
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    gen = torch.Generator().manual_seed(SEED + 2)
    with torch.inference_mode():
        kernels = [stft_check(kind)] + [fn(kind, gen) for fn in (wn_check, coupling_check, mrf_check, tail_check)]
        print(json.dumps({"k4_melo": tail_melo_check(gen)}))
    print_windows()
    _L2_FLUSH.clear()  # the converts' peak memory is theirs alone
    tc = converter()
    with tempfile.TemporaryDirectory() as tmp:
        _, ses, src, graphs_f32 = main_path(tc, tmp, smi)
        launches, graphs_fast = main_path_fast(tc, src, ses, smi)
        card_vs_cpu(tc, ses)
        t0 = time.perf_counter()
        v1 = v1_tts(smi)
        v1_conv = v1_convert(v1["audio"], tmp, smi)
        print(f"V1 phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        louder(tc)
        louder(v1_conv["conv"])
        serving = batcher_phase(tc, ses, smi)
        server_phase(v1["tts"], v1_conv["conv"], v1_conv["ses"], tmp, smi)
        fused = fused_phase(v1["tts"], v1_conv["conv"], v1_conv["ses"], smi)
        memory = streaming_phase(tc, ses, smi)
        print(f"serving-tier phase: {time.perf_counter() - t0:.1f} s")
        training = training_phase(tmp, smi, kind)
        mesh_tier = mesh_tier_phase(tc, ses, tmp, smi)
        elastic = elastic_tier_phase(tmp, smi)
        installed = installed_phase(tmp, smi)
    for k in kernels:
        name = k["name"]
        k["launches"] = launches[name]
        k["launches_per_tts_decode"] = v1["launches_per_decode"][name]
        k["launches_v1_convert"] = v1_conv["launches"][name]
        k["launches_batcher_group"] = serving["per_group"][name]  # K5: PCM groups only
        k["launches_fused_group"] = fused["per_group"][name]
        k["batcher_b8"] = serving["group_times"].get(name)
        k["launches_train_phase"] = training["launches"][name]  # the quality calls and the SE dataset: K5 only
        k["launches_audio_format_convert"] = mesh_tier["formats"]["launches"][name]  # the FLAC clip's convert, measured
        k["launches_mesh_batcher_shard"] = mesh_tier["one_process"]["per_shard"][name]  # K5: PCM groups only
        k["launches_2rank_round"] = mesh_tier["two_process"]["gloo"][0]["convert_round_launches"][name]  # a rank's
        k["launches_cli_extract_se"] = elastic["cli"]["launches_extract_se"][name]  # 11a, K5 only
        k["launches_dist_round"] = [rnd["launches"][name] for r in elastic["distributed"]["ranks"]
                                    for rnd in r["rounds"]]  # 11b: each rank's rounds, rank 0 first
        k["launches_installed"] = {demo: d["launches"][name] for demo, d in installed["demos"].items()}  # 12
        check(k["launches"] > 0, f"the serving path never launched {name}")
    print(json.dumps({"serving_tier": {"rates": serving["rates"], "worst": serving["worst"],
                                       "batchmates": serving["batchmates"], "busy": serving["busy"],
                                       "streaming_memory": memory}}))
    print(json.dumps({"graphs": {"card": smi, "convert_f32": graphs_f32, "convert_fast": graphs_fast,
                                 "tts": v1["walls_ms"], "batcher": serving["graphs"], "chains": fused["graphs"],
                                 "train": training["graphs"], "dp_convert": mesh_tier["one_process"]["dp_convert"],
                                 "mesh_batcher": mesh_tier["one_process"]["batcher_graphs"]}}))
    print(json.dumps({"training": {k: v for k, v in training.items() if k != "launches"}}))
    print(json.dumps({"mesh_tier": {"card": smi, "decode_ms": mesh_tier["formats"]["decode_ms"],
                                    "codecs": mesh_tier["formats"]["codecs"],
                                    "codec_agreement": mesh_tier["formats"]["agreement"],
                                    **mesh_tier["one_process"], **mesh_tier["two_process"]}}))

    print(json.dumps({"elastic_tier": {"card": smi, "wall_s": elastic["wall_s"],
                                       **{k: v for k, v in elastic.items() if k != "wall_s"}}}))
    print(json.dumps({"installed": {"card": smi, **installed}}))

    phase("7. result")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
