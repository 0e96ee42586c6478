"""Dynamic request batcher for conversion serving (the port of
``openvoice_tpu/serve/batcher.py``).

Requests queue up; on each scheduling tick the cost-optimal planner
(`runtime.bucketing.plan_groups`) partitions everything pending into
(bucket, padded batch) groups, and groups that are full or hold a request
past its deadline run as one batched call each; the rest wait for peers.
Rows padded up to an allowed batch size carry length 0, so every mask (and
every kernel's length rule) makes them inert.  Failures are isolated: a
malformed request fails its own future at `submit`, and a failed call fails
its own group's futures, never the batcher.

Two request modes, planned as separate pools:

* spec mode: the request carries its spectrogram; the noise is drawn on the
  host from ``np.random.default_rng(seed)`` at [bucket, inter], whose first
  n_frames rows are what ``ToneColorConverter.convert`` draws, so at
  ``tau > 0`` the result equals ``convert(seed)``;
* PCM mode: the request carries its waveform, uploaded as int16 samples; the
  STFT runs inside the batched call (the STFT kernel on the card), and the
  noise is drawn on the device from one ``torch.Generator(device)`` per row
  seeded with the request's seed.  That stream differs from the host one
  (and from the JAX package's ``jax.random.PRNGKey`` stream), so the same
  seed gives different, equally valid audio in the two modes at
  ``tau > 0``; both are deterministic per seed.

Results come back as int16 PCM (``round(clip(x)·32767)``) and are scaled to
float on the host.  The dispatch thread only enqueues device work: inputs go
up through pinned memory asynchronously, and a reader thread waits for each
group's copy back to host memory, so that one group's packing and readback
overlap another group's compute.

Spans (``runtime/profiler.py::trace``, recorded while a profiler runs):
``ov.batcher.plan`` (the planner over the pending pool), ``ov.batcher.pack``
(the host arrays, the PCM pad and round; its name carries the group's
number, rows, bucket and request ids), ``ov.noise``, ``convert_batch`` (the
enqueue of the group's call; its latency also goes into ``METRICS``) and, on
the reader thread, ``ov.batcher.readback`` (the wait for the copy) and
``ov.batcher.answer`` (the int16 → float step and the answers), both named
with the group's number.  Each dispatched group adds to ``METRICS``, under
one lock: ``batches``, ``busy_seconds``, ``queue_seconds`` (its requests'
waits from submit to dispatch), ``dispatched_requests``, ``true_frames``
(their frames) and ``dispatched_frames`` (bucket × padded rows, the rows
added for sharding included).

Each group runs as a replay of one CUDA graph per (mode, bucket, padded
batch, fast) from its second call of that shape on (``runtime/graphs.py``;
the JAX package's ``_jit_convert_pcm16`` and ``voice_conversion_jit``): the
int16 decode, the STFT, the conversion and the int16 wire encode.  Over a
mesh each data position's shard of a group replays its own graph, from the
`GraphCache` of its device's replica.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import traceback
from concurrent.futures import Future
from contextlib import nullcontext
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from openvoice_tpu_torch.api import resolve_device
from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.models import synthesizer as S
from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude
from openvoice_tpu_torch.runtime.bucketing import allowed_batch_sizes, plan_groups
from openvoice_tpu_torch.runtime.graphs import GraphKey
from openvoice_tpu_torch.runtime.mesh import Mesh
from openvoice_tpu_torch.runtime.parallel import make_replicas
from openvoice_tpu_torch.runtime.profiler import METRICS, trace


_REQUEST_IDS = itertools.count()


@dataclass
class ConvertRequest:
    spec: np.ndarray | None = None  # [n_frames, n_freq] true-length spectrogram (spec mode)
    n_frames: int = 0
    g_src: np.ndarray | None = None  # [gin]
    g_tgt: np.ndarray | None = None  # [gin]
    tau: float = 0.3
    seed: int = 0
    # PCM mode: the mono waveform at cfg.sampling_rate instead of a
    # spectrogram; n_frames is derived from it
    audio: np.ndarray | None = None
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.perf_counter)
    request_id: int = field(default_factory=_REQUEST_IDS.__next__)  # the process's, ties spans to requests


def _wire_int16(audio: torch.Tensor) -> torch.Tensor:
    """[B, T, 1] float audio → [B, T] int16 PCM, round half to even."""
    return torch.round(torch.clamp(audio[..., 0], -1.0, 1.0) * 32767.0).to(torch.int16)


def row_noise(seeds: list[int], frames: int, channels: int, device: torch.device) -> torch.Tensor:
    """The PCM mode's noise [B, frames, channels]: row i from
    ``torch.Generator(device)`` seeded with seeds[i]."""
    with trace("ov.noise"):
        return torch.stack([
            torch.randn(frames, channels, generator=torch.Generator(device).manual_seed(s), device=device)
            for s in seeds
        ])


def _convert_pcm16(model: S.Synthesizer, cfg: SynthesizerConfig, pcm: torch.Tensor, spec_lengths: torch.Tensor,
                   g_src: torch.Tensor, g_tgt: torch.Tensor, taus: torch.Tensor, seeds: list[int],
                   fast: bool = False, dec_cache: dict | None = None) -> torch.Tensor:
    """The PCM serving path as one batched call: int16 samples [B, L]
    (reflect-padded on the host) → STFT → per-row device noise → convert →
    int16 PCM [B, T·upsample]."""
    frames = (pcm.shape[1] - cfg.filter_length) // cfg.hop_length + 1
    noise = row_noise(seeds, frames, cfg.inter_channels, pcm.device)
    return group_body(model, cfg, fast, dec_cache, spec_lengths, g_src, g_tgt, taus, noise, pcm=pcm)


def group_body(model: S.Synthesizer, cfg: SynthesizerConfig, fast: bool, dec_cache: dict | None,
               lengths: torch.Tensor, g_src: torch.Tensor, g_tgt: torch.Tensor, taus: torch.Tensor,
               noise: torch.Tensor, pcm: torch.Tensor | None = None, spec: torch.Tensor | None = None) -> torch.Tensor:
    """One group's call, the body of its CUDA graph: from int16 samples
    [B, L] through the STFT (PCM mode, the JAX package's
    ``_jit_convert_pcm16``) or from a spectrogram [B, T, n_freq] (spec mode,
    its ``voice_conversion_jit``), the conversion with the rows' noise and
    taus [B, 1, 1], then the int16 wire → [B, T·upsample]."""
    if pcm is not None:
        spec = stft_magnitude(pcm.float() * (1.0 / 32767.0), cfg.filter_length, cfg.hop_length, cfg.win_length)
    audio, _ = S.voice_conversion(model, spec, lengths, g_src, g_tgt, taus, noise, fast=fast, dec_cache=dec_cache)
    return _wire_int16(audio)


def _wire_to_host(wire: torch.Tensor, host: torch.Tensor | None = None) -> tuple:
    """A group's (or a shard's) int16 wire → (host tensor, events that
    complete its copy), into `host` (rows of a pinned buffer) where given.
    On the card: an asynchronous copy into pinned memory, which the reader
    thread waits for while this thread goes on to the next group.  Where the
    wire is a graph's output, `GraphCache.run` calls this under the device's
    lock right after the replay, so the copy is queued in stream order before
    any other replay of the device's graph pool, which may reuse the wire's
    memory."""
    if wire.device.type != "cuda":
        return wire.clone(), []
    if host is None:
        host = torch.empty(wire.shape, dtype=torch.int16, pin_memory=True)
    host.copy_(wire, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, [done]


class ConvertBatcher:
    """Background thread batching voice-conversion requests by bucket, on
    one device or data-parallel over a mesh's data axis."""

    def __init__(self, model: S.Synthesizer, cfg: SynthesizerConfig, max_batch: int = 8,
                 max_wait_ms: float = 5.0, fast: bool = False, device: str | torch.device | None = None,
                 mesh: Mesh | None = None) -> None:
        """`model` moves to `device` (the GPU unless the caller passes
        ``device="cpu"``).  fast=True serves in the bf16 serving mode, with
        the packed weights made once here.

        mesh (a `runtime.mesh.Mesh`, instead of `device`): data-parallel
        serving from one batcher.  The weights, and in the serving mode the
        packed cache, are replicated once per data-axis device here; each
        dispatched group is split by rows over the data positions this
        process holds, its padded batch rounded up to a multiple of their
        count (padded rows carry length 0), and each position runs the same
        call on its own device.  The model axis, if any, replicates."""
        self.mesh = mesh
        if mesh is None:
            devices = [resolve_device(device)]
        else:
            if device is not None:
                raise ValueError("pass a device or a mesh, not both")
            by_data: dict[int, torch.device] = {}
            for coord in mesh.local_coords():
                by_data.setdefault(coord[0], mesh.devices[coord])
            devices = [by_data[d] for d in sorted(by_data)]
        self.device = devices[0]
        self.model = model.to(self.device).eval()
        self.replicas = make_replicas(self.model, devices, fast)  # the weights and graphs of each device
        self.dec_cache = self.replicas[self.device].dec_cache
        self.graphs = self.replicas[self.device].graphs  # the first data position's device's
        self._shards = devices  # one a data position
        self.cfg = cfg
        self.fast = fast
        self.max_batch = max_batch
        # largest batch size the planner can emit (the set plan_groups uses)
        self._full_batch = max(allowed_batch_sizes(max_batch))
        self.max_wait_s = max_wait_ms / 1e3
        self._q: queue.Queue[ConvertRequest | None] = queue.Queue()
        self._pending: list[ConvertRequest] = []
        # set once the dispatch thread has ended (stopped or failed): from
        # then on a submit fails at once instead of waiting for nobody
        self._lock = threading.Lock()
        self._closed: str | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        # the dispatch thread only enqueues device work; this one waits for
        # each group's device→host copy, so group i+1's compute overlaps
        # group i's readback
        self._readq: queue.Queue[tuple | None] = queue.Queue(maxsize=4)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._running = False
        self._groups = itertools.count()  # the number of each dispatched group, in its spans

    def start(self) -> None:
        self._running = True
        self._thread.start()
        self._reader.start()

    def stop(self) -> None:
        self._running = False
        self._q.put(None)
        self._thread.join(timeout=10)
        self._readq.put(None)
        self._reader.join(timeout=120)

    def submit(self, req: ConvertRequest) -> Future:
        """Queue `req`; a malformed request fails its own future here."""
        try:
            self._validate(req)
        except ValueError as exc:
            req.future.set_exception(exc)
            return req.future
        with self._lock:
            if self._closed is None:
                self._q.put(req)
                return req.future
        req.future.set_exception(RuntimeError(self._closed))
        return req.future

    def _validate(self, req: ConvertRequest) -> None:
        cfg = self.cfg
        for name in ("g_src", "g_tgt"):
            g = getattr(req, name)
            if g is None or np.asarray(g).size != cfg.gin_channels:
                raise ValueError(f"{name} must hold {cfg.gin_channels} values")
        if req.audio is not None:
            pad = (cfg.filter_length - cfg.hop_length) // 2
            n = len(req.audio)
            if n <= pad:
                raise ValueError(f"audio of {n} samples is too short for a {cfg.filter_length}-sample frame")
            if not req.n_frames:
                req.n_frames = (n + 2 * pad - cfg.filter_length) // cfg.hop_length + 1
        elif req.spec is None or np.shape(req.spec) != (req.n_frames, cfg.spec_channels) or req.n_frames < 1:
            raise ValueError(f"spec must be [n_frames ≥ 1, {cfg.spec_channels}], got {np.shape(req.spec)} "
                             f"with n_frames {req.n_frames}")

    # ------------------------------------------------------------------

    def _loop(self) -> None:
        try:
            # inference mode and the device are per thread: the caller's do
            # not carry over
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                self._schedule()
            reason = "batcher stopped"
        except Exception as exc:  # noqa: BLE001 — a dead thread must not leave a future hanging
            reason = f"batcher dispatch thread failed: {exc!r}"
        with self._lock:
            self._closed = reason
            waiting, self._pending = self._pending, []
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, ConvertRequest):
                    waiting.append(item)
        for r in waiting:
            if not r.future.done():
                r.future.set_exception(RuntimeError(reason))

    def _schedule(self) -> None:
        pending = self._pending
        while self._running:
            try:
                item = self._q.get(timeout=self.max_wait_s)
            except queue.Empty:
                item = "tick"
            if item is None:
                break
            if isinstance(item, ConvertRequest):
                pending.append(item)
            # drain whatever else already arrived before planning: one plan
            # per burst, not per request
            stop = False
            while True:
                try:
                    extra = self._q.get_nowait()
                except queue.Empty:
                    break
                if extra is None:
                    stop = True
                    break
                pending.append(extra)
            if stop:
                break

            now = time.perf_counter()
            if not pending:
                continue
            oldest_due = min(r.enqueued_at for r in pending) + self.max_wait_s <= now
            if len(pending) < self.max_batch and not oldest_due:
                continue
            keep: list[ConvertRequest] = []
            # PCM-mode and spec-mode requests run different calls, so they
            # are planned as separate pools
            for mode in ([r for r in pending if r.audio is not None],
                         [r for r in pending if r.audio is None]):
                if not mode:
                    continue
                with trace("ov.batcher.plan", args={"pending": len(mode)}):
                    plan = plan_groups([r.n_frames for r in mode], max_batch=self.max_batch)
                for idx, bucket, padded_batch in plan:
                    group = [mode[i] for i in idx]
                    full = len(group) >= self._full_batch
                    due = any(r.enqueued_at + self.max_wait_s <= now for r in group)
                    if full or due:
                        self._dispatch(bucket, group, padded_batch)
                    else:
                        keep.extend(group)
            pending[:] = keep

    def _dispatch(self, bucket: int, group: list[ConvertRequest], padded_batch: int) -> None:
        cfg = self.cfg
        t_dispatch = time.perf_counter()
        number = next(self._groups)
        try:
            n_shards = len(self._shards)
            n = -(-padded_batch // n_shards) * n_shards  # whole rows per data shard
            with trace("ov.batcher.pack", args={"group": number, "rows": n, "bucket": bucket,
                                                "requests": ",".join(str(r.request_id) for r in group)}):
                lengths = np.zeros(n, np.int64)  # padded rows stay length 0: fully masked
                g_src = np.zeros((n, 1, cfg.gin_channels), np.float32)
                g_tgt = np.zeros((n, 1, cfg.gin_channels), np.float32)
                taus = np.zeros((n, 1, 1), np.float32)
                for i, r in enumerate(group):
                    lengths[i] = r.n_frames
                    g_src[i, 0] = np.asarray(r.g_src, np.float32).reshape(-1)
                    g_tgt[i, 0] = np.asarray(r.g_tgt, np.float32).reshape(-1)
                    taus[i, 0, 0] = r.tau
                t0 = time.perf_counter()
                if group[0].audio is not None:
                    pad = (cfg.filter_length - cfg.hop_length) // 2
                    target = (bucket - 1) * cfg.hop_length + cfg.filter_length
                    pcm = np.zeros((n, target), np.int16)
                    seeds = [0] * n
                    for i, r in enumerate(group):
                        a = np.asarray(r.audio, np.float32)
                        padded = np.concatenate([a[1 : pad + 1][::-1], a, a[-pad - 1 : -1][::-1]])[:target]
                        pcm[i, : len(padded)] = np.round(np.clip(padded, -1.0, 1.0) * 32767.0).astype(np.int16)
                        seeds[i] = int(r.seed)
                else:
                    spec = np.zeros((n, bucket, cfg.spec_channels), np.float32)
                    noise = np.zeros((n, bucket, cfg.inter_channels), np.float32)
                    for i, r in enumerate(group):
                        spec[i, : r.n_frames] = r.spec
                        with trace("ov.noise"):
                            noise[i] = np.random.default_rng(r.seed).standard_normal(
                                (bucket, cfg.inter_channels)).astype(np.float32)
            per = n // n_shards
            host, events = None, []
            if self.device.type == "cuda":
                host = torch.empty((n, bucket * cfg.upsample_factor), dtype=torch.int16, pin_memory=True)
            wires = []
            with trace("convert_batch", METRICS):
                for k, dev in enumerate(self._shards):
                    rows = slice(k * per, (k + 1) * per)
                    inputs = {"lengths": lengths[rows], "g_src": g_src[rows], "g_tgt": g_tgt[rows],
                              "taus": taus[rows]}
                    # a kernel launches on the current device, which the tensors' device must be
                    with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                        if group[0].audio is not None:
                            noise_k = row_noise(seeds[rows], bucket, cfg.inter_channels, dev)
                            inputs.update(pcm=pcm[rows], noise=noise_k)
                        else:
                            inputs.update(spec=spec[rows], noise=noise[rows])
                        wire, done = self._run_group(bucket, inputs, k, None if host is None else host[rows])
                    wires.append(wire)
                    events += done
            if host is None:
                host = torch.cat(wires)
            METRICS.add_many({"busy_seconds": time.perf_counter() - t0, "batches": 1.0,
                              "queue_seconds": sum(t_dispatch - r.enqueued_at for r in group),
                              "dispatched_requests": float(len(group)),
                              "true_frames": float(sum(r.n_frames for r in group)),
                              "dispatched_frames": float(bucket * n)})
            self._readq.put((host, events, group, number))
        except Exception as exc:  # noqa: BLE001 — a failed call fails its group only
            tb = traceback.format_exc()
            for r in group:
                if not r.future.done():
                    r.future.set_exception(RuntimeError(f"batch failed: {exc}\n{tb}"))
            METRICS.add("batch_failures")

    def _run_group(self, bucket: int, inputs: dict, shard: int = 0, host: torch.Tensor | None = None) -> tuple:
        """One data position's rows of a group (`group_body`'s inputs by
        name) through the graphs of its device's replica → (its int16 wire
        in host memory, copied into `host` where given, and the events the
        reader waits on)."""
        rep = self.replicas[self._shards[shard]]
        mode = "pcm" if "pcm" in inputs else "spec"
        key = GraphKey(f"batch_{mode}", bucket=bucket, batch=len(inputs["lengths"]), fast=self.fast)
        return rep.graphs.run(key, partial(group_body, rep.model, self.cfg, self.fast, rep.dec_cache), inputs,
                              consume=partial(_wire_to_host, host=host))

    def _read_loop(self) -> None:
        cfg = self.cfg
        while True:
            item = self._readq.get()
            if item is None:
                break
            host, events, group, number = item
            try:
                with trace("ov.batcher.readback", args={"group": number}):
                    for done in events:
                        done.synchronize()
                with trace("ov.batcher.answer", args={"group": number}):
                    audio = host.numpy().astype(np.float32) / 32767.0  # int16 wire → float
                    for i, r in enumerate(group):
                        samples = r.n_frames * cfg.upsample_factor
                        r.future.set_result(audio[i, :samples])
                        METRICS.add("audio_seconds", samples / cfg.sampling_rate)
                        METRICS.observe("request_latency", time.perf_counter() - r.enqueued_at)
            except Exception as exc:  # noqa: BLE001 — a failed readback fails its group only
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(RuntimeError(f"readback failed: {exc}"))
                METRICS.add("batch_failures")
