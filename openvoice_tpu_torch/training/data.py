"""Training input pipeline (the port of ``openvoice_tpu/training/data.py``).

Host-side: scan a directory of WAV and mp3 files per speaker, window them into
fixed-frame training segments, compute linear spectrograms with the same
front end the models consume (the host reflect pad of
``api._spec_from_audio`` and the numpy STFT of ``audio/stft.py::
host_spectrogram``, as the JAX package does, so that both packages build
bit-equal batches), and yield numpy batches.  Each process reads its own
shard of the file list (round-robin by ``torch.distributed``'s rank when it
is initialised, else process 0 of 1).

Speaker embeddings for self-reconstruction training come from a converter's
own reference encoder (``extract_se_from_file`` per speaker, cached), which
runs the STFT kernel on the card.
"""

from __future__ import annotations

import os
import queue
import threading
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from openvoice_tpu_torch.api import _spec_from_audio
from openvoice_tpu_torch.audio.io import load_audio, wav_num_samples
from openvoice_tpu_torch.audio.stft import host_spectrogram
from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.runtime.mesh import Mesh, Sharded, batch_sharding, shard_rows, upload


@dataclass(frozen=True)
class Segment:
    path: str
    start: int       # sample offset
    frames: int      # spectrogram frames
    speaker: str


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of ``torch.distributed`` when it is initialised,
    else (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def scan_dataset(root: str, cfg: SynthesizerConfig, segment_frames: int = 128, hop_segments: int | None = None,
                 process_index: int | None = None, process_count: int | None = None) -> list[Segment]:
    """root/<speaker>/*.{wav,mp3} → windowed segment index, sharded by
    process.

    Segments are `segment_frames` spectrogram frames (= frames·hop samples),
    stepped by `hop_segments` frames (default: non-overlapping).  A WAV's
    length comes from its header; an mp3 is decoded to get its length.
    """
    pi, pc = process_index_count()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    step = (hop_segments or segment_frames) * cfg.hop_length
    seg_samples = segment_frames * cfg.hop_length

    files: list[tuple[str, str]] = []
    for speaker in sorted(os.listdir(root)):
        sdir = os.path.join(root, speaker)
        if not os.path.isdir(sdir):
            continue
        for f in sorted(os.listdir(sdir)):
            if f.lower().endswith((".wav", ".mp3")):
                files.append((os.path.join(sdir, f), speaker))

    segments: list[Segment] = []
    for idx, (path, speaker) in enumerate(files):
        if idx % pc != pi:  # per-process shard of the file list
            continue
        if path.lower().endswith(".wav"):
            length = wav_num_samples(path, target_sr=cfg.sampling_rate)
        else:
            length = len(load_audio(path, sr=cfg.sampling_rate)[0])
        n = (length - seg_samples) // step + 1 if length >= seg_samples else 0
        for j in range(n):
            segments.append(Segment(path, j * step, segment_frames, speaker))
    return segments


class ConverterDataset:
    """Iterates (spec [B, F, n_freq], audio [B, F·hop], lengths [B],
    g [B, 1, gin]) numpy batches for converter training, in the JAX
    package's order (``np.random.default_rng(seed + process index)``)."""

    def __init__(self, root: str, cfg: SynthesizerConfig, batch_size: int, segment_frames: int = 128,
                 seed: int = 0, converter=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.segment_frames = segment_frames
        self.segments = scan_dataset(root, cfg, segment_frames)
        if not self.segments:
            raise ValueError(f"no trainable segments under {root}")
        self._rng = np.random.default_rng(seed + process_index_count()[0])
        self._audio_cache: dict[str, np.ndarray] = {}
        self._se_cache: dict[str, np.ndarray] = {}
        self._converter = converter

    def _audio(self, path: str) -> np.ndarray:
        if path not in self._audio_cache:
            while len(self._audio_cache) > 256:  # evict oldest, not everything
                self._audio_cache.pop(next(iter(self._audio_cache)))
            self._audio_cache[path] = load_audio(path, sr=self.cfg.sampling_rate)[0]
        return self._audio_cache[path]

    def _speaker_se(self, speaker: str, example_path: str) -> np.ndarray:
        """Per-speaker embedding from the converter's own ref_enc (cached);
        zeros when no converter is wired in (zero_g-style training).

        This runs in `PrefetchIterator`'s worker thread, where neither the
        grad mode nor the current CUDA device of the consumer applies (both
        are per thread): set both here."""
        if speaker not in self._se_cache:
            if self._converter is None:
                self._se_cache[speaker] = np.zeros(self.cfg.gin_channels, np.float32)
            else:
                dev = self._converter.device
                with torch.no_grad(), torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                    se = self._converter.extract_se_from_file(example_path)
                self._se_cache[speaker] = np.asarray(se).reshape(-1)
        return self._se_cache[speaker]

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        cfg = self.cfg
        order = self._rng.permutation(len(self.segments))
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            batch = [self.segments[j] for j in order[i : i + self.batch_size]]
            seg_samples = self.segment_frames * cfg.hop_length
            audio = np.zeros((len(batch), seg_samples), np.float32)
            g = np.zeros((len(batch), 1, cfg.gin_channels), np.float32)
            for bi, seg in enumerate(batch):
                a = self._audio(seg.path)
                audio[bi] = a[seg.start : seg.start + seg_samples]
                g[bi, 0] = self._speaker_se(seg.speaker, seg.path)
            spec = np.stack([
                host_spectrogram(_spec_from_audio(audio[bi], cfg)[0], cfg.filter_length, cfg.hop_length,
                                 cfg.win_length)[: self.segment_frames]
                for bi in range(len(batch))
            ])
            lengths = np.full((len(batch),), self.segment_frames, np.int32)
            yield spec, audio, lengths, g


class PrefetchIterator:
    """Background-thread batch prefetch: host batch prep (audio slicing,
    numpy STFT, SE lookup) overlaps the device step instead of serialising
    with it.  `depth` bounds host memory (batches in flight)."""

    def __init__(self, iterable, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: list[BaseException] = []
        self._stop = threading.Event()

        def put(item) -> bool:
            """Blocking, stop-aware put; False once close() was called."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker() -> None:
            try:
                for item in iterable:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
                self._err.append(e)
            finally:
                # the done marker must be DELIVERED, not best-effort: with a
                # fast producer the queue is typically full when iteration
                # ends, and a dropped marker leaves the consumer blocked on
                # get() after it drains the last batch
                put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the worker and release in-flight batches; idempotent.  Call
        when abandoning the iterator before exhaustion (early train() exit)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item


def make_global_batch(local_batch, mesh: Mesh) -> Sharded:
    """This process's batch → one global batch split over the data axis.

    Every process calls it with its own rows: across processes the global
    batch is every data position's rows in data order (each process one
    position; processes that share a data index pass the same rows).  As in
    the JAX package, every process must hold as many rows as the others;
    nothing checks it, since a check would cost a collective per call.  In
    one process the local batch is the whole batch, split over the data
    positions."""
    x = torch.as_tensor(local_batch)
    if not mesh.multiprocess:
        return shard_rows(x, mesh)
    (coord,) = mesh.local_coords()
    shape = (x.shape[0] * mesh.shape["data"], *x.shape[1:])
    return Sharded(mesh, batch_sharding(mesh) + (None,) * (x.dim() - 1), shape,
                   {coord: upload(x, mesh.devices[coord])})
