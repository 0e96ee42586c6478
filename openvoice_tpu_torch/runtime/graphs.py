"""One CUDA graph per shape: the port's counterpart of the JAX package's
``jax.jit`` cache (``openvoice_tpu/api.py:7``: "no per-utterance
recompiles, no dynamic shapes").

A `GraphCache` belongs to one model owner (a converter, a TTS model, a
batcher, a replica of a data-parallel position, a train state) on one
device.  ``run(key, body, inputs)`` runs ``body(**inputs)``:

* the first call of a `GraphKey` runs the body eagerly once (the warm-up:
  it builds K5's tables, every wrapper's window and cluster caches, cuDNN's
  plans and cuBLAS's workspace on the capture stream) and returns that
  result, then captures the body into a CUDA graph on the device's capture
  stream (``capture_error_mode="thread_local"``, one capture at a time in
  the process), in the device's one memory pool;
* every later call of the key copies its inputs into the graph's static
  input buffers (host arrays through pinned memory, ``non_blocking``),
  replays the graph and hands the outputs to ``consume`` — by default a
  clone — before another replay of the device's pool may run.

A key is what the JAX site marks static, with the shapes: (site, bucket,
batch, fast, chunk_frames, max_frames, segment_frames, device, wordpieces).  Every
traced value is an input tensor (tau, lengths, g, noise, the sampling knobs,
a train step's draws and learning rate), never a constant captured into the
graph.  A graph reads the model's parameters and its
packed serving weights where they lie: in-place updates keep it valid, and
whoever replaces those tensors (`set_model`, `load_ckpt`, `init_random`, a
rebuilt ``dec_cache``, a checkpoint loaded into a train state) calls
`clear`.  A cache whose graphs read another owner's models too (the fused
chains read the TTS model and the converter) names those owners' caches as
``reads``: their `clear` drops its graphs, and it runs eagerly while any of
them is off.

A body may change state in place: a train step updates the parameters and
the optimizer's moments and step counts, the counterpart of the JAX train
steps' donated state.  A capture records the body's device work without
executing it, but it does run the body's Python, so such a body must leave
every Python-side value as it found it (the state's step count stays
outside; gradients handed to ``.grad`` are set back to None); its first
call, the warm-up, is the caller's step, and the capture takes none.

Launch accounting: the kernel wrappers record their launches into the
capture's tally (`ops.recording_launches`), and each replay adds that tally
to the wrappers' ``launches`` counts, so a replayed call counts what the
eager call counts.

Spans (``runtime/profiler.py::trace``, while a profiler records):
``ov.graph.stage`` (the inputs' copies through pinned memory),
``ov.graph.replay`` (the replay and its launch accounting) and
``ov.graph.capture`` (warm-up and capture), each named with the key's site,
bucket and batch.  None goes inside a body.

Nothing falls back: a capture or replay that fails raises.  On the CPU, or
with ``enabled = False``, `run` calls the body eagerly and never captures or
replays anything.

The graphs of a device share one pool, so a graph's temporaries may lie
under another graph's outputs.  Hence the rule `run` keeps: a device's
replays are serialised (one lock, and an event chain across caller streams),
and each replay's outputs are consumed, in stream order, before the lock is
released.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from openvoice_tpu_torch import ops
from openvoice_tpu_torch.runtime.mesh import pinned, upload
from openvoice_tpu_torch.runtime.profiler import trace


class GraphKey(NamedTuple):
    """What selects a graph: the site, the JAX site's static arguments and
    the shapes; fields a site does not have stay None.  `GraphCache.run`
    fills in the device."""

    site: str
    bucket: int | None = None
    batch: int | None = None
    fast: bool | None = None
    chunk_frames: int | None = None
    max_frames: int | None = None
    segment_frames: int | None = None
    device: str | None = None
    wordpieces: int | None = None  # MeloTTS's encode: the wordpiece bucket of its BERT features


class CapturedGraph(NamedTuple):
    """A captured body: the graph, its static input buffers (by the body's
    argument names), its outputs (a tensor or a tuple of them, in the pool),
    the kernel launches recorded while it was captured (wrapper module →
    launches) and the seconds the capture took."""

    graph: Any
    inputs: dict
    outputs: Any
    tally: dict
    capture_s: float


_STATE_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()   # one capture at a time in the process (torch.cuda.graph's rule)
_DEVICE_LOCKS: dict[torch.device, threading.Lock] = {}
_POOLS: dict[torch.device, Any] = {}
_STREAMS: dict[torch.device, Any] = {}
_LAST: dict[torch.device, Any] = {}   # an event after the device's last replay and its consumer


def _per_device(table: dict, device: torch.device, make):
    with _STATE_LOCK:
        if device not in table:
            table[device] = make()
        return table[device]


def _device_lock(device: torch.device) -> threading.Lock:
    return _per_device(_DEVICE_LOCKS, device, threading.Lock)


def _pool(device: torch.device):
    """The device's one graph memory pool."""
    def make():
        with torch.cuda.device(device):
            return torch.cuda.graph_pool_handle()
    return _per_device(_POOLS, device, make)


def _streams(device: torch.device) -> tuple:
    """(the caller's current stream, the device's capture stream)."""
    return torch.cuda.current_stream(device), _per_device(_STREAMS, device, lambda: torch.cuda.Stream(device))


def _capturable(device: torch.device) -> bool:
    """Whether graphs can be captured on `device`: a CUDA device."""
    return device.type == "cuda"


def _record(graph, body: Callable, static: dict, stream, device: torch.device):
    """Capture ``body(**static)`` into `graph` on `stream`, in the device's
    pool; returns the body's outputs, which the graph writes at each
    replay."""
    with torch.cuda.graph(graph, pool=_pool(device), stream=stream, capture_error_mode="thread_local"):
        return body(**static)


def pool_bytes(device: str | torch.device) -> int:
    """Bytes the device's graph pool holds (its segments in the caching
    allocator), 0 before the first capture."""
    device = torch.device(device)
    pool = _POOLS.get(device)
    if pool is None:
        return 0
    want = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == (device.index or 0) and tuple(seg["segment_pool_id"]) == want)


def _tensors(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _clone(out):
    return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


def _as_tensor(x) -> torch.Tensor:
    """A numpy array or scalar as a CPU tensor (a tensor as it is)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.c_contiguous else np.ascontiguousarray(a))


def stage(static: dict, inputs: dict) -> None:
    """Copy each input into its static buffer, in stream order: host arrays
    through pinned memory with ``non_blocking`` (a pinned tensor as it is),
    device tensors in place.  Raises on a name, shape or dtype the buffers
    do not have."""
    if static.keys() != inputs.keys():
        raise KeyError(f"inputs {sorted(inputs)} against the graph's {sorted(static)}")
    for name, dst in static.items():
        src = _as_tensor(inputs[name])
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"input {name}: {src.dtype} {tuple(src.shape)} against the graph's "
                             f"{dst.dtype} {tuple(dst.shape)}")
        if dst.device.type == "cuda" and src.device.type == "cpu" and not src.is_pinned():
            src = pinned(src)
        dst.copy_(src, non_blocking=True)


class GraphCache:
    """The graphs of one model owner on one device, by `GraphKey`.

    `reads`: the caches of other owners whose models these graphs read as
    well; a `clear` of any of them drops these graphs, and while any of them
    is inactive these run eagerly."""

    def __init__(self, device: str | torch.device, enabled: bool = True, reads: tuple = ()):
        self.device = torch.device(device)
        self.enabled = enabled
        self._reads = tuple(reads)
        self._readers: weakref.WeakSet[GraphCache] = weakref.WeakSet()  # caches that read this owner's models
        for owner in self._reads:
            owner._readers.add(self)
        self._graphs: dict[GraphKey, CapturedGraph] = {}
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> list[GraphKey]:
        return list(self._graphs)

    def active(self) -> bool:
        """Whether `run` captures and replays: on a CUDA device, enabled,
        and so is every cache it `reads`."""
        return self.enabled and _capturable(self.device) and all(owner.active() for owner in self._reads)

    def clear(self) -> None:
        """Drop every graph, and those of the caches that read this owner's
        models: the tensors they read are being replaced."""
        with _device_lock(self.device):
            self._graphs.clear()
        for reader in list(self._readers):
            reader.clear()

    def run(self, key: GraphKey, body: Callable, inputs: dict, consume: Callable | None = None):
        """``consume(body(**inputs))``, as a replay of the key's graph where
        one exists.  `consume` runs under the device lock, in stream order
        after the replay; it defaults to the outputs themselves (a clone of
        them on a replay: the pool's next replay may overwrite the
        originals)."""
        if not self.active():
            out = body(**{name: upload(_as_tensor(x), self.device) for name, x in inputs.items()})
            return out if consume is None else consume(out)
        key = key._replace(device=str(self.device))
        with _device_lock(self.device):
            cur, side = _streams(self.device)
            last = _LAST.get(self.device)
            if last is not None:
                cur.wait_event(last)
            graph = self._graphs.get(key)
            if graph is None:  # the warm-up's outputs are the caller's own
                with trace("ov.graph.capture", args=_span_args(key)):
                    out = self._capture(key, body, inputs, cur, side)
                out = out if consume is None else consume(out)
            else:  # the pool's: consumed here, before another replay may run
                out = self._replay(key, graph, inputs)
                out = _clone(out) if consume is None else consume(out)
            done = torch.cuda.Event()
            done.record(cur)
            _LAST[self.device] = done
            return out

    def _replay(self, key: GraphKey, graph: CapturedGraph, inputs: dict):
        """Stage, replay, count the recorded launches; returns the graph's
        own outputs."""
        args = _span_args(key)
        with trace("ov.graph.stage", args=args):
            stage(graph.inputs, inputs)
        with trace("ov.graph.replay", args=args):
            graph.graph.replay()
            ops.add_launches(graph.tally)
        self.replays += 1
        return graph.outputs

    def _capture(self, key: GraphKey, body: Callable, inputs: dict, cur, side):
        """Warm up on the capture stream `side`, capture, keep the graph
        under `key`; returns the warm-up's outputs, ready on the caller's
        stream `cur`."""
        static = {name: torch.empty(tuple(_as_tensor(x).shape), dtype=_as_tensor(x).dtype, device=self.device)
                  for name, x in inputs.items()}
        stage(static, inputs)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = body(**static)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, ops.recording_launches() as tally:
            outputs = _record(graph, body, static, side, self.device)
        capture_s = time.perf_counter() - t0
        cur.wait_stream(side)
        for t in _tensors(warm):
            if t.is_cuda:
                t.record_stream(cur)  # made on the capture stream, read on the caller's
        self._graphs[key] = CapturedGraph(graph, static, outputs, dict(tally), capture_s)
        self.captures += 1
        self.capture_seconds += capture_s
        return warm

def _span_args(key: GraphKey) -> dict:
    return {"site": key.site, "bucket": key.bucket, "batch": key.batch}
