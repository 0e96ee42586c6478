"""Device mesh, collectives and parameter sharding (the port of
``openvoice_tpu/runtime/mesh.py``).

Axes, as in the JAX package:

* ``data``: the batch.  Rows are split over it, and gradients are averaged
  across it (``training/train.py``).
* ``model``: tensor and sequence parallelism.  The wide convolutions'
  channels (``runtime/parallel.py``) or the time axis
  (``runtime/sequence_parallel.py``) are split over it.

A `Mesh` is a named ``("data", "model")`` grid of ``torch.device``s in one
of two forms:

* **in one process** (``ranks`` is None): every position is this process's.
  Code that runs "on every position" (`spmd`) runs one thread per position,
  each with its position's current device, and the collectives between them
  are copies and sums between devices.  A grid may repeat a device, which is
  how one card (or the CPU) holds a 2×4 or a 1×2 mesh.
* **over a ``torch.distributed`` process group** (``ranks`` gives each
  position's rank; `runtime.multihost.global_mesh` builds it): each process
  holds one position, and the same collectives use the group's
  ``all_reduce``, ``all_gather`` and ``send``/``recv`` over one process
  group per line of the grid.  Gloo takes CUDA tensors for ``all_reduce``
  only, so the other collectives go through host memory there.

The JAX package leaves placement to GSPMD; the port writes each collective
out, so the code that calls them (`spmd`, `Sharded`) is explicit about which
rows, frames or channels a position holds.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
COLLECTIVE_TIMEOUT_S = 300.0


class Mesh:
    """A ``("data", "model")`` grid of devices; `ranks` (same shape) names
    the process of each position when the mesh spans a process group."""

    axis_names = AXES

    def __init__(self, devices, ranks=None):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if grid.ndim != 2:
            raise ValueError(f"a mesh is a 2-D (data, model) grid, got shape {grid.shape}")
        self.devices = grid
        self.shape = {"data": grid.shape[0], "model": grid.shape[1]}
        self.ranks = None if ranks is None else np.asarray(ranks, dtype=np.int64).reshape(grid.shape)
        self._groups: dict[tuple, Any] = {}
        if self.ranks is not None:
            if not dist.is_initialized():
                raise RuntimeError("a mesh over ranks needs torch.distributed initialised")
            # every process creates every line's group, in one order
            for axis in AXES:
                for coord in self._line_starts(axis):
                    line = self.line(axis, coord)
                    ranks_of_line = [int(self.ranks[c]) for c in line]
                    group = dist.new_group(ranks_of_line) if len(ranks_of_line) < dist.get_world_size() \
                        else dist.group.WORLD
                    self._groups[(axis, line[0])] = group

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()}, ranks={None if self.ranks is None else self.ranks.tolist()})"

    @property
    def multiprocess(self) -> bool:
        return self.ranks is not None

    def local_coords(self) -> list[tuple[int, int]]:
        """The positions this process holds."""
        coords = [tuple(int(i) for i in c) for c in np.ndindex(self.devices.shape)]
        if self.ranks is None:
            return coords
        rank = dist.get_rank()
        return [c for c in coords if self.ranks[c] == rank]

    def _line_starts(self, axis: str) -> list[tuple[int, int]]:
        if axis == "data":
            return [(0, m) for m in range(self.shape["model"])]
        return [(d, 0) for d in range(self.shape["data"])]

    def line(self, axis: str, coord: tuple[int, int]) -> list[tuple[int, int]]:
        """The positions along `axis` through `coord`, in index order."""
        d, m = coord
        if axis == "data":
            return [(i, m) for i in range(self.shape["data"])]
        return [(d, i) for i in range(self.shape["model"])]

    def index(self, axis: str, coord: tuple[int, int]) -> int:
        return coord[AXES.index(axis)]

    def group(self, axis: str, coord: tuple[int, int]):
        return self._groups[(axis, self.line(axis, coord)[0])]


# ---------------------------------------------------------------------------
# Collectives along one axis of the mesh
# ---------------------------------------------------------------------------

class _Rendezvous:
    """The meeting point of one line's threads: each posts its tensor, all
    read every post, and a second barrier keeps the next exchange from
    overwriting a post before everyone has read it."""

    def __init__(self, n: int):
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n, timeout=COLLECTIVE_TIMEOUT_S)

    def exchange(self, i: int, value) -> list:
        self.slots[i] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class Comm:
    """The collectives of one position along one axis: `index` of `size`.

    all_gather(x, dim): every position's x, concatenated along dim in index
    order.  all_reduce(x): the sum of every position's x (in index order, so
    each position gets the same bits).  shift(x, offset): the x of position
    index − offset, and zeros where that lies outside the line (the ring's
    edges): the JAX package's ``ppermute`` with absent sources zero-filled.
    """

    def __init__(self, index: int, size: int):
        self.index, self.size = index, size

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._gather(x), dim=dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def shift(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        raise NotImplementedError

    def _gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        raise NotImplementedError


class ThreadComm(Comm):
    """One process: the line's threads meet at a `_Rendezvous`; results are
    copied to the caller's device."""

    def __init__(self, index: int, rendezvous: _Rendezvous):
        super().__init__(index, len(rendezvous.slots))
        self._rv = rendezvous

    def _gather(self, x):
        return [v.to(x.device) for v in self._rv.exchange(self.index, x)]

    def all_reduce(self, x):
        parts = self._gather(x)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def shift(self, x, offset):
        src = self.index - offset
        vals = self._rv.exchange(self.index, x)
        return vals[src].to(x.device) if 0 <= src < self.size else torch.zeros_like(x)


class GroupComm(Comm):
    """A process group: one line's processes, by their global ranks."""

    def __init__(self, mesh: Mesh, axis: str, coord: tuple[int, int]):
        line = mesh.line(axis, coord)
        super().__init__(line.index(coord), len(line))
        self._group = mesh.group(axis, coord)
        self._ranks = [int(mesh.ranks[c]) for c in line]
        # gloo takes CUDA tensors for all_reduce and broadcast only
        self._via_host = dist.get_backend(self._group) == "gloo"

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self._via_host else x

    def _gather(self, x):
        y = self._staged(x.contiguous())
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self._group)
        return [p.to(x.device) for p in parts]

    def all_reduce(self, x):
        y = x.clone()
        dist.all_reduce(y, group=self._group)
        return y

    def shift(self, x, offset):
        y = self._staged(x.contiguous())
        ops = []
        dst, src = self.index + offset, self.index - offset
        if 0 <= dst < self.size:
            ops.append(dist.isend(y, self._ranks[dst], group=self._group))
        out = torch.zeros_like(y)
        if 0 <= src < self.size:
            ops.append(dist.irecv(out, self._ranks[src], group=self._group))
        for op in ops:
            op.wait()
        return out.to(x.device)


def comms(mesh: Mesh, axis: str) -> dict[tuple[int, int], Comm]:
    """A `Comm` along `axis` for every local position: fresh rendezvous per
    line in one process, the line's group across processes."""
    if mesh.multiprocess:
        return {c: GroupComm(mesh, axis, c) for c in mesh.local_coords()}
    out: dict[tuple[int, int], Comm] = {}
    for start in mesh._line_starts(axis):
        line = mesh.line(axis, start)
        rv = _Rendezvous(len(line))
        for i, c in enumerate(line):
            out[c] = ThreadComm(i, rv)
    return out


def spmd(mesh: Mesh, fn: Callable[[tuple[int, int]], Any],
         uses: tuple[dict[tuple[int, int], Comm], ...] = ()) -> dict[tuple[int, int], Any]:
    """fn(coord) at every local position → {coord: result}.

    In one process each position runs in its own thread, with the caller's
    grad and inference modes and its position's current CUDA device (both
    are per thread); a failure in one thread breaks the barriers of the
    `comms` tables in `uses` (those its collectives use), so that the
    others fail at once instead of at the collective timeout, and the first
    failure is raised.  Across processes fn runs here, at this process's
    position."""
    coords = mesh.local_coords()
    if len(coords) == 1:
        return {coords[0]: fn(coords[0])}
    grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
    results: dict = {}
    errors: list[BaseException] = []

    def run(coord):
        dev = mesh.devices[coord]
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                results[coord] = fn(coord)
        except BaseException as exc:  # noqa: BLE001 — re-raised on the caller's thread
            errors.append(exc)
            for table in uses:
                for comm in table.values():
                    if isinstance(comm, ThreadComm):
                        comm._rv.barrier.abort()

    threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in coords]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        firsts = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
        raise (firsts or errors)[0]
    return results


# ---------------------------------------------------------------------------
# A tensor split over the mesh
# ---------------------------------------------------------------------------

@dataclass
class Sharded:
    """A global tensor of `shape`, of which this process holds `shards`
    ({coord: tensor on that position's device}); `spec` names the mesh axis
    each dimension is split over (None: whole), as a JAX ``PartitionSpec``
    does.  At most one dimension is split."""

    mesh: Mesh
    spec: tuple
    shape: tuple
    shards: dict

    def _split(self) -> tuple[int | None, str | None]:
        named = [(d, a) for d, a in enumerate(self.spec) if a is not None]
        if len(named) > 1:
            raise ValueError(f"at most one dimension may be split, spec {self.spec}")
        return named[0] if named else (None, None)

    def local(self) -> torch.Tensor:
        """The shard of this process's one position."""
        if len(self.shards) != 1:
            raise ValueError(f"this process holds {len(self.shards)} positions; pick one from .shards")
        return next(iter(self.shards.values()))

    def gather(self, device: torch.device | str | None = None) -> torch.Tensor:
        """The whole tensor (across processes a collective: every process
        must call it)."""
        dim, axis = self._split()
        first = self.mesh.local_coords()[0]
        if dim is None:
            out = self.shards[first]
        elif self.mesh.multiprocess:
            out = GroupComm(self.mesh, axis, first).all_gather(self.shards[first], dim)
        else:
            dev = self.shards[first].device
            out = torch.cat([self.shards[c].to(dev) for c in self.mesh.line(axis, first)], dim=dim)
        return out if device is None else out.to(device)

    def sum(self) -> torch.Tensor:
        """The sum of every element of the global tensor (each split piece
        counted once; across processes a collective)."""
        dim, axis = self._split()
        first = self.mesh.local_coords()[0]
        part = self.shards[first].sum()
        if dim is None:
            return part
        if self.mesh.multiprocess:
            return GroupComm(self.mesh, axis, first).all_reduce(part)
        return sum(self.shards[c].sum().to(part.device) for c in self.mesh.line(axis, first))


def row_range(n_rows: int, mesh: Mesh, coord: tuple[int, int]) -> slice:
    """The rows of a [n_rows, ...] batch that `coord`'s data index holds."""
    d = mesh.shape["data"]
    if n_rows % d:
        raise ValueError(f"batch of {n_rows} rows does not split over {d} data positions")
    per = n_rows // d
    return slice(coord[0] * per, (coord[0] + 1) * per)


def pinned(x: torch.Tensor) -> torch.Tensor:
    """A pinned copy of a CPU tensor, copied by numpy.  ``Tensor.pin_memory``
    copies on torch's intra-op thread pool, and on the card's host that copy
    stalled for milliseconds while numpy's BLAS threads (the watermark's
    products) still spun on every core; numpy's copy is one thread's
    memcpy."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.numpy()[...] = x.numpy()
    return out


def upload(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device`; to the card through pinned memory (a
    pinned tensor as it is) and an asynchronous copy, which does not wait
    for the kernels queued before it."""
    if device.type == "cuda" and x.device.type == "cpu":
        return (x if x.is_pinned() else pinned(x)).to(device, non_blocking=True)
    return x.to(device)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> Sharded:
    """A whole batch [B, ...] split over the data axis, each position's rows
    on its device (in one process; across processes each process keeps its
    own rows, as `training.data.make_global_batch` does)."""
    shards = {c: upload(x[row_range(x.shape[0], mesh, c)], mesh.devices[c]) for c in mesh.local_coords()}
    return Sharded(mesh, batch_sharding(mesh) + (None,) * (x.dim() - 1), tuple(x.shape), shards)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def cuda_devices() -> list[torch.device]:
    """Every CUDA device of this process; without CUDA, `api.resolve_device`'s
    error (there is no silent CPU path)."""
    from openvoice_tpu_torch.api import resolve_device  # api imports this module's users

    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, data: int | None = None, model: int | None = None,
              devices=None) -> Mesh:
    """A ``("data", "model")`` mesh in one process.  Defaults: every CUDA
    device, all on data (without CUDA this raises: the CPU only when the
    caller names it).  `devices` may repeat a device (``["cpu"] * 8``, or
    ``["cuda:0"] * 2`` on one card)."""
    devices = list(devices) if devices is not None else cuda_devices()
    n = n_devices or len(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devices = devices[:n]
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(np.asarray(devices, dtype=object).reshape(data, model))


def make_hybrid_mesh(devices=None, model: int = 1, hosts=None, ranks=None) -> Mesh:
    """A host-aware mesh: each model-axis group lies on one host, and the
    data axis's outer stride crosses hosts, so only data-parallel traffic
    leaves a host.  `hosts[i]` is device i's host (default: one host, which
    degrades to `make_mesh`); `ranks[i]`, where given, its process."""
    devices = list(devices) if devices is not None else cuda_devices()
    hosts = [0] * len(devices) if hosts is None else list(hosts)
    by_host: dict[int, list[int]] = {}
    for i, h in enumerate(hosts):
        by_host.setdefault(h, []).append(i)
    groups = [by_host[k] for k in sorted(by_host)]
    per_host = len(groups[0])
    if any(len(h) != per_host for h in groups):
        raise ValueError("hosts expose unequal device counts")
    if per_host % model != 0:
        raise ValueError(f"model={model} does not fit within one host's {per_host} devices; a model group "
                         "crossing hosts would put tensor-parallel collectives on the network between hosts")
    rows = [h[i * model : (i + 1) * model] for h in groups for i in range(per_host // model)]
    grid = np.array([[devices[i] for i in row] for row in rows], dtype=object)
    rank_grid = None if ranks is None else np.array([[ranks[i] for i in row] for row in rows])
    return Mesh(grid, rank_grid)


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

# state_dict name → spec (the axis each dimension is split over).  The JAX
# package's rules (its mesh.py:93-109) on the port's names and layouts: a
# Conv1d weight is [C_out, C_in, K] and a ConvTranspose1d weight [C_in,
# C_out, K], so every rule splits axis 0 here:
#  * conv_pre and cond project into upsample_initial_channel: output channels;
#  * the upsamples: input channels, matching the incoming split;
#  * the WaveNet stacks' in layers (h → 2h) and their conditioning: the 2h
#    output channels.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"^dec\.conv_pre\.weight$", ("model", None, None)),
    (r"^dec\.cond\.weight$", ("model", None, None)),
    (r"^dec\.ups\.\d+\.weight$", ("model", None, None)),
    (r"^(enc_q|flow)\..*in_layers\.\d+\.weight$", ("model", None, None)),
    (r"^(enc_q|flow)\..*cond_layer\.weight$", ("model", None, None)),
]


def param_spec(name: str) -> tuple:
    """The rule's spec for a state_dict name; () (replicated) when none
    applies."""
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, name):
            return spec
    return ()


def _state_dict(model_or_sd) -> dict[str, torch.Tensor]:
    return dict(model_or_sd.state_dict() if isinstance(model_or_sd, torch.nn.Module) else model_or_sd)


def params_shardings(model_or_sd, mesh: Mesh) -> dict[str, tuple]:
    """{name: spec} by the rules; an axis that does not divide by its mesh
    axis's size stays whole (the spec becomes ())."""
    out = {}
    for name, t in _state_dict(model_or_sd).items():
        spec = param_spec(name)
        if any(a is not None and t.shape[i] % mesh.shape[a] for i, a in enumerate(spec) if i < t.dim()):
            spec = replicated(mesh)
        out[name] = spec
    return out


def batch_sharding(mesh: Mesh) -> tuple:
    """The spec of an utterance batch: split over the data axis (the leading
    dimension).  It takes the mesh, as the JAX package's does, though a spec
    names axes only."""
    return ("data",)


def replicated(mesh: Mesh) -> tuple:
    """The spec of a tensor every position holds whole (as `batch_sharding`,
    the JAX package's signature)."""
    return ()


def shard_params(model_or_sd, mesh: Mesh) -> dict[tuple[int, int], dict[str, torch.Tensor]]:
    """Each local position's parameters on its device: {coord: {name:
    tensor}}, a split tensor holding only that position's piece (1/model of
    it), the others whole."""
    sd = _state_dict(model_or_sd)
    specs = params_shardings(sd, mesh)
    out: dict = {}
    for coord in mesh.local_coords():
        dev = mesh.devices[coord]
        local = {}
        for name, t in sd.items():
            t = t.detach()
            for axis_dim, axis in enumerate(specs[name]):
                if axis is not None:
                    n, i = mesh.shape[axis], mesh.index(axis, coord)
                    step = t.shape[axis_dim] // n
                    t = t.narrow(axis_dim, i * step, step)
            local[name] = t.to(dev).contiguous()
        out[coord] = local
    return out
