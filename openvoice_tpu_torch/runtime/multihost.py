"""Multi-process runtime: process-group start-up, the global mesh, failure
detection (the port of ``openvoice_tpu/runtime/multihost.py``).

Topology: one process per device (PyTorch's usual layout, where the JAX
package runs one process per host), processes on one host joined by the
host's links, hosts by the network.  The ``("data", "model")`` mesh keeps
the ``model`` axis (tensor and sequence parallelism, the heavier
collectives) inside one host's processes, and lets ``data`` (gradient and
metric all-reduces only) span hosts.

A single process degrades gracefully: `initialize()` is a no-op when no
coordinator is configured, and `global_mesh()` then builds the mesh over
this process's own devices (`mesh.make_mesh`).  As everywhere in the port
(`api.resolve_device`), those are the card's unless the caller names the
CPU: without CUDA and without ``device="cpu"`` / ``devices=["cpu", ...]``
every entry point here raises.
"""

from __future__ import annotations

import datetime
import os
import socket
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

from openvoice_tpu_torch.api import resolve_device
from openvoice_tpu_torch.runtime.mesh import Mesh, cuda_devices, make_hybrid_mesh, make_mesh

# the device this process contributes to a global mesh (set by `initialize`)
_DEVICE: torch.device | None = None


@dataclass(frozen=True)
class HostTopology:
    process_id: int
    num_processes: int
    local_device_count: int
    global_device_count: int


def _local_devices(devices=None) -> list[torch.device]:
    """This process's devices when it runs alone: `devices` where the caller
    names them, else every CUDA device (`mesh.cuda_devices`: without CUDA
    this raises)."""
    return [resolve_device(d) for d in devices] if devices is not None else cuda_devices()


def _rank_device() -> torch.device:
    """The card of a process in a group: ``cuda:<LOCAL_RANK mod device
    count>``, whatever the group's backend (`api.resolve_device`'s error
    without CUDA)."""
    resolve_device(None)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())


def _hosts() -> list[str]:
    """Every rank's host name, in rank order (a collective)."""
    names: list = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return names


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device: str | torch.device | None = None,
               backend: str | None = None, timeout_s: float = 300.0) -> HostTopology:
    """Join (or skip) the process group.

    The arguments default to the environment variables COORDINATOR_ADDRESS
    (``host:port``), NUM_PROCESSES and PROCESS_ID, so one launch script works
    under any process runner; with none set this is a no-op, as it is when a
    group already exists.  `device` as in `api.resolve_device`: the card
    (``cuda:<LOCAL_RANK mod device count>`` by default) over NCCL, unless the
    caller asks for the CPU, which runs over gloo.  `backend` overrides the
    choice: NCCL refuses two ranks on one device, so ranks that share a card
    run over gloo."""
    global _DEVICE
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address and not dist.is_initialized():
        dev = _rank_device() if device is None else resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=init,
            world_size=num_processes or int(os.environ.get("NUM_PROCESSES", "1")),
            rank=process_id if process_id is not None else int(os.environ.get("PROCESS_ID", "0")),
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        _DEVICE = dev
    return topology(None if device is None else [device])


def topology(devices=None) -> HostTopology:
    """This process's place in the group; alone, over `devices` (default:
    every CUDA device, as `global_mesh` takes them)."""
    if not dist.is_initialized():
        n = len(_local_devices(devices))
        return HostTopology(process_id=0, num_processes=1, local_device_count=n, global_device_count=n)
    hosts = _hosts()
    world = dist.get_world_size()
    return HostTopology(process_id=dist.get_rank(), num_processes=world,
                        local_device_count=hosts.count(hosts[dist.get_rank()]), global_device_count=world)


def process_device() -> torch.device:
    """The device this process contributes to the global mesh: the one
    `initialize` joined with, else (a group another caller started, or no
    group) the card `_rank_device` names."""
    return _DEVICE if _DEVICE is not None else _rank_device()


def global_mesh(model_parallel: int | None = None, devices=None) -> Mesh:
    """The ``("data", "model")`` mesh over every process's device, with each
    model group inside one host.

    Alone (no process group), the mesh is over `devices` (default: this
    process's CUDA devices; without CUDA this raises), as `make_mesh`
    builds it.  In a
    group, each rank contributes its device (`process_device`), ranks are
    grouped by host, and `make_hybrid_mesh` lays them out."""
    model = model_parallel or 1
    if dist.is_initialized():
        hosts = _hosts()
        me = hosts[dist.get_rank()]
        local, total = hosts.count(me), len(hosts)
    else:
        devices = _local_devices(devices)
        local = total = len(devices)
    if model > local:
        raise ValueError(f"model_parallel={model} exceeds local device count {local}; "
                         "the model axis must stay inside one host")
    if local % model:
        # a model group would straddle two hosts
        raise ValueError(f"model_parallel={model} must divide the local device count {local} "
                         "so that every model group stays inside one host")
    if total % model:
        raise ValueError(f"{total} devices not divisible by model_parallel={model}")
    if not dist.is_initialized():
        return make_mesh(total, data=total // model, model=model, devices=devices)
    order = {h: i for i, h in reversed(list(enumerate(hosts)))}  # a host's index: its lowest rank
    device_strs: list = [None] * total
    dist.all_gather_object(device_strs, str(process_device()))
    return make_hybrid_mesh(device_strs, model=model, hosts=[order[h] for h in hosts], ranks=list(range(total)))


# ---------------------------------------------------------------------------
# Failure detection
# ---------------------------------------------------------------------------

class HeartbeatMonitor:
    """Detects dead processes with a timed all-reduce heartbeat.

    The collective either completes (everyone alive) or times out (a process
    is gone); the caller decides whether to start again with the survivors
    or drop the batch.  `inject_failure()` makes this process stop taking
    part (fault injection for tests).  `device` (default `process_device`)
    is where a process alone, or a member of an NCCL group, takes its beat;
    a gloo group beats on the host."""

    def __init__(self, timeout_s: float = 60.0, device: str | torch.device | None = None):
        self.timeout_s = timeout_s
        self.device = process_device() if device is None else resolve_device(device)
        self._injected = False

    def inject_failure(self) -> None:
        self._injected = True

    def beat(self) -> bool:
        """True if every process answered within the timeout.

        The collective runs in a worker thread joined with the timeout,
        because it has no timeout of its own that returns: a dead peer would
        otherwise hang the monitor on the very failure it exists to find.  A
        timed-out thread is left behind (daemon); on False the caller tears
        the process group down or starts it again."""
        if self._injected:
            return False
        result: list[bool] = []

        def barrier() -> None:
            try:
                if dist.is_initialized() and dist.get_world_size() > 1:
                    dev = self.device if dist.get_backend() == "nccl" else torch.device("cpu")
                    one = torch.ones(1, device=dev)
                    dist.all_reduce(one)
                    result.append(float(one.item()) == dist.get_world_size())
                else:
                    torch.ones((), device=self.device).item()
                    result.append(True)
            except Exception:  # noqa: BLE001 — any collective failure means a dead process
                result.append(False)

        t = threading.Thread(target=barrier, daemon=True)
        t.start()
        t.join(self.timeout_s)
        if t.is_alive() or not result or not result[0]:
            return False
        return True
