"""The port's multi-process runtime (``runtime/multihost.py``, the mesh
layouts of ``runtime/mesh.py``) against the JAX package's
(tests/test_multihost.py): the one-process no-op, the global mesh and its
three errors, the host-aware layout placed as JAX places it, a heartbeat
with fault injection, and a real two-process gloo run
(tests/_torch_multiproc_child.py)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from openvoice_tpu.runtime import mesh as JM
from openvoice_tpu_torch.runtime import multihost as MH
from openvoice_tpu_torch.runtime.mesh import make_hybrid_mesh, make_mesh
from openvoice_tpu_torch.training.data import make_global_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


def test_initialize_single_process_noop(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    topo = MH.initialize(device="cpu")
    assert (topo.process_id, topo.num_processes) == (0, 1)
    assert topo.global_device_count >= 1
    assert not torch.distributed.is_initialized()


def test_global_mesh_layout():
    mesh = MH.global_mesh(model_parallel=2, devices=CPU8)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 4, "model": 2}
    assert not mesh.multiprocess and len(mesh.local_coords()) == 8


@pytest.mark.parametrize("model, devices, match", [
    (4, ["cpu"] * 2, "exceeds local device count 2"),
    (3, CPU8, "must divide the local device count 8"),
])
def test_global_mesh_rejects_model_axis_leaving_a_host(model, devices, match):
    with pytest.raises(ValueError, match=match):
        MH.global_mesh(model_parallel=model, devices=devices)


def test_global_mesh_rejects_a_world_the_model_axis_does_not_divide(monkeypatch):
    """The third error: two processes on this host, one on another, and a
    model axis of 2 (a process group of three, faked)."""
    monkeypatch.setattr(MH.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(MH.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(MH, "_hosts", lambda: ["a", "a", "b"])
    with pytest.raises(ValueError, match="3 devices not divisible by model_parallel=2"):
        MH.global_mesh(model_parallel=2)


class _FakeDev:
    def __init__(self, pid: int, i: int):
        self.process_index = pid
        self.id = i


def test_hybrid_mesh_places_devices_as_jax_does():
    """Every model group on one host, the data axis across hosts: the same
    grid of device ids as the JAX package's layout."""
    jax_mesh = JM.make_hybrid_mesh([_FakeDev(p, p * 4 + i) for p in range(2) for i in range(4)], model=2)
    devs = [torch.device("cuda", i) for i in range(8)]
    mesh = make_hybrid_mesh(devs, model=2, hosts=[i // 4 for i in range(8)])
    assert mesh.shape == dict(jax_mesh.shape) == {"data": 4, "model": 2}
    ids = [[d.index for d in row] for row in mesh.devices]
    assert ids == [[d.id for d in row] for row in jax_mesh.devices]
    for row in ids:  # one host per model group
        assert len({i // 4 for i in row}) == 1


def test_hybrid_mesh_rejects_cross_host_model_group():
    with pytest.raises(ValueError, match="crossing hosts"):
        make_hybrid_mesh([torch.device("cuda", i) for i in range(8)], model=4, hosts=[i // 2 for i in range(8)])
    with pytest.raises(ValueError, match="unequal"):
        make_hybrid_mesh(CPU8[:3], model=1, hosts=[0, 0, 1])


def test_hybrid_mesh_single_process_executes():
    mesh = make_hybrid_mesh(CPU8, model=2)
    assert mesh.shape == {"data": 4, "model": 2}
    batch = make_global_batch(torch.ones(8, 16), mesh)
    assert batch.shape == (8, 16) and set(batch.shards) == set(mesh.local_coords())
    assert float(batch.sum() * 2) == 256.0
    assert torch.equal(batch.gather(), torch.ones(8, 16))


def test_make_mesh_errors_and_defaults():
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="3x2 != 4"):
        make_mesh(4, data=3, model=2, devices=CPU8)
    assert make_mesh(6, model=3, devices=CPU8).shape == {"data": 2, "model": 3}


def test_heartbeat_and_fault_injection():
    mon = MH.HeartbeatMonitor(timeout_s=30.0, device="cpu")
    assert mon.beat()
    mon.inject_failure()
    assert not mon.beat()


def test_two_process_gloo_run(tmp_path):
    """Two fresh processes join one gloo group through
    `multihost.initialize`, and each checks the global batch, data-,
    sequence- and tensor-parallel conversion, the data-parallel train steps
    in float64 and `train(mesh=)` against its own one-process results."""
    with socket.socket() as s:  # a free localhost port for the group's store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    procs = [
        subprocess.Popen([sys.executable, "-m", "tests._torch_multiproc_child", f"127.0.0.1:{port}", "2", str(pid),
                          str(tmp_path)],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = ["", ""]
    try:
        for i, p in enumerate(procs):
            outs[i], _ = p.communicate(timeout=240)  # a hung collective fails here, not at the suite's limit
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the 2-process gloo run timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"child {pid} failed:\n{out}"
        assert f"child {pid}: ok" in out
