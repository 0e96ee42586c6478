"""The port's lock-step distributed convert service
(``serve/distributed.py``) against the JAX package's on the same weights
and requests: one process on a one-device mesh (JAX on a one-device CPU
mesh) at the port's audio bar, the same rounds over a 2×1 mesh in one
process, and one two-process gloo round in which one process passes []."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from openvoice_tpu.runtime.mesh import make_mesh as jax_make_mesh
from openvoice_tpu.serve.distributed import DistRequest as JaxRequest
from openvoice_tpu.serve.distributed import DistributedConvertService as JaxService
from openvoice_tpu_torch.ckpt.from_jax import synthesizer_from_jax
from openvoice_tpu_torch.runtime.elastic import WorkLog, _free_port
from openvoice_tpu_torch.runtime.mesh import make_mesh
from openvoice_tpu_torch.serve.distributed import DistRequest, DistributedConvertService
from tests._elastic_child import TINY as JAX_TINY
from tests._torch_elastic_child import TINY
from tests._torch_port import AUDIO_TOL, jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields() -> dict:
    return dataclasses.asdict(TINY)


def _requests(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nf = int(rng.integers(12, 41))
        out.append({"spec": np.abs(rng.standard_normal((nf, TINY.spec_channels))).astype(np.float32),
                    "n_frames": nf, "g_src": rng.standard_normal(TINY.gin_channels).astype(np.float32),
                    "g_tgt": rng.standard_normal(TINY.gin_channels).astype(np.float32),
                    "tau": 0.3, "seed": 700 + i})
    return out


@pytest.fixture(scope="module")
def weights():
    params = jax_params(_fields(), seed=4)
    return params, synthesizer_from_jax(params, TINY).eval()


def test_one_process_round_matches_jax(weights):
    params, model = weights
    reqs = _requests(5, seed=1)
    jsvc = JaxService(jax.tree.map(np.asarray, params), JAX_TINY, jax_make_mesh(1))
    svc = DistributedConvertService(model, TINY, make_mesh(1, devices=["cpu"]), device="cpu")
    ref = jsvc.convert_round([JaxRequest(**r) for r in reqs])
    got = svc.convert_round([DistRequest(**r) for r in reqs])
    assert len(got) == len(ref) == 5
    for r, a, b in zip(reqs, got, ref):
        assert a.shape == b.shape == (r["n_frames"] * TINY.upsample_factor,)
        np.testing.assert_allclose(a, b, atol=AUDIO_TOL)
    assert svc.convert_round([]) == [] == jsvc.convert_round([])


def test_rounds_over_a_two_position_mesh_match_one_device(weights):
    """Three requests over a 2×1 mesh: padded to whole rows per data
    position, each result equal to the one-device round's."""
    _, model = weights
    reqs = [DistRequest(**r) for r in _requests(3, seed=2)]
    one = DistributedConvertService(model, TINY, make_mesh(1, devices=["cpu"]), device="cpu")
    two = DistributedConvertService(model, TINY, make_mesh(2, data=2, model=1, devices=["cpu", "cpu"]),
                                    device="cpu")
    for a, b in zip(two.convert_round(reqs), one.convert_round(reqs)):
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_two_process_gloo_round(tmp_path, weights):
    """Two processes on one gloo group: process 1 passes [] in the first
    round; each process's audio equals its one-process truth."""
    _, model = weights
    log = WorkLog(str(tmp_path))
    log.write_params(model)
    log.write_requests(_requests(4, seed=3))
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-m", "tests._torch_elastic_child", "round", str(tmp_path), addr,
                               "2", str(pid)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "round ok" in out, f"process {pid}:\n{out}"
