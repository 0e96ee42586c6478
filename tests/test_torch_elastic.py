"""The port's elastic tier (``runtime/elastic.py``) against the JAX
package's (tests/test_elastic.py): the WorkLog both ways between the
packages, a worker death mid-stream with a shrunk relaunch, a full run with
no failure, each result against JAX's single-process truth, and a training
death that resumes from its checkpoint.  Workers are tests/_torch_elastic_child.py
processes on the CPU over gloo; deaths come from die-after markers."""

import dataclasses
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from openvoice_tpu.runtime.elastic import WorkLog as JaxWorkLog
from openvoice_tpu_torch.ckpt import native_io as CIO
from openvoice_tpu_torch.ckpt.from_jax import synthesizer_from_jax
from openvoice_tpu_torch.runtime.elastic import EX_TEMPFAIL, Supervisor, TrainSupervisor, WorkLog
from tests._torch_elastic_child import TINY
from tests._torch_port import AUDIO_TOL, jax_params
from tests._torch_port import jax_elastic_truth as jax_truth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_REQUESTS = 8


def _requests(rng: np.random.Generator) -> list[dict]:
    return [{"spec": np.abs(rng.standard_normal((16 + 4 * (i % 3), TINY.spec_channels))).astype(np.float32),
             "n_frames": 16 + 4 * (i % 3), "g_src": rng.standard_normal(TINY.gin_channels).astype(np.float32),
             "g_tgt": rng.standard_normal(TINY.gin_channels).astype(np.float32), "tau": 0.3, "seed": 500 + i}
            for i in range(N_REQUESTS)]


@pytest.fixture(scope="module")
def params():
    return jax_params(dataclasses.asdict(TINY), seed=0)


@pytest.fixture()
def jax_worklog(tmp_path, params):
    """A state directory written by the JAX package's WorkLog."""
    log = JaxWorkLog(str(tmp_path))
    log.write_params(params)
    log.write_requests(_requests(np.random.default_rng(42)))
    return WorkLog(str(tmp_path))


def _cmd(state_dir: str, *extra: str):
    def cmd(coordinator, world, pid):
        return [sys.executable, "-m", "tests._torch_elastic_child", "worker", state_dir, coordinator or "none",
                str(world), str(pid), *extra]
    return cmd


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": ROOT}


def _check_against_jax(log: WorkLog, params) -> None:
    assert not log.pending_ids(N_REQUESTS)
    for i, req in enumerate(log.load_requests()):
        out, ref = log.load_result(i), jax_truth(params, req)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=AUDIO_TOL, err_msg=f"request {i}")


def test_worklog_roundtrip(tmp_path):
    log = WorkLog(str(tmp_path))
    reqs = _requests(np.random.default_rng(0))
    log.write_requests(reqs)
    back = log.load_requests()
    assert len(back) == N_REQUESTS
    np.testing.assert_array_equal(back[3]["spec"], reqs[3]["spec"])
    assert log.pending_ids() == list(range(N_REQUESTS))
    log.mark_done(2, np.ones(5, np.float32))
    assert log.pending_ids() == [i for i in range(N_REQUESTS) if i != 2]
    np.testing.assert_array_equal(log.load_result(2), np.ones(5, np.float32))


def test_state_directories_cross_between_the_packages(tmp_path, params):
    """A directory the JAX WorkLog wrote is read by the port's (requests,
    weights, results) and the other way round."""
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    reqs = _requests(np.random.default_rng(1))
    jlog = JaxWorkLog(jax_dir)
    jlog.write_params(params)
    jlog.write_requests(reqs)
    jlog.mark_done(4, np.arange(6, dtype=np.float32))
    log = WorkLog(jax_dir)
    assert [sorted(r) for r in log.load_requests()] == [sorted(r) for r in reqs]
    assert log.pending_ids() == jlog.pending_ids() == [i for i in range(N_REQUESTS) if i != 4]
    np.testing.assert_array_equal(log.load_result(4), np.arange(6, dtype=np.float32))
    model = log.load_model(TINY)
    ref = synthesizer_from_jax(params, TINY).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())

    out = WorkLog(port_dir)
    out.write_params(model)
    out.write_requests(reqs)
    back = JaxWorkLog(port_dir)
    leaves = dict(jax.tree_util.tree_leaves_with_path(back.load_params()))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(leaves[path]), leaf)
    np.testing.assert_array_equal(back.load_requests()[5]["spec"], reqs[5]["spec"])


def test_elastic_death_mid_stream_shrinks_and_completes(jax_worklog, tmp_path, params):
    """Process 1 of a two-process world dies after its first round; the
    survivor exits EX_TEMPFAIL, the world shrinks to one and completes every
    request, each equal to JAX's single-process truth."""
    marker = str(tmp_path / "die.marker")
    sup = Supervisor(str(tmp_path), _cmd(str(tmp_path), "0.0", f"1:0:{marker}"), world=2, max_restarts=2,
                     env=_env())
    assert sup.run(timeout_s=240), f"recovery failed: {sup.history}"
    assert os.path.exists(marker), "fault injection never fired"
    first = sup.history[0]
    assert first["world"] == 2 and first["rcs"][1] == 9, first
    assert first["rcs"][0] == EX_TEMPFAIL, first["outs"][0]
    assert [h["world"] for h in sup.history[1:]] == [1], sup.history
    _check_against_jax(jax_worklog, params)


def test_supervisor_full_run_no_failure(jax_worklog, tmp_path, params):
    sup = Supervisor(str(tmp_path), _cmd(str(tmp_path)), world=2, max_restarts=1, env=_env())
    assert sup.run(timeout_s=240), f"run failed: {sup.history}"
    assert sup.restarts == 0 and sup.history[0]["rcs"] == [0, 0]
    _check_against_jax(jax_worklog, params)


def _training_data(root) -> None:
    """root/<speaker>/clip.wav: enough 16-frame segments for batch 4."""
    from openvoice_tpu_torch.audio.io import write_wav

    rng = np.random.default_rng(7)
    for spk, f0 in (("spk0", 220), ("spk1", 330)):
        os.makedirs(os.path.join(str(root), spk), exist_ok=True)
        t = np.arange(4000) / TINY.sampling_rate
        x = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
        write_wav(os.path.join(str(root), spk, "clip.wav"), x, TINY.sampling_rate)


def test_elastic_training_death_resumes_from_checkpoint(tmp_path):
    """Process 1 of a two-process training world dies after step 6; the
    relaunched world of one resumes from step 4 (which it does not write
    again) and reaches step 8 with finite weights and losses."""
    data_root, ckpt_dir = tmp_path / "data", str(tmp_path / "ckpt")
    _training_data(data_root)
    marker = str(tmp_path / "die.marker")
    target = 8

    def cmd(coordinator, world, pid):
        return [sys.executable, "-m", "tests._torch_elastic_child", "train", str(data_root), ckpt_dir,
                coordinator or "none", str(world), str(pid), str(target), f"1:6:{marker}"]

    sup = TrainSupervisor(ckpt_dir, target, cmd, world=2, max_restarts=3, env=_env())
    result: dict = {}
    runner = threading.Thread(target=lambda: result.update(ok=sup.run(timeout_s=240)), daemon=True)
    runner.start()
    # step_4 as the dead world left it: a relaunch that started from step 0
    # would replace the file (a new inode) long before its own step 4
    step4 = os.path.join(ckpt_dir, "step_4", CIO.STATE_FILE)
    while not sup.history and runner.is_alive():
        time.sleep(0.02)
    written = os.stat(step4).st_ino
    runner.join(timeout=260)
    assert result.get("ok"), f"elastic training failed: {sup.history}"
    assert os.path.exists(marker), "fault injection never fired"
    first = sup.history[0]
    assert first["world"] == 2 and first["rcs"][1] == 9 and first["rcs"][0] == EX_TEMPFAIL, first
    assert [h["world"] for h in sup.history[1:]] == [1], sup.history
    assert CIO.latest_step(ckpt_dir) == target
    assert os.stat(step4).st_ino == written, "the relaunch wrote step 4 again: it did not resume"
    before, after = (CIO.load_checkpoint(f"{ckpt_dir}/step_{s}") for s in (4, target))
    assert after["step"] == target
    moved = [k for k, v in after["model"].items() if not torch.equal(v, before["model"][k])]
    assert moved and all(torch.isfinite(v).all() for v in after["model"].values())
    assert all(np.isfinite(float(m)) for m in _probe_loss(after))


def _probe_loss(payload) -> list:
    """The mel/KL loss of a checkpoint's weights on one fixed batch."""
    from openvoice_tpu_torch.training import train as T

    state = T.init_train_state(TINY, torch.Generator().manual_seed(0), 2e-3, "cpu")
    state.model.load_state_dict(payload["model"])
    rng = np.random.default_rng(123)
    spec = torch.from_numpy(np.abs(rng.standard_normal((2, 16, TINY.spec_channels))).astype(np.float32))
    audio = torch.from_numpy((rng.standard_normal((2, 16 * TINY.hop_length)) * 0.1).astype(np.float32))
    _, metrics = T.train_step(state, TINY, spec, audio, torch.tensor([16, 12]),
                              torch.zeros(2, 1, TINY.gin_channels), torch.Generator().manual_seed(5),
                              segment_frames=16, lr=0.0)
    return list(metrics.values())
