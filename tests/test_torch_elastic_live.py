"""The port's live elastic serving (``serve/elastic_live.py``) against the
JAX package's (tests/test_elastic_live.py): the live log's appends, stop
marker and concurrent unique ids, and a live HTTP stream into a two-process
world that loses a worker mid-stream (a die-after marker), relaunches
shrunk, and answers every request with JAX's single-process truth."""

import base64
import dataclasses
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from openvoice_tpu.serve.elastic_live import LiveWorkLog as JaxLiveWorkLog
from openvoice_tpu_torch.serve.elastic_live import ElasticConvertClient, LiveSupervisor, LiveWorkLog, serve_elastic
from tests._torch_elastic_child import TINY
from tests._torch_port import AUDIO_TOL, jax_params
from tests._torch_port import jax_elastic_truth as jax_truth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_REQUESTS = 8
N_FRAMES_CHOICES = (16, 20, 24)


def _payload(i: int, rng: np.random.Generator) -> dict:
    nf = N_FRAMES_CHOICES[i % len(N_FRAMES_CHOICES)]
    return {"spec": np.abs(rng.standard_normal((nf, TINY.spec_channels))).astype(np.float32),
            "g_src": rng.standard_normal(TINY.gin_channels).astype(np.float32),
            "g_tgt": rng.standard_normal(TINY.gin_channels).astype(np.float32), "tau": 0.3, "seed": 900 + i}


def test_live_worklog_append_and_stop(tmp_path):
    """The port appends what the JAX log reads, and the other way round."""
    log = LiveWorkLog(str(tmp_path))
    rng = np.random.default_rng(0)
    ids = [log.append_request(_payload(i, rng)) for i in range(3)]
    assert ids == [0, 1, 2]
    jlog = JaxLiveWorkLog(str(tmp_path))
    assert jlog.append_request(_payload(3, rng)) == 3
    assert log.request_ids() == jlog.request_ids() == [0, 1, 2, 3]
    assert int(log.load_request(3)["seed"]) == 903 and int(jlog.load_request(2)["seed"]) == 902
    log.mark_done(1, np.ones(3, np.float32))
    assert log.live_pending_ids() == jlog.live_pending_ids() == [0, 2, 3]
    assert not log.stop_requested()
    log.signal_stop()
    assert log.stop_requested() and jlog.stop_requested()


def test_live_worklog_concurrent_feeders_unique_ids(tmp_path):
    log = LiveWorkLog(str(tmp_path))
    payload = _payload(0, np.random.default_rng(1))
    got: list[int] = []
    lock = threading.Lock()

    def feed():
        for _ in range(8):
            i = log.append_request(payload)
            with lock:
                got.append(i)

    threads = [threading.Thread(target=feed) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(got) == list(range(32))  # no collisions, no gaps


@pytest.fixture(scope="module")
def params():
    return jax_params(dataclasses.asdict(TINY), seed=0)


def test_live_stream_http_death_mid_stream_completes_all(tmp_path, params):
    """Requests arrive over HTTP, one every 0.4 s, into a two-process world;
    worker 1 dies after completing 2; the world relaunches at 1 and every
    answer equals JAX's single-process truth."""
    from openvoice_tpu.runtime.elastic import WorkLog as JaxWorkLog

    state = str(tmp_path / "state")
    log = LiveWorkLog(state)
    JaxWorkLog(state).write_params(params)  # the JAX package's params.npz
    marker = str(tmp_path / "die.marker")

    def cmd(coordinator, world, pid):
        return [sys.executable, "-m", "tests._torch_elastic_child", "live", state, coordinator or "none",
                str(world), str(pid), f"1:2:{marker}"]

    sup = LiveSupervisor(state, cmd, world=2, max_restarts=3, env={**os.environ, "PYTHONPATH": ROOT})
    result: dict = {}
    sup_thread = threading.Thread(target=lambda: result.update(ok=sup.run(timeout_s=240)), daemon=True)
    sup_thread.start()
    httpd = serve_elastic(ElasticConvertClient(state, TINY))
    port = httpd.server_address[1]

    rng = np.random.default_rng(42)
    payloads = [_payload(i, rng) for i in range(N_REQUESTS)]
    responses: list = [None] * N_REQUESTS
    errors: list = []

    def post(i: int) -> None:
        p = payloads[i]
        body = json.dumps({"spec_b64": base64.b64encode(p["spec"].tobytes()).decode(),
                           "n_frames": int(p["spec"].shape[0]), "src_se": p["g_src"].tolist(),
                           "tgt_se": p["g_tgt"].tolist(), "tau": p["tau"], "seed": p["seed"],
                           "timeout": 200}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/convert", data=body,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=220) as r:
                responses[i] = np.frombuffer(base64.b64decode(json.loads(r.read())["audio_b64"]), np.float32)
        except Exception as exc:  # noqa: BLE001 — surfaced by the assert below
            errors.append((i, repr(exc)))

    threads = []
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
        for i in range(N_REQUESTS):
            t = threading.Thread(target=post, args=(i,), daemon=True)
            t.start()
            threads.append(t)
            time.sleep(0.4)
        for t in threads:
            t.join(timeout=230)
        assert not errors, errors
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/pending", timeout=10) as r:
            assert json.loads(r.read()) == {"pending": []}
        log.signal_stop()
        sup_thread.join(timeout=120)
        assert result.get("ok"), f"supervisor failed: {sup.history}"
    finally:
        log.signal_stop()
        httpd.shutdown()
        sup_thread.join(timeout=120)

    assert os.path.exists(marker), "fault injection never fired"
    assert [h["world"] for h in sup.history] == [2, 1], sup.history
    assert sup.history[0]["rcs"][1] == 9, sup.history[0]
    for i, p in enumerate(payloads):
        ref = jax_truth(params, {**p, "n_frames": p["spec"].shape[0]})
        assert responses[i].shape == ref.shape, i
        np.testing.assert_allclose(responses[i], ref, atol=AUDIO_TOL, err_msg=f"request {i}")
