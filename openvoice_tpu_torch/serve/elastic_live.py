"""Live elastic multi-process serving (the port of
``openvoice_tpu/serve/elastic_live.py``): the lock-step rounds of
``serve/distributed.py`` and the elastic re-runs of ``runtime/elastic.py``
composed for a stream.

Requests arrive over time, at any process, behind an HTTP tier; a ROUND
PACER turns them into paced collective rounds (processes with no work
contribute empty rounds, whose padding rows cost nothing); every request
and result persists in a `LiveWorkLog`, so a death mid-stream costs
nothing: the relaunched (shrunk) world picks up exactly the pending
requests while new ones keep arriving.

Every process must enter the same collectives in the same order, so
free-running per-process consumers are impossible: the pacer is the
scheduler, and all coordination reduces to one small metadata all-gather a
round (stop vote and pending count) and the file system's atomic rename.
A request goes to process ``id % world``: stable under inconsistent
directory views (two processes may see different request subsets
mid-write), where slicing a sorted list could hand one id to two processes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from openvoice_tpu_torch.runtime.elastic import WorkLog, _RelaunchSupervisor, _tempfail, dist_request, start_world


# ---------------------------------------------------------------------------
# Live work log: requests appended while workers run
# ---------------------------------------------------------------------------

class LiveWorkLog(WorkLog):
    """A WorkLog whose request set GROWS over time.

    Each request is one file ``req/<id>.npz`` made visible atomically
    (tmp-then-link, so a reader never sees a half request and two feeders
    never claim the same id); results reuse the parent's atomic
    ``done/<id>.npy``.  A ``stop`` marker file asks the world to drain and
    exit once nothing is pending."""

    def __init__(self, state_dir: str):
        super().__init__(state_dir)
        os.makedirs(os.path.join(state_dir, "req"), exist_ok=True)

    # -- append-only request files --------------------------------------

    def append_request(self, req: dict) -> int:
        """Persist one request, returns its id.  Safe under concurrent
        feeders: the hard link fails with EEXIST on an id collision and the
        next id is tried."""
        tmp = os.path.join(self.dir, "req", f".tmp.{os.getpid()}.{time.monotonic_ns()}.npz")
        np.savez(tmp, **{k: np.asarray(v) for k, v in req.items()})
        try:
            req_id = self._next_id()
            while True:
                try:
                    os.link(tmp, os.path.join(self.dir, "req", f"{req_id}.npz"))
                    return req_id
                except FileExistsError:
                    req_id += 1
        finally:
            os.unlink(tmp)

    def _next_id(self) -> int:
        ids = self.request_ids()
        return (max(ids) + 1) if ids else 0

    def request_ids(self) -> list[int]:
        return sorted(int(f[:-4]) for f in os.listdir(os.path.join(self.dir, "req"))
                      if f.endswith(".npz") and not f.startswith("."))

    def load_request(self, req_id: int) -> dict:
        with np.load(os.path.join(self.dir, "req", f"{req_id}.npz")) as z:
            return {k: z[k] for k in z.files}

    def live_pending_ids(self) -> list[int]:
        done = self.done_ids()
        return [i for i in self.request_ids() if i not in done]

    # -- drain signal ----------------------------------------------------

    def signal_stop(self) -> None:
        open(os.path.join(self.dir, "stop"), "w").close()

    def stop_requested(self) -> bool:
        return os.path.exists(os.path.join(self.dir, "stop"))


# ---------------------------------------------------------------------------
# Round pacer: the worker-side loop
# ---------------------------------------------------------------------------

def live_worker_main(
    state_dir: str,
    cfg,
    *,
    coordinator: str | None,
    num_processes: int,
    process_id: int,
    max_batch: int = 2,
    cadence_s: float = 0.05,
    heartbeat_timeout_s: float = 8.0,
    die_after_done: int | None = None,
    device: str | torch.device | None = None,
    backend: str | None = None,
) -> None:
    """One process of the live serving world (f32).  Each round, in
    lock-step:

    1. heartbeat (a dead peer turns into a prompt EX_TEMPFAIL exit instead
       of a hung collective);
    2. one metadata all-gather: (my stop vote, my pending-assigned count),
       so every process sees the same totals and the stop is agreed without
       more coordination;
    3. `convert_round` over up to `max_batch` of MY pending requests
       (id % world == process_id), possibly none;
    4. results land atomically in done/.

    Exits 0 only on the agreed stop (stop marker seen everywhere AND zero
    pending globally); a collective that raises exits EX_TEMPFAIL.
    die_after_done: fault injection, a hard exit(9) once this process has
    completed that many requests."""
    from openvoice_tpu_torch.serve.distributed import DistributedConvertService, all_gather_int64

    who = f"live worker {process_id}"
    mesh, monitor = start_world(coordinator, num_processes, process_id, device=device, backend=backend,
                                heartbeat_timeout_s=heartbeat_timeout_s)
    log = LiveWorkLog(state_dir)
    svc = DistributedConvertService(log.load_model(cfg), cfg, mesh, device=device)
    completed = 0

    while True:
        if not monitor.beat():
            _tempfail(who, "peer lost")
        mine = [i for i in log.live_pending_ids() if i % num_processes == process_id]
        try:
            allmeta = all_gather_int64([int(log.stop_requested()), len(mine)], mesh)
            if bool(allmeta[:, 0].all()) and int(allmeta[:, 1].sum()) == 0:
                break
            batch_ids = mine[:max_batch]
            outs = svc.convert_round([dist_request(log.load_request(i)) for i in batch_ids])  # also when empty
        except RuntimeError as exc:  # torch.distributed's errors (DistError) are RuntimeErrors
            if num_processes == 1:
                raise
            _tempfail(who, f"a round's collective failed ({exc!r})")
        for i, audio in zip(batch_ids, outs):
            log.mark_done(i, audio)
            completed += 1
            if die_after_done is not None and completed >= die_after_done:
                os._exit(9)  # injected mid-stream death
        if not batch_ids:
            time.sleep(cadence_s)  # idle round: don't spin the file system
    print(f"[{who}] drained ({completed} completed)", flush=True)


class LiveSupervisor(_RelaunchSupervisor):
    """Relaunch supervisor for the live stream: done = the feeders have
    signalled stop AND every appended request has a result."""

    def __init__(self, state_dir: str, worker_cmd, *, world: int, max_restarts: int = 3,
                 env: dict | None = None):
        super().__init__(worker_cmd, world=world, max_restarts=max_restarts, env=env)
        self.log = LiveWorkLog(state_dir)

    def done(self) -> bool:
        return self.log.stop_requested() and not self.log.live_pending_ids()


# ---------------------------------------------------------------------------
# Per-process front end: HTTP tier over the live log
# ---------------------------------------------------------------------------

class ElasticConvertClient:
    """Submit/await over the LiveWorkLog: what the HTTP tier (and tests)
    use.  Results are awaited by polling the atomic done files; the serving
    world may die and relaunch underneath without the client noticing
    anything but latency."""

    def __init__(self, state_dir: str, cfg, poll_s: float = 0.02):
        self.log = LiveWorkLog(state_dir)
        self.cfg = cfg
        self.poll_s = poll_s

    def submit(self, spec: np.ndarray, g_src, g_tgt, tau: float = 0.3, seed: int = 0) -> int:
        spec = np.asarray(spec, np.float32)
        return self.log.append_request({
            "spec": spec, "n_frames": np.int64(spec.shape[0]),
            "g_src": np.asarray(g_src, np.float32).reshape(-1),
            "g_tgt": np.asarray(g_tgt, np.float32).reshape(-1),
            "tau": np.float64(tau), "seed": np.int64(seed),
        })

    def result(self, req_id: int, timeout: float = 120.0) -> np.ndarray:
        deadline = time.monotonic() + timeout
        path = os.path.join(self.log.dir, "done", f"{req_id}.npy")
        while time.monotonic() < deadline:
            if os.path.exists(path):
                return self.log.load_result(req_id)
            time.sleep(self.poll_s)
        raise TimeoutError(f"request {req_id} not completed in {timeout}s")

    def convert(self, spec, g_src, g_tgt, tau: float = 0.3, seed: int = 0, timeout: float = 120.0) -> np.ndarray:
        return self.result(self.submit(spec, g_src, g_tgt, tau, seed), timeout)


def make_elastic_handler(client: ElasticConvertClient):
    """HTTP handler over the live elastic world: POST /convert with
    {spec_b64 [T, F] f32, n_frames, src_se, tgt_se, tau?, seed?, timeout?}
    → {"encoding": "f32", "audio_b64"}; GET /healthz; GET /pending.  A
    failed request answers 500 with its error and leaves the server up."""
    import base64
    import json
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, code: int, payload: dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/pending":
                self._json(200, {"pending": client.log.live_pending_ids()})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/convert":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                n_frames = int(req["n_frames"])
                spec = np.frombuffer(base64.b64decode(req["spec_b64"]), np.float32).reshape(n_frames, -1)
                out = client.convert(spec, np.asarray(req["src_se"], np.float32),
                                     np.asarray(req["tgt_se"], np.float32), tau=float(req.get("tau", 0.3)),
                                     seed=int(req.get("seed", 0)), timeout=float(req.get("timeout", 120.0)))
                self._json(200, {"encoding": "f32",
                                 "audio_b64": base64.b64encode(np.asarray(out, np.float32).tobytes()).decode()})
            except Exception as exc:  # noqa: BLE001 — per-request isolation: answered as a 500
                self._json(500, {"error": f"[ERROR] {exc}"})

    return Handler


def serve_elastic(client: ElasticConvertClient, host: str = "127.0.0.1", port: int = 0):
    """Start the HTTP tier; returns the ThreadingHTTPServer (its
    .server_address carries the bound port when port=0)."""
    import threading
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer((host, port), make_elastic_handler(client))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
