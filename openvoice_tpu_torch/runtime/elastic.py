"""Elastic recovery: detect a dead process, start a shrunk world again, and
re-run the work in flight (the port of ``openvoice_tpu/runtime/elastic.py``).

Recovery is relaunch-based, as in the JAX package: work is persisted in a
`WorkLog` (requests up front, each result atomically as it completes), so
nothing is lost with a process; workers beat a heartbeat between collective
rounds (``runtime/multihost.py::HeartbeatMonitor``); a survivor that finds a
peer gone exits with `EX_TEMPFAIL`; and a supervisor relaunches a SHRUNK
world (world − 1, minimum 1) on a fresh rendezvous, whose workers reload the
weights from the log and run only the requests still pending.

Where XLA terminates the survivors of a dead peer, a dead gloo or NCCL peer
makes the survivor's next collective raise instead.  Both routes end the
same way here: a failed heartbeat, or a collective that raises in a world
of more than one process, exits the survivor with `EX_TEMPFAIL` at once
(``os._exit``: a process group with a dead member must not be torn down
from a thread that is still blocked in it).

The log's layout is the JAX package's, file for file (``requests.npz``,
``params.npz`` with the JAX-layout parameter tree, ``done/<id>.npy``), so a
state directory written by either package is read by the other.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

EX_TEMPFAIL = 75  # voluntary survivor exit: "peer lost, relaunch me"


def _tempfail(who: str, why: str) -> None:
    print(f"[{who}] {why}; exiting for shrunk-world relaunch", flush=True)
    sys.stderr.flush()
    os._exit(EX_TEMPFAIL)


# ---------------------------------------------------------------------------
# Work log: the persistent request/result state that survives processes
# ---------------------------------------------------------------------------

class WorkLog:
    """Directory-backed request/result log.

    Layout: ``requests.npz`` (the full batch, written once up front),
    ``params.npz`` (the converter's weights as the JAX package's parameter
    tree, for worker reload), ``done/<id>.npy`` (one result per completed
    request, written atomically via tmp-then-rename so a killed writer never
    leaves a half result).
    """

    def __init__(self, state_dir: str):
        self.dir = state_dir
        os.makedirs(os.path.join(state_dir, "done"), exist_ok=True)

    # -- requests --------------------------------------------------------

    def write_requests(self, requests: list[dict]) -> None:
        """Each request: dict with spec [T, F], n_frames, g_src, g_tgt, tau,
        seed.  Request id = position in this list."""
        flat = {}
        for i, r in enumerate(requests):
            for k, v in r.items():
                flat[f"{i}/{k}"] = np.asarray(v)
        flat["n_requests"] = np.asarray(len(requests))
        np.savez(os.path.join(self.dir, "requests.npz"), **flat)

    def load_requests(self) -> list[dict]:
        with np.load(os.path.join(self.dir, "requests.npz")) as z:
            n = int(z["n_requests"])
            return [{k.split("/", 1)[1]: z[k] for k in z.files if k.startswith(f"{i}/")} for i in range(n)]

    # -- params ----------------------------------------------------------

    def write_params(self, model) -> None:
        """A converter `Synthesizer` as ``params.npz``, the JAX package's
        parameter tree (what its WorkLog writes and reads)."""
        from openvoice_tpu_torch.ckpt.from_jax import synthesizer_to_jax
        from openvoice_tpu_torch.ckpt.native_io import save_npz

        save_npz(os.path.join(self.dir, "params.npz"), synthesizer_to_jax(model))

    def load_model(self, cfg):
        """``params.npz`` as a CPU `Synthesizer` of `cfg`."""
        from openvoice_tpu_torch.ckpt.from_jax import synthesizer_from_jax
        from openvoice_tpu_torch.ckpt.native_io import load_npz

        return synthesizer_from_jax(load_npz(os.path.join(self.dir, "params.npz")), cfg).eval()

    # -- results ---------------------------------------------------------

    def mark_done(self, req_id: int, audio: np.ndarray) -> None:
        final = os.path.join(self.dir, "done", f"{req_id}.npy")
        # np.save appends .npy unless the path already ends with it
        tmp = os.path.join(self.dir, "done", f".tmp.{os.getpid()}.{req_id}.npy")
        np.save(tmp, np.asarray(audio))
        os.replace(tmp, final)

    def done_ids(self) -> set[int]:
        return {int(f[:-4]) for f in os.listdir(os.path.join(self.dir, "done"))
                if f.endswith(".npy") and not f.startswith(".")}  # skip tmp files

    def load_result(self, req_id: int) -> np.ndarray:
        return np.load(os.path.join(self.dir, "done", f"{req_id}.npy"))

    def pending_ids(self, n_total: int | None = None) -> list[int]:
        if n_total is None:
            n_total = len(self.load_requests())
        done = self.done_ids()
        return [i for i in range(n_total) if i not in done]


def dist_request(r: dict):
    """A logged request (numpy fields) → a `serve.distributed.DistRequest`."""
    from openvoice_tpu_torch.serve.distributed import DistRequest

    return DistRequest(spec=np.asarray(r["spec"], np.float32), n_frames=int(r["n_frames"]),
                       g_src=np.asarray(r["g_src"], np.float32), g_tgt=np.asarray(r["g_tgt"], np.float32),
                       tau=float(r["tau"]), seed=int(r["seed"]))


def start_world(coordinator: str | None, num_processes: int, process_id: int, *, device=None, backend=None,
                heartbeat_timeout_s: float = 8.0):
    """Join the process group (none for a world of one) and build the global
    mesh (model axis 1) and a heartbeat; a collective of the group gives up
    after ten heartbeats, so a peer that stops answering without closing
    its connections still ends the round.  `device` and `backend` as in
    `multihost.initialize`."""
    from openvoice_tpu_torch.runtime import multihost as MH

    if num_processes > 1:
        MH.initialize(coordinator_address=coordinator, num_processes=num_processes, process_id=process_id,
                      device=device, backend=backend, timeout_s=max(60.0, 10 * heartbeat_timeout_s))
    mesh = MH.global_mesh(model_parallel=1, devices=None if device is None else [device])
    return mesh, MH.HeartbeatMonitor(timeout_s=heartbeat_timeout_s, device=device)


# ---------------------------------------------------------------------------
# Worker: one process of the (possibly shrunk) world
# ---------------------------------------------------------------------------

def worker_main(
    state_dir: str,
    cfg,
    *,
    coordinator: str | None,
    num_processes: int,
    process_id: int,
    max_batch: int = 2,
    heartbeat_timeout_s: float = 8.0,
    round_sleep_s: float = 0.0,
    die_after_round: int | None = None,
    device: str | torch.device | None = None,
    backend: str | None = None,
) -> None:
    """Process this world's share of the WorkLog's pending requests (f32).

    Collective-lockstep: every process computes the SAME deterministic
    assignment (pending ids sorted, process p takes slice p::world) and the
    SAME total round count, passing [] rounds when out of local work, so all
    processes enter every collective together.  A heartbeat guards each
    round; on failure, or when a round's collective raises, the survivor
    exits EX_TEMPFAIL for the Supervisor to relaunch a shrunk world.

    die_after_round: fault injection, a hard exit(9) after completing that
    round, simulating a mid-stream death.  `device` / `backend`: where this
    process runs and the group's backend (`multihost.initialize`)."""
    from openvoice_tpu_torch.serve.distributed import DistributedConvertService

    who = f"elastic worker {process_id}"
    mesh, monitor = start_world(coordinator, num_processes, process_id, device=device, backend=backend,
                                heartbeat_timeout_s=heartbeat_timeout_s)
    log = WorkLog(state_dir)
    svc = DistributedConvertService(log.load_model(cfg), cfg, mesh, device=device)
    requests = log.load_requests()

    # deterministic assignment, agreed by construction (same files, same
    # sort): the done/ set is stable at start-up because no worker is
    # mid-flight when a world launches
    pending = log.pending_ids(len(requests))
    mine = pending[process_id::num_processes]
    per_proc = [len(pending[p::num_processes]) for p in range(num_processes)]
    n_rounds = max((-(-c // max_batch) for c in per_proc), default=0)

    for rnd in range(n_rounds):
        if not monitor.beat():
            _tempfail(who, "peer lost")
        ids = mine[rnd * max_batch : (rnd + 1) * max_batch]
        try:
            outs = svc.convert_round([dist_request(requests[i]) for i in ids])
        except RuntimeError as exc:  # torch.distributed's errors (DistError) are RuntimeErrors
            if num_processes == 1:
                raise
            _tempfail(who, f"a round's collective failed ({exc!r})")
        for i, audio in zip(ids, outs):
            log.mark_done(i, audio)
        if die_after_round is not None and rnd == die_after_round:
            os._exit(9)  # injected mid-stream death
        if round_sleep_s:
            time.sleep(round_sleep_s)  # test hook: widen the kill window
    print(f"[{who}] done ({len(mine)} requests)", flush=True)


# ---------------------------------------------------------------------------
# Supervisor: launch, watch, shrink, relaunch
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _RelaunchSupervisor:
    """Shared launch-watch-shrink loop: launches a world of worker processes,
    and on any failure relaunches a SHRUNK world until `done()` says the job
    is complete.

    ``worker_cmd(coordinator, num_processes, process_id) -> argv`` builds one
    worker's command line (tests point it at tests/_torch_elastic*_child.py;
    a deployment points it at its launcher).  Subclasses define done()."""

    def __init__(self, worker_cmd, *, world: int, max_restarts: int = 3, env: dict | None = None):
        self.worker_cmd = worker_cmd
        self.world = world
        self.max_restarts = max_restarts
        self.env = env if env is not None else dict(os.environ)
        self.restarts = 0
        self.history: list[dict] = []

    def done(self) -> bool:
        raise NotImplementedError

    def run(self, timeout_s: float = 600.0) -> bool:
        """True when done().  Each attempt launches `world` workers; on any
        failure the next attempt runs with world − 1, minimum 1: the shrunk
        world.  Every worker is stopped before this returns."""
        deadline = time.monotonic() + timeout_s
        while True:
            if self.done():
                return True
            if self.restarts > self.max_restarts or time.monotonic() > deadline:
                return False
            world = max(1, self.world)
            coordinator = f"127.0.0.1:{_free_port()}" if world > 1 else None
            procs = [subprocess.Popen(self.worker_cmd(coordinator, world, pid), env=self.env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for pid in range(world)]
            rcs, outs = [], []
            try:
                for p in procs:
                    try:
                        out, _ = p.communicate(timeout=max(5.0, deadline - time.monotonic()))
                    except subprocess.TimeoutExpired:
                        p.kill()
                        out, _ = p.communicate()
                    outs.append(out)
                    rcs.append(p.returncode)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            self.history.append({"world": world, "rcs": rcs, "outs": outs})
            if all(rc == 0 for rc in rcs) and self.done():
                return True
            # Shrink by ONE per failed attempt, not by the count of
            # non-TEMPFAIL exits: one real death can take down peers blocked
            # in a collective with codes indistinguishable from the root
            # cause, so counting them would collapse an N-process world to 1
            # on a single failure.
            hard_failed = any(rc not in (0, EX_TEMPFAIL) for rc in rcs)
            self.world = max(1, world - (1 if hard_failed else 0))
            self.restarts += 1


class Supervisor(_RelaunchSupervisor):
    """Convert-serving supervisor: done = every WorkLog request has a
    result (results accrue atomically as workers complete them)."""

    def __init__(self, state_dir: str, worker_cmd, *, world: int, max_restarts: int = 3,
                 env: dict | None = None):
        super().__init__(worker_cmd, world=world, max_restarts=max_restarts, env=env)
        self.log = WorkLog(state_dir)
        self._n_total: int | None = None

    def done(self) -> bool:
        if self._n_total is None:
            self._n_total = len(self.log.load_requests())
        return not self.log.pending_ids(self._n_total)


class TrainSupervisor(_RelaunchSupervisor):
    """Elastic training supervisor: done = the checkpoint directory holds a
    step ≥ target.  A relaunched world, shrunk or not, resumes from
    ``ckpt/native_io.py::latest_step`` through ``training/loop.py::train``'s
    resume path, so a death mid-training costs at most `ckpt_every` steps
    of rework."""

    def __init__(self, ckpt_dir: str, target_step: int, worker_cmd, *, world: int, max_restarts: int = 3,
                 env: dict | None = None):
        super().__init__(worker_cmd, world=world, max_restarts=max_restarts, env=env)
        self.ckpt_dir = ckpt_dir
        self.target_step = target_step

    def done(self) -> bool:
        from openvoice_tpu_torch.ckpt.native_io import latest_step

        step = latest_step(self.ckpt_dir)
        return step is not None and step >= self.target_step


def train_worker_main(
    data_root: str,
    ckpt_dir: str,
    cfg,
    *,
    coordinator: str | None,
    num_processes: int,
    process_id: int,
    steps: int,
    batch_size: int = 4,
    segment_frames: int = 16,
    ckpt_every: int = 4,
    lr: float = 2e-4,
    adversarial: bool = False,
    die_after_step: int | None = None,
    heartbeat_timeout_s: float = 8.0,
    heartbeat_every: int = 1,
    device: str | torch.device | None = None,
    backend: str | None = None,
) -> None:
    """One process of an elastic training world: join the group and build
    the global mesh, then run ``training/loop.py::train`` with checkpoint and
    resume wired (the loop resumes from latest_step itself, so this worker
    is restartable at any point).  A heartbeat every `heartbeat_every` steps,
    or a step whose collective raises, exits a survivor EX_TEMPFAIL; the
    TrainSupervisor relaunches either way.

    die_after_step: fault injection, a hard exit(9) right after that step's
    checkpoint gate, simulating a mid-training death."""
    from openvoice_tpu_torch.training.loop import train

    who = f"elastic train worker {process_id}"
    mesh, monitor = start_world(coordinator, num_processes, process_id, device=device, backend=backend,
                                heartbeat_timeout_s=heartbeat_timeout_s)

    def on_step(step: int, metrics) -> None:
        if die_after_step is not None and step >= die_after_step:
            os._exit(9)  # injected mid-training death
        if num_processes > 1 and step % max(1, heartbeat_every) == 0 and not monitor.beat():
            _tempfail(who, "peer lost")

    try:
        train(data_root, cfg, steps=steps, batch_size=batch_size, segment_frames=segment_frames, lr=lr,
              adversarial=adversarial, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
              mesh=mesh if num_processes > 1 else None, log_every=0, on_step=on_step,
              device=device if num_processes == 1 else None)
    except RuntimeError as exc:  # torch.distributed's errors (DistError) are RuntimeErrors
        if num_processes == 1:
            raise
        _tempfail(who, f"a step's collective failed ({exc!r})")
    print(f"[{who}] reached step {steps}", flush=True)
