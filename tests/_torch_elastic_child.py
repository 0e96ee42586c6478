"""Child process of the port's elastic tests (tests/test_torch_distributed.py,
tests/test_torch_elastic.py, tests/test_torch_elastic_live.py), on the CPU
over gloo.  It imports neither JAX nor the JAX package.

    python -m tests._torch_elastic_child worker <state_dir> <coordinator|none> <world> <pid> [round_sleep_s] [die_spec]
    python -m tests._torch_elastic_child train  <data_root> <ckpt_dir> <coordinator|none> <world> <pid> <steps>
                                                [die_spec]
    python -m tests._torch_elastic_child live   <state_dir> <coordinator|none> <world> <pid> [die_spec]
    python -m tests._torch_elastic_child round  <state_dir> <coordinator> <world> <pid>

``worker``, ``train`` and ``live`` run ``runtime/elastic.py::worker_main``,
``train_worker_main`` and ``serve/elastic_live.py::live_worker_main``.
die_spec = "<pid>:<n>:<marker_path>": that process hard-exits(9) after round
n (worker), step n (train) or n completed requests (live), on the first
attempt only (the marker file gates it), so deaths come from markers and not
from timing.  ``round`` runs two `DistributedConvertService` rounds in a
two-process world (process 1 passes [] in the first) and checks each
process's audio against its one-process truth; it prints ``round ok``.

Heartbeats get 60 s: a dead gloo peer makes the survivor's collective raise
at once, so the timeout only bounds a peer that hangs, and a loaded test
machine never reaches it.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from openvoice_tpu_torch.config import SynthesizerConfig  # noqa: E402

# the JAX elastic tests' tiny converter (tests/_elastic_child.py::TINY)
TINY = SynthesizerConfig(
    spec_channels=33, inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.0, resblock="2", resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
    upsample_rates=(4,), upsample_initial_channel=16, upsample_kernel_sizes=(8,), n_speakers=0,
    gin_channels=8, zero_g=True, filter_length=64, hop_length=4, win_length=64,
)
HEARTBEAT_S = 60.0


def truth(model, req: dict) -> np.ndarray:
    """One-process f32 convert of one logged request, with the service's
    noise (its live frames from ``default_rng(seed)``)."""
    from openvoice_tpu_torch.models import synthesizer as S
    from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket

    nf = int(req["n_frames"])
    bucket = round_up_to_bucket(nf)
    spec = np.zeros((1, bucket, TINY.spec_channels), np.float32)
    spec[0, :nf] = req["spec"]
    noise = np.zeros((1, bucket, TINY.inter_channels), np.float32)
    noise[0, :nf] = np.random.default_rng(int(req["seed"])).standard_normal((nf, TINY.inter_channels))
    g_src = torch.from_numpy(np.asarray(req["g_src"], np.float32).reshape(1, 1, -1))
    g_tgt = torch.from_numpy(np.asarray(req["g_tgt"], np.float32).reshape(1, 1, -1))
    with torch.inference_mode():
        audio, _ = S.voice_conversion(model, torch.from_numpy(spec), torch.tensor([nf]), g_src, g_tgt,
                                      float(req["tau"]), torch.from_numpy(noise))
    return audio[0, : nf * TINY.upsample_factor, 0].numpy()


def _die_after(spec: str | None, pid: int) -> int | None:
    if not spec or spec == "none":
        return None
    die_pid, n, marker = spec.split(":", 2)
    if pid != int(die_pid) or os.path.exists(marker):
        return None
    open(marker, "w").close()
    return int(n)


def _round(state_dir: str, coordinator: str, world: int, pid: int) -> None:
    from openvoice_tpu_torch.runtime.elastic import WorkLog, dist_request, start_world
    from openvoice_tpu_torch.serve.distributed import DistributedConvertService

    mesh, _ = start_world(coordinator, world, pid, device="cpu", heartbeat_timeout_s=HEARTBEAT_S)
    log = WorkLog(state_dir)
    model = log.load_model(TINY)
    svc = DistributedConvertService(model, TINY, mesh, device="cpu")
    reqs = log.load_requests()
    plan = [[0, 1], [2]] if pid == 0 else [[], [3]]  # process 1 sits out the first round
    for ids in plan:
        outs = svc.convert_round([dist_request(reqs[i]) for i in ids])
        assert len(outs) == len(ids)
        for i, out in zip(ids, outs):
            ref = truth(model, reqs[i])
            err = float(np.abs(out - ref).max())
            assert out.shape == ref.shape and err <= 2e-5, (i, out.shape, ref.shape, err)
    print("round ok", flush=True)


def main() -> None:
    torch.set_num_threads(1)
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "round":
        _round(args[0], args[1], int(args[2]), int(args[3]))
        return
    if mode == "worker":
        from openvoice_tpu_torch.runtime.elastic import worker_main

        state_dir, coordinator, world, pid = args[0], args[1], int(args[2]), int(args[3])
        worker_main(state_dir, TINY, coordinator=None if coordinator == "none" else coordinator,
                    num_processes=world, process_id=pid, max_batch=2, heartbeat_timeout_s=HEARTBEAT_S,
                    round_sleep_s=float(args[4]) if len(args) > 4 else 0.0,
                    die_after_round=_die_after(args[5] if len(args) > 5 else None, pid), device="cpu")
    elif mode == "train":
        from openvoice_tpu_torch.runtime.elastic import train_worker_main

        data_root, ckpt_dir, coordinator = args[0], args[1], args[2]
        world, pid, steps = int(args[3]), int(args[4]), int(args[5])
        train_worker_main(data_root, ckpt_dir, TINY, coordinator=None if coordinator == "none" else coordinator,
                          num_processes=world, process_id=pid, steps=steps, batch_size=4, segment_frames=16,
                          ckpt_every=4, lr=2e-3, adversarial=False,
                          die_after_step=_die_after(args[6] if len(args) > 6 else None, pid),
                          heartbeat_timeout_s=HEARTBEAT_S, device="cpu")
    elif mode == "live":
        from openvoice_tpu_torch.serve.elastic_live import live_worker_main

        state_dir, coordinator, world, pid = args[0], args[1], int(args[2]), int(args[3])
        live_worker_main(state_dir, TINY, coordinator=None if coordinator == "none" else coordinator,
                         num_processes=world, process_id=pid, max_batch=2, cadence_s=0.05,
                         heartbeat_timeout_s=HEARTBEAT_S,
                         die_after_done=_die_after(args[4] if len(args) > 4 else None, pid), device="cpu")
    else:
        raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    main()
