"""Child process of the two-process ``torch.distributed`` test of the port
(tests/test_torch_multihost.py::test_two_process_gloo_run).

Run as ``python -m tests._torch_multiproc_child <host:port> <num_procs>
<pid> <workdir>``.  Each process joins the gloo group through
``runtime.multihost.initialize`` (the real start-up, not the one-process
no-op), builds the global mesh, and checks against results it computes
alone, on the whole batch:

* a global batch from each process's rows (``make_global_batch``) and its
  sum;
* one data-parallel convert in each mode (``data_parallel_convert``);
* the sequence-parallel and the tensor-parallel convert on a 1×2 mesh
  across the two processes (the halo's send/recv, the all-gather and the
  all-reduce between processes);
* one data-parallel ``train_step`` and one ``gan_train_step`` in float64:
  the losses and every gradient leaf each step applies, within 1e-10 of the
  leaf's peak, the rows of unequal lengths (the KL's weighting);
* two steps of ``train(mesh=)`` on each process's shard of a small set,
  after which both processes hold the same weights;
* a heartbeat.

It imports neither JAX nor the JAX package.  Exit code 0 means every check
passed in this process.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(2)

from openvoice_tpu_torch.audio.io import write_wav  # noqa: E402
from openvoice_tpu_torch.config import SynthesizerConfig  # noqa: E402
from openvoice_tpu_torch.models import synthesizer as S  # noqa: E402
from openvoice_tpu_torch.runtime import multihost as MH  # noqa: E402
from openvoice_tpu_torch.runtime.parallel import TensorParallel, data_parallel_convert  # noqa: E402
from openvoice_tpu_torch.runtime.sequence_parallel import required_halo, voice_conversion_sp  # noqa: E402
from openvoice_tpu_torch.training import train as T  # noqa: E402
from openvoice_tpu_torch.training.data import make_global_batch  # noqa: E402
from openvoice_tpu_torch.training.loop import train  # noqa: E402

# the JAX child's small converter (tests/_multiproc_child.py), with shallow
# WaveNets so that a 64-frame clip splits in two shards longer than the halo
CFG = SynthesizerConfig(
    spec_channels=33, inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.0, resblock="2", resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
    upsample_rates=(4,), upsample_initial_channel=16, upsample_kernel_sizes=(8,), n_speakers=0,
    gin_channels=8, zero_g=True, filter_length=64, hop_length=4, win_length=64,
    enc_q_layers=4, flow_n_flows=2, flow_wn_layers=2,
)


def _model(seed: int = 0) -> S.Synthesizer:
    """The same random converter in every process, its flow exercised."""
    model = S.init_synthesizer(CFG, torch.Generator().manual_seed(seed)).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for flow in model.flow.flows[::2]:
            flow.post.weight.normal_(0.0, 0.1, generator=gen)
            flow.post.bias.normal_(0.0, 0.1, generator=gen)
    return model


def _close(got: torch.Tensor, ref: torch.Tensor, atol: float, what: str) -> None:
    err = float((got - ref).abs().max())
    assert got.shape == ref.shape and err <= atol, f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}, err {err}"


def _grads_recorder():
    """Wrap `train._apply_grads` to keep the gradients each update applies."""
    seen: list[list[torch.Tensor]] = []
    original = T._apply_grads

    def record(state, grads, lr):
        seen.append([g.detach().clone() for g in grads])
        original(state, grads, lr)

    T._apply_grads = record
    return seen, original


def _check_leaves(dp: list[torch.Tensor], ref: list[torch.Tensor], what: str) -> None:
    assert len(dp) == len(ref) > 0
    for i, (a, b) in enumerate(zip(dp, ref)):
        peak = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-10 * peak or err == 0.0, f"{what} leaf {i}: err {err:.3e}, peak {peak:.3e}"


def main() -> None:
    coordinator, n, pid, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    topo = MH.initialize(coordinator_address=coordinator, num_processes=n, process_id=pid, device="cpu",
                         timeout_s=120.0)
    assert (topo.process_id, topo.num_processes) == (pid, n), topo
    assert topo.global_device_count == n and dist.get_backend() == "gloo", topo
    mesh = MH.global_mesh(model_parallel=1)
    assert mesh.shape == {"data": n, "model": 1} and mesh.local_coords() == [(pid, 0)], mesh

    # --- a global batch from each process's rows, and its sum
    local = torch.arange(4, dtype=torch.float32)[:, None] + 10.0 * pid
    batch = make_global_batch(local, mesh)
    assert batch.shape == (4 * n, 1)
    expected = sum(float(np.sum(np.arange(4) + 10.0 * p)) for p in range(n))
    assert abs(float(batch.sum()) - expected) < 1e-6
    whole = batch.gather()
    assert torch.equal(whole[:, 0], torch.cat([torch.arange(4.0) + 10.0 * p for p in range(n)]))

    # --- one data-parallel convert in each mode, against this process alone
    model = _model()
    b, t = 4 * n, 64
    rng = np.random.default_rng(7)  # the same in every process
    spec = torch.from_numpy(np.abs(rng.standard_normal((b, t, CFG.spec_channels))).astype(np.float32))
    lens = torch.from_numpy(rng.integers(t // 2, t + 1, size=b))
    gs = torch.from_numpy(rng.standard_normal((b, 1, CFG.gin_channels)).astype(np.float32) * 0.2)
    gt = torch.from_numpy(rng.standard_normal((b, 1, CFG.gin_channels)).astype(np.float32) * 0.2)
    noise = torch.from_numpy(rng.standard_normal((b, t, CFG.inter_channels)).astype(np.float32))
    rows = slice(4 * pid, 4 * (pid + 1))
    cache = S.make_dec_cache(model)
    with torch.inference_mode():
        for fast in (False, True):
            ref, _ = S.voice_conversion(model, spec, lens, gs, gt, 0.3, noise, fast=fast,
                                        dec_cache=cache if fast else None)
            out = data_parallel_convert(model, mesh, *(make_global_batch(x[rows], mesh)
                                                       for x in (spec, lens, gs, gt)), 0.3,
                                        make_global_batch(noise[rows], mesh), fast=fast)
            _close(out.local(), ref[rows], 1e-6 if fast else 1e-5, f"data-parallel convert fast={fast}")
            _close(out.gather(), ref, 1e-6 if fast else 1e-5, f"gathered convert fast={fast}")

        # --- sequence- and tensor-parallel convert across the two processes
        mp = MH.global_mesh(model_parallel=n)
        assert mp.shape == {"data": 1, "model": n}, mp
        ref, _ = S.voice_conversion(model, spec, lens, gs, gt, 0.3, noise)
        assert t // n >= required_halo(CFG)
        sp = voice_conversion_sp(model, spec, lens, gs, gt, 0.3, noise, mesh=mp)
        _close(sp.gather(), ref, 2e-5, "sequence-parallel convert")
        tp = TensorParallel(model, CFG, mp)
        layer = tp.models[(0, pid)].dec.conv_pre
        assert layer.weight.shape[0] == CFG.upsample_initial_channel // n, layer
        _close(tp.convert(spec, lens, gs, gt, 0.3, noise).gather(), ref, 2e-5, "tensor-parallel convert")
    print(f"child {pid}: convert ok", flush=True)

    # --- one data-parallel train step and one GAN step in float64
    tr = np.random.default_rng(55)
    b_tr, t_tr = 2 * n, 32
    tr_spec = torch.from_numpy(np.abs(tr.standard_normal((b_tr, t_tr, CFG.spec_channels))))
    tr_audio = torch.from_numpy(tr.standard_normal((b_tr, t_tr * CFG.hop_length)) * 0.1)
    tr_len = torch.from_numpy(np.array([t_tr, t_tr - 6, t_tr - 3, t_tr - 9][:b_tr]))
    tr_g = torch.from_numpy(tr.standard_normal((b_tr, 1, CFG.gin_channels)) * 0.1)
    mine = slice(2 * pid, 2 * (pid + 1))
    seen, original = _grads_recorder()
    try:
        for gan in (False, True):
            runs = []
            for dp in (True, False):
                init = torch.Generator().manual_seed(3)
                state = (T.init_gan_train_state if gan else T.init_train_state)(CFG, init, 1e-3, "cpu")
                for part in (state if gan else (state,)):
                    part.model.double()
                step = T.gan_train_step if gan else T.train_step
                draws = torch.Generator().manual_seed(9)
                seen.clear()
                if dp:
                    args = [make_global_batch(x[mine], mesh) for x in (tr_spec, tr_audio, tr_len, tr_g)]
                    _, metrics = step(state, CFG, *args, draws, segment_frames=16, lr=1e-3, mesh=mesh)
                else:
                    _, metrics = step(state, CFG, tr_spec, tr_audio, tr_len, tr_g, draws, segment_frames=16, lr=1e-3)
                runs.append(({k: float(v) for k, v in metrics.items()}, [list(s) for s in seen]))
            (m_dp, g_dp), (m_ref, g_ref) = runs
            assert m_dp.keys() == m_ref.keys()
            for k in m_ref:
                assert abs(m_dp[k] - m_ref[k]) <= 1e-10 * max(1.0, abs(m_ref[k])), (gan, k, m_dp[k], m_ref[k])
            assert len(g_dp) == len(g_ref) == (2 if gan else 1)
            for a, r in zip(g_dp, g_ref):
                _check_leaves(a, r, f"gan={gan}")
    finally:
        T._apply_grads = original
    print(f"child {pid}: training ok", flush=True)

    # --- train(mesh=) on each process's shard of one small set
    root = os.path.join(workdir, f"data{pid}")
    sr = CFG.sampling_rate
    for s in range(2):
        for i in range(2):
            clip = np.random.default_rng(10 * s + i).standard_normal(sr // 8).astype(np.float32) * 0.1
            write_wav(os.path.join(root, f"spk{s}", f"utt{i}.wav"), clip, sr)
    before = torch.cat([p.detach().reshape(-1) for p in S.init_synthesizer(CFG, torch.Generator().manual_seed(0)).parameters()])
    state = train(root, CFG, steps=2, batch_size=2, segment_frames=16, adversarial=False, mesh=mesh,
                  log_every=0, seed=0)
    after = torch.cat([p.detach().reshape(-1).float() for p in state.model.parameters()])
    everyone = [torch.empty_like(after) for _ in range(n)]
    dist.all_gather(everyone, after)
    assert all(torch.equal(everyone[0], x) for x in everyone), "the processes' weights diverged"
    assert state.step == 2 and not torch.equal(after, before)
    print(f"child {pid}: train(mesh=) ok", flush=True)

    assert MH.HeartbeatMonitor(timeout_s=60.0).beat()
    dist.barrier()
    dist.destroy_process_group()
    print(f"child {pid}: ok", flush=True)


if __name__ == "__main__":
    main()
