"""Training loop driver (the port of ``openvoice_tpu/training/loop.py``):
data pipeline → (GAN) train step → checkpoints, with resume.

``train(root, cfg, steps=...)`` on one device, where each step replays the
train state's CUDA graph of the batch's shape after its first call
(`train.gan_train_step`; the prefetch thread pins each batch in host
memory, and the step stages it into the graph's inputs).  With
``torch.distributed`` initialised each process reads its own shard of the
files and only rank 0 writes checkpoints; with ``mesh=``
(`runtime.multihost.global_mesh`, one process per data position) each step
is data-parallel and eager: the processes' batches form one global batch
(`data.make_global_batch`) and the gradients are averaged over the data
axis.
"""

from __future__ import annotations

import time

import torch

from openvoice_tpu_torch.ckpt import native_io as CIO
from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.runtime.mesh import Mesh, pinned
from openvoice_tpu_torch.training import train as T
from openvoice_tpu_torch.training.data import (
    ConverterDataset, PrefetchIterator, make_global_batch, process_index_count,
)


def _host_batches(ds: ConverterDataset, device: torch.device):
    """The dataset's batches as host tensors, pinned where the steps copy
    them to the card (this runs in the prefetch worker thread)."""
    for batch in ds:
        tensors = tuple(torch.from_numpy(a) for a in batch)
        yield tuple(map(pinned, tensors)) if device.type == "cuda" else tensors


def train(data_root: str, cfg: SynthesizerConfig, *, steps: int = 1000, batch_size: int = 8,
          segment_frames: int = 128, lr: float = 2e-4, adversarial: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 500, mesh: Mesh | None = None, log_every: int = 50, seed: int = 0, on_step=None,
          device: str | torch.device | None = None) -> T.GanTrainState | T.TrainState:
    """Run optimizer steps until the step count reaches `steps`; returns the
    final state.

    adversarial=True uses the full GAN recipe (`train.gan_train_step`);
    False runs the mel + KL warm-up objective (`train.train_step`).  The
    decoder slice is min(32, segment_frames) frames.  With `ckpt_dir` the
    run resumes from its latest ``step_N``, saves every `ckpt_every` steps
    and at the end.  on_step(step, metrics), if given, fires after each
    step's checkpoint gate (progress callbacks, early stop by exception).
    The weights and every step's draws come from ``torch.Generator``s seeded
    by `seed`.  `device` as in `api.resolve_device`: the card unless the
    caller asks for the CPU; with `mesh`, this process's position's device.
    """
    if mesh is not None:
        if device is not None:
            raise ValueError("pass a device or a mesh, not both")
        device = mesh.devices[mesh.local_coords()[0]]
    dev = T.training_device(device)
    ds = ConverterDataset(data_root, cfg, batch_size, segment_frames, seed=seed)
    if len(ds.segments) < batch_size:
        raise ValueError(
            f"dataset yields {len(ds.segments)} segments < batch_size {batch_size}: no full batch can form "
            "(shorten segment_frames, lower batch_size, or add data)"
        )

    init_gen = torch.Generator().manual_seed(seed)
    if adversarial:
        state = T.init_gan_train_state(cfg, init_gen, lr, dev)
    else:
        state = T.init_train_state(cfg, init_gen, lr, dev)
    draws = torch.Generator().manual_seed(seed)
    writer = process_index_count()[0] == 0

    start_step = 0
    if ckpt_dir is not None:
        latest = CIO.latest_step(ckpt_dir)
        if latest is not None:
            state = CIO.load_checkpoint(f"{ckpt_dir}/step_{latest}", template=state)
            start_step = latest

    step_fn = T.gan_train_step if adversarial else T.train_step
    step = start_step
    t0 = time.time()
    while step < steps:
        epoch_start = step
        # host batch prep overlaps the device step; the with-block stops the
        # worker thread on early exit
        with PrefetchIterator(_host_batches(ds, dev)) as prefetch:
            for batch in prefetch:
                if step >= steps:
                    break
                if mesh is not None:
                    spec, audio, lengths, g = (make_global_batch(x, mesh) for x in batch)
                else:
                    spec, audio, lengths, g = batch
                state, metrics = step_fn(state, cfg, spec, audio, lengths, g, draws,
                                         segment_frames=min(32, segment_frames), lr=lr, mesh=mesh)
                step += 1
                if log_every and step % log_every == 0 and writer:
                    ms = {k: round(float(v), 4) for k, v in metrics.items()}
                    print(f"[train] step {step}/{steps} ({(time.time() - t0):.1f}s) {ms}", flush=True)
                if ckpt_dir is not None and step % ckpt_every == 0 and writer:
                    CIO.save_checkpoint(ckpt_dir, state, step=step)
                if on_step is not None:
                    on_step(step, metrics)
        if step == epoch_start:
            # an exhausted iterable yields nothing: stop instead of spinning
            # forever re-wrapping an empty iterator
            print(f"[train] dataset exhausted at step {step}/{steps}; stopping", flush=True)
            break
    if ckpt_dir is not None and writer and step != start_step:
        CIO.save_checkpoint(ckpt_dir, state, step=step)
    return state
