"""Tensor- and data-parallel conversion over a `runtime.mesh.Mesh`.

The JAX package gets both from GSPMD: `shard_params` places the wide
weights by the mesh rules, a batch placed by `batch_sharding` splits over
``data``, and XLA partitions the unchanged convert graph
(``tests/test_distributed.py:75-128``).  The port writes the partition out:

* **Tensor parallel** (`TensorParallel`): each model-axis position holds
  1/model of every weight the rules split, and nothing else of it.  A layer
  split on its output channels (``conv_pre``, ``cond``, the WaveNet ``in``
  layers and their conditioning) computes its share with the local piece,
  then all-gathers the channels; a transposed convolution split on its input
  channels (the decoder's ``ups``) takes its share of the incoming channels,
  then all-reduces (sums) and adds the bias.  Every other layer runs
  replicated.  Rows split over ``data``.
* **Data parallel** (`data_parallel_convert`): the weights replicated once
  per device, rows split over ``data``, each position converting its rows on
  its own device, in either mode (the serving mode launches the kernels on
  each position).

Both compute what the single-device graph computes, up to the order of the
sums in the all-reduce.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.models import synthesizer as S
from openvoice_tpu_torch.nn.hifigan import apply_generator
from openvoice_tpu_torch.runtime.mesh import Mesh, Sharded, comms, row_range, shard_params, spmd


def replicate(model: nn.Module, devices) -> dict[torch.device, nn.Module]:
    """One copy of `model` per distinct device (the model itself where it
    already lies)."""
    out: dict[torch.device, nn.Module] = {}
    here = next(model.parameters()).device
    for dev in devices:
        dev = torch.device(dev)
        if dev not in out:
            out[dev] = model if dev == here else copy.deepcopy(model).to(dev)
    return out


def _rows(x, mesh: Mesh, coord, dtype=None):
    """`coord`'s rows of a batch: its shard of a `Sharded`, else its slice of
    a whole tensor, on its device."""
    if x is None or isinstance(x, (int, float)):
        return x
    if isinstance(x, Sharded):
        t = x.shards[coord]
    else:
        t = x[row_range(x.shape[0], mesh, coord)]
    return t.to(mesh.devices[coord], dtype or t.dtype)


class _CommSlot:
    """Where a split layer finds its position's collectives for the current
    call."""

    comm = None


class ColumnParallelConv1d(nn.Module):
    """A Conv1d split on its output channels: the local piece's channels,
    then an all-gather of every piece's."""

    def __init__(self, template: nn.Conv1d, weight: torch.Tensor, bias: torch.Tensor | None, slot: _CommSlot):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)  # whole: sliced below
        self.stride, self.padding = template.stride, template.padding
        self.dilation, self.groups = template.dilation, template.groups
        self._slot = slot

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        comm, c = self._slot.comm, self.weight.shape[0]
        bias = None if self.bias is None else self.bias.narrow(0, comm.index * c, c)
        y = F.conv1d(x, self.weight, bias, self.stride, self.padding, self.dilation, self.groups)
        return comm.all_gather(y, dim=1)


class RowParallelConvTranspose1d(nn.Module):
    """A ConvTranspose1d split on its input channels: the local share of the
    incoming channels through the local piece, an all-reduce (sum), then
    the bias."""

    def __init__(self, template: nn.ConvTranspose1d, weight: torch.Tensor, bias: torch.Tensor | None,
                 slot: _CommSlot):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.stride, self.padding = template.stride, template.padding
        self.output_padding, self.dilation, self.groups = template.output_padding, template.dilation, template.groups
        self._slot = slot

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        comm, c = self._slot.comm, self.weight.shape[0]
        y = F.conv_transpose1d(x.narrow(1, comm.index * c, c), self.weight, None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        y = comm.all_reduce(y)
        return y if self.bias is None else y + self.bias[None, :, None]


def _split_model(cfg: SynthesizerConfig, local: dict[str, torch.Tensor], slot: _CommSlot) -> S.Synthesizer:
    """A converter holding `local` (one position's `shard_params`): each
    weight the rules split sits in a parallel layer, the rest as loaded."""
    with torch.device("meta"):
        model = S.Synthesizer(cfg)
    for name, t in local.items():
        path, _, leaf = name.rpartition(".")
        if leaf != "weight":
            continue
        layer = model.get_submodule(path)
        if tuple(layer.weight.shape) == tuple(t.shape):
            continue  # whole: runs replicated
        kind = ColumnParallelConv1d if isinstance(layer, nn.Conv1d) else RowParallelConvTranspose1d
        parent_path, _, attr = path.rpartition(".")
        setattr(model.get_submodule(parent_path), attr, kind(layer, t, local.get(f"{path}.bias"), slot))
    model.load_state_dict(local, assign=True)
    return model.eval().requires_grad_(False)


class TensorParallel:
    """The converter split over `mesh`'s model axis (`shard_params`), rows
    over its data axis.  Inputs are whole batches (each position takes its
    rows) or `Sharded` ones (`training.data.make_global_batch`); outputs are
    `Sharded` by rows."""

    def __init__(self, model_or_sd, cfg: SynthesizerConfig, mesh: Mesh):
        self.cfg, self.mesh = cfg, mesh
        self.shards = shard_params(model_or_sd, mesh)
        self._slots = {c: _CommSlot() for c in self.shards}
        self.models = {c: _split_model(cfg, self.shards[c], self._slots[c]) for c in self.shards}

    def _run(self, fn) -> dict:
        table = comms(self.mesh, "model")
        for c, slot in self._slots.items():
            slot.comm = table[c]
        with torch.no_grad():
            return spmd(self.mesh, fn, uses=(table,))

    def generator(self, z: torch.Tensor, g: torch.Tensor | None = None) -> Sharded:
        """`nn.hifigan.apply_generator` in f32: z [B, T, inter], g [B, 1, gin]
        → audio [B, T·upsample, 1]."""
        def local(c):
            return apply_generator(self.models[c].dec, _rows(z, self.mesh, c, torch.float32),
                                   g=_rows(g, self.mesh, c, torch.float32))

        shards = self._run(local)
        b, t = z.shape[0], z.shape[1]
        return Sharded(self.mesh, ("data", None, None), (b, t * self.cfg.upsample_factor, 1), shards)

    def convert(self, spec, spec_lengths, g_src, g_tgt, tau, noise) -> Sharded:
        """`models.synthesizer.voice_conversion` in f32 → audio [B,
        T·upsample, 1]."""
        def local(c):
            f32 = torch.float32
            audio, _ = S.voice_conversion(
                self.models[c], _rows(spec, self.mesh, c, f32), _rows(spec_lengths, self.mesh, c),
                _rows(g_src, self.mesh, c, f32), _rows(g_tgt, self.mesh, c, f32),
                tau if not torch.is_tensor(tau) else _rows(tau, self.mesh, c, f32),
                _rows(noise, self.mesh, c, f32))
            return audio

        shards = self._run(local)
        b, t = spec.shape[0], spec.shape[1]
        return Sharded(self.mesh, ("data", None, None), (b, t * self.cfg.upsample_factor, 1), shards)


def data_parallel_convert(model: S.Synthesizer, mesh: Mesh, spec, spec_lengths, g_src, g_tgt, tau, noise,
                          fast: bool = False, replicas: dict | None = None) -> Sharded:
    """`voice_conversion` with rows split over `mesh`'s data axis (tau a
    float, or one per row as a whole [B, 1, 1] tensor or a `Sharded`) and the
    weights replicated per device (`replicas`: {device: (model, dec_cache)},
    made here when not given; the cache only for fast=True) → audio [B,
    T·upsample, 1] `Sharded` by rows.  Each position converts its rows on
    its own device; the model axis, if any, replicates."""
    if replicas is None:
        copies = replicate(model, {mesh.devices[c] for c in mesh.local_coords()})
        replicas = {d: (m, S.make_dec_cache(m) if fast else None) for d, m in copies.items()}

    def local(c):
        m, cache = replicas[mesh.devices[c]]
        f32 = torch.float32
        audio, _ = S.voice_conversion(
            m, _rows(spec, mesh, c, f32), _rows(spec_lengths, mesh, c), _rows(g_src, mesh, c, f32),
            _rows(g_tgt, mesh, c, f32), _rows(tau, mesh, c, f32) if isinstance(tau, (torch.Tensor, Sharded)) else tau,
            _rows(noise, mesh, c, f32), fast=fast, dec_cache=cache)
        return audio

    with torch.no_grad():
        shards = spmd(mesh, local)
    b, t = spec.shape[0], spec.shape[1]
    return Sharded(mesh, ("data", None, None), (b, t * model.cfg.upsample_factor, 1), shards)
