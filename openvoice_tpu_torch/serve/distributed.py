"""Lock-step data-parallel serving over a multi-process ``("data", "model")``
mesh (the port of ``openvoice_tpu/serve/distributed.py``).

The single-process `ConvertBatcher` splits a dispatched batch over a local
mesh's data axis (``serve/batcher.py``).  Across processes that is not
enough: every process must enter the same collectives with the same global
shapes, while requests arrive at each process independently.  A round
protocol closes the gap:

1. every process calls `convert_round(local_requests)` together;
2. one metadata all-gather of ``(count, max_frames)`` agrees on one plan,
   the maximum over processes (frame bucket, rows per process), so every
   process's requests fit;
3. each process pads its own rows into its share of one global batch (a
   padded row has length 0 and converts to zeros);
4. every process converts its rows on its own device
   (``runtime/parallel.py::data_parallel_convert``, with replicas built once
   at construction);
5. each process reads back only its own rows.

The noise of a request is ``np.random.default_rng(seed)`` over its live
frames only, as the JAX package draws it: the draw is then a prefix of any
bucket-sized draw from that seed, so a result does not depend on the round
or bucket the request lands in, and an elastic re-run reproduces the same
audio.  One process alone works too: the all-gather is then the identity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from openvoice_tpu_torch.api import resolve_device
from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.models import synthesizer as S
from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket
from openvoice_tpu_torch.runtime.mesh import GroupComm, Mesh, Sharded, batch_sharding, shard_rows, upload
from openvoice_tpu_torch.runtime.parallel import data_parallel_convert, replicate


@dataclass
class DistRequest:
    spec: np.ndarray        # [n_frames, n_freq]
    n_frames: int
    g_src: np.ndarray       # [gin]
    g_tgt: np.ndarray       # [gin]
    tau: float = 0.3
    seed: int = 0


class DistributedConvertService:
    """Collective convert service: one instance per process, on one mesh.

    `device` as in `api.resolve_device`: the mesh's positions must lie on
    it (the card unless the caller asks for the CPU), so that no process
    falls back to another device on its own."""

    def __init__(self, model: S.Synthesizer, cfg: SynthesizerConfig, mesh: Mesh, fast: bool = False,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.mesh = mesh
        self.fast = fast
        dev = resolve_device(device)
        local = {mesh.devices[c] for c in mesh.local_coords()}
        if any(d.type != dev.type for d in local):
            raise ValueError(f"the mesh's local devices {sorted(map(str, local))} are not on {dev}")
        # the weights are replicated once per local device; the serving mode's
        # packed cache is built only for fast=True
        with torch.no_grad():
            copies = replicate(model.eval(), local)
            self.replicas = {d: (m, S.make_dec_cache(m) if fast else None) for d, m in copies.items()}
        self._model = copies[next(iter(local))]
        n_procs = len({int(r) for r in mesh.ranks.flat}) if mesh.multiprocess else 1
        if mesh.shape["data"] % n_procs:
            raise ValueError(f"data axis {mesh.shape['data']} not divisible by {n_procs} processes")
        # rows a process contributes fill its data positions with whole rows
        self._local_data_shards = mesh.shape["data"] // n_procs
        self._n_procs = n_procs

    # ------------------------------------------------------------------

    def _plan(self, local_requests: list[DistRequest]) -> tuple[int, int]:
        """Every process agrees on (bucket, rows_per_process): one
        all-gather of (count, max_frames), maxed over processes."""
        n = len(local_requests)
        maxf = max((r.n_frames for r in local_requests), default=0)
        if self._n_procs > 1:
            allmeta = all_gather_int64([n, maxf], self.mesh)
            n, maxf = int(allmeta[:, 0].max()), int(allmeta[:, 1].max())
        if n == 0:
            return 0, 0
        shards = self._local_data_shards
        return round_up_to_bucket(maxf), -(-n // shards) * shards

    def _global(self, x: np.ndarray) -> Sharded:
        """This process's rows → its part of the global batch."""
        t = torch.from_numpy(x)
        if not self.mesh.multiprocess:
            return shard_rows(t, self.mesh)
        (coord,) = self.mesh.local_coords()
        shape = (t.shape[0] * self.mesh.shape["data"], *t.shape[1:])
        return Sharded(self.mesh, batch_sharding(self.mesh) + (None,) * (t.dim() - 1), shape,
                       {coord: upload(t, self.mesh.devices[coord])})

    def convert_round(self, local_requests: list[DistRequest]) -> list[np.ndarray]:
        """COLLECTIVE: every process must call this in the same order.

        Returns this process's converted audio, one array per local request
        (true lengths).  A process may pass [] and still takes part in the
        round, with rows of length 0."""
        cfg = self.cfg
        bucket, rows = self._plan(local_requests)
        if rows == 0:
            return []

        spec = np.zeros((rows, bucket, cfg.spec_channels), np.float32)
        lengths = np.zeros(rows, np.int64)
        g_src = np.zeros((rows, 1, cfg.gin_channels), np.float32)
        g_tgt = np.zeros((rows, 1, cfg.gin_channels), np.float32)
        taus = np.zeros((rows, 1, 1), np.float32)
        noise = np.zeros((rows, bucket, cfg.inter_channels), np.float32)
        for i, r in enumerate(local_requests):
            spec[i, : r.n_frames] = r.spec
            lengths[i] = r.n_frames
            g_src[i, 0] = np.asarray(r.g_src).reshape(-1)
            g_tgt[i, 0] = np.asarray(r.g_tgt).reshape(-1)
            taus[i, 0, 0] = r.tau
            # the live frames only: prefix-equal to any bucket-sized draw
            noise[i, : r.n_frames] = (np.random.default_rng(r.seed)
                                      .standard_normal((r.n_frames, cfg.inter_channels)).astype(np.float32))

        with torch.inference_mode():
            audio = data_parallel_convert(
                self._model, self.mesh, *(self._global(a) for a in (spec, lengths, g_src, g_tgt, taus, noise)),
                fast=self.fast, replicas=self.replicas)
            # this process's rows: one shard per data index (a model axis
            # repeats a row range on each of its positions)
            by_data = {}
            for coord, shard in sorted(audio.shards.items()):
                by_data.setdefault(coord[0], shard)
            local = torch.cat([by_data[k][..., 0].float().cpu() for k in sorted(by_data)]).numpy()
        return [local[i, : r.n_frames * cfg.upsample_factor] for i, r in enumerate(local_requests)]


def all_gather_int64(values: list[int], mesh: Mesh) -> np.ndarray:
    """Every process's `values` (one row each, rank order) over the mesh's
    data line; one process alone: its own row.  Used by the live serving
    loop for its stop vote and pending count."""
    if not mesh.multiprocess or dist.get_world_size() == 1:
        return np.asarray([values], np.int64)
    coord = mesh.local_coords()[0]
    row = torch.tensor([values], dtype=torch.int64, device=mesh.devices[coord])
    return GroupComm(mesh, "data", coord).all_gather(row, dim=0).cpu().numpy()
