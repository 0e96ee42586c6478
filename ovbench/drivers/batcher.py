"""``ConvertBatcher.submit`` in PCM mode, as ``VoiceService.convert_audio``
sends requests: float audio, tau, a seed of its own, the two embeddings.
The batcher groups pending requests by bucket, runs each group as one call
and answers on the int16 wire; the caller gets that as float.  The cell's
``driver_args`` set ``max_batch``, ``max_wait_ms`` and nothing else; the
mode comes from the configuration.

The reference recomputes each sampled request: the clip on the int16 grid
(what the PCM wire carries), its STFT, the device noise
``torch.randn(n_frames, inter)`` from ``torch.Generator`` on the card
seeded with the request's seed, and the conversion at the true length.
"""

from __future__ import annotations

import numpy as np
import torch

from ovbench.drivers import Base, frames_of, pcm16
from ovbench.drivers.convert import reference_convert, stage_kind
from ovbench.reference import model as R


def device_noise(seed: int, frames: int, channels: int, device: torch.device) -> torch.Tensor:
    return torch.randn(frames, channels, generator=torch.Generator(device).manual_seed(seed), device=device)


class Driver(Base):
    def setup(self) -> None:
        from openvoice_tpu_torch.runtime.bucketing import FINE_BUCKETS, allowed_batch_sizes, round_up_to_bucket
        from openvoice_tpu_torch.serve.batcher import ConvertBatcher

        from ovbench.drivers import port_model

        args = self.cell.get("driver_args", {})
        model = port_model(self.fields("model"), self.weights("model", 0), self.device)
        self.batcher = ConvertBatcher(model, self.cfg_port(), max_batch=int(args["max_batch"]),
                                      max_wait_ms=float(args["max_wait_ms"]), fast=self.fast, device=self.device)
        self.batcher.start()
        # every (bucket, padded batch) the planner can make of the pool: a
        # group is padded to an allowed size and takes its longest row's
        # bucket, so `size` rows of one bucket, sent together, make it
        cfg = self.ref_cfg("model")
        by_bucket: dict[int, list[dict]] = {}
        for item in self.traffic.pool:
            by_bucket.setdefault(round_up_to_bucket(frames_of(len(item["audio"]), cfg), FINE_BUCKETS), []).append(item)
        for size in allowed_batch_sizes(self.batcher.max_batch):
            for items in by_bucket.values():
                futures = [self._submit(items[i % len(items)]) for i in range(size)]
                for f in futures:
                    f.result()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def cfg_port(self):
        from ovbench.drivers import port_config

        return port_config(self.fields("model"))

    def _submit(self, req: dict):
        from openvoice_tpu_torch.serve.batcher import ConvertRequest

        return self.batcher.submit(ConvertRequest(audio=req["audio"], g_src=req["src"], g_tgt=req["tgt"],
                                                  tau=req["tau"], seed=req["seed"]))

    def call(self, req: dict) -> np.ndarray:
        return self._submit(req).result()

    def work(self, req: dict, out: np.ndarray) -> dict:
        return {"convert": [frames_of(len(req["audio"]), self.ref_cfg("model"))]}

    def graph_caches(self) -> list:
        return [rep.graphs for rep in self.batcher.replicas.values()]

    def counters(self) -> dict:
        from openvoice_tpu_torch.runtime.profiler import METRICS

        return dict(METRICS.snapshot()["counters"])

    def close(self) -> None:
        self.batcher.stop()
        self.batcher = None

    def reference(self, items: list[dict], outs: list | None = None, kind: str | None = None) -> list[np.ndarray]:
        """As `convert.Driver.reference`."""
        model = self.ref_model("model", 0)
        stage = stage_kind(self.fast, kind)
        out = []
        with torch.no_grad(), R.precision("tf32" if kind == "control" else "f32"):
            for req in items:
                n = frames_of(len(req["audio"]), model.cfg)
                noise = device_noise(req["seed"], n, model.cfg.inter_channels, self.device)
                out.append(reference_convert(model, pcm16(req["audio"]), req["src"], req["tgt"], req["tau"], noise,
                                             stage))
        return out
