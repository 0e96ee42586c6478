"""The entries the cells drive, one module each (``<entry>.py``, named by a
cell's ``driver``).  Each holds a `Driver` with:

* ``setup()``: the program's objects on the card with the benchmark's
  weights, and a warm-up of exactly the shapes the cell's pool uses;
* ``call(req)``: one request through the entry, blocking, → the float audio
  the caller gets;
* ``work(req, out)``: what the request asked of the device (frames, tokens)
  for the operation counts;
* ``graph_caches()``: the program's CUDA-graph caches the entry uses;
* ``close()``: stop and drop the program's state;
* ``reference(items, control)``: what the reference says each sampled
  request should have returned (`judge` compares).

Shared pieces live here.  Nothing in this package imports the program at
module level: a run imports it after its checks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ovbench.reference import model as R
from ovbench.weights import make_weights, reference_model, sub_seed


def port_config(fields: dict):
    """The program's `SynthesizerConfig` from a configuration file's widths."""
    from openvoice_tpu_torch.config import SynthesizerConfig

    kw = dict(fields)
    for k in ("resblock_kernel_sizes", "upsample_rates", "upsample_kernel_sizes"):
        if k in kw:
            kw[k] = tuple(kw[k])
    if "resblock_dilation_sizes" in kw:
        kw["resblock_dilation_sizes"] = tuple(tuple(d) for d in kw["resblock_dilation_sizes"])
    return SynthesizerConfig(**kw)


def port_model(fields: dict, weights: dict, device: torch.device):
    """The program's synthesizer on `device` with the benchmark's weights
    (strict: every key of the checkpoint layout, no other)."""
    from openvoice_tpu_torch.models import synthesizer as S

    with torch.device(device):
        model = S.Synthesizer(port_config(fields))
    model.load_state_dict(weights, strict=True)
    return model.eval()


def frames_of(n_samples: int, cfg: R.Config) -> int:
    """Frames of a clip of n_samples after the reflect pad (the converter's
    framing)."""
    pad = (cfg.filter_length - cfg.hop_length) // 2
    return (n_samples + 2 * pad - cfg.filter_length) // cfg.hop_length + 1


def pcm16(x: np.ndarray) -> np.ndarray:
    """Float audio on the int16 grid: round(clip(x)·32767)/32767."""
    return (np.round(np.clip(x, -1.0, 1.0) * 32767.0) / 32767.0).astype(np.float32)


class Base:
    """What every driver shares: the cell, the configuration, the traffic,
    the seed and the device."""

    def __init__(self, cell: dict, config: dict, traffic, seed: int, device: torch.device):
        self.cell, self.config, self.traffic, self.seed, self.device = cell, config, traffic, seed, device
        self.fast = config["precision"] == "bf16"

    def fields(self, name: str) -> dict:
        return self.config[name] if name in self.config else self.config["model"]

    @functools.cached_property
    def _ref_cfgs(self) -> dict:
        return {name: R.Config.from_dict(self.fields(name)) for name in ("model", "tts", "converter")
                if name in self.config}

    def ref_cfg(self, name: str) -> R.Config:
        """The reference's `Config` of the model `name`."""
        return self._ref_cfgs[name]

    def weights(self, name: str, index: int) -> dict:
        cfg = self.ref_cfg(name)
        spec = self.config["weights"]
        return make_weights(cfg, sub_seed(self.seed, index), self.device, float(spec["conv_post_gain"][name]),
                            tuple(spec.get("fixed", {}).get(name, ())))

    def ref_model(self, name: str, index: int) -> R.Synthesizer:
        return reference_model(self.ref_cfg(name), self.weights(name, index))
