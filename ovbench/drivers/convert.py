"""``ToneColorConverter.convert``: one clip at a time, as a library user
calls it (OpenVoice's demo_part3), in the configuration's mode: the bf16
serving route (``fast=True``) or the f32 default.  Its answer is the
watermarked float audio.

The reference recomputes each sampled request from its clip: the STFT of
the reflect-padded clip, the host noise (numpy ``default_rng(seed)``, whose
first n_frames·inter draws are what the program's bucket-sized draw puts
on the true frames), the conversion at the true length and the watermark.
"""

from __future__ import annotations

import numpy as np
import torch

from ovbench.drivers import Base, frames_of
from ovbench.reference import model as R
from ovbench.reference.watermark import add_watermark

MESSAGE = "default"


def reference_convert(model: R.Synthesizer, audio: np.ndarray, src: np.ndarray, tgt: np.ndarray, tau: float,
                      noise: torch.Tensor, stage: str | None = None) -> np.ndarray:
    """The reference's conversion of one float clip with noise [T, inter]
    → float audio [T · upsample].  `stage`: the type the conversion after
    the STFT (the program's bf16 stage) stores its values in
    (`R.stored`)."""
    dev = noise.device
    spec = R.spectrogram(torch.from_numpy(audio).to(dev), model.cfg)
    g = [torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in (src, tgt)]
    with R.stored(stage, [model.enc_q, model.flow, model.dec]):
        return R.np_audio(R.convert(model, spec, g[0], g[1], tau, noise))


def stage_kind(fast: bool, kind: str | None) -> str | None:
    """What the program's bf16 stages store in, for a reference `kind`
    (None the reference, ``"bf16"`` its twin, ``"control"`` the control)."""
    if kind == "control":
        return "fp8" if fast else None
    return kind


def host_noise(seed: int, frames: int, channels: int, device: torch.device) -> torch.Tensor:
    """The convert path's noise on the true frames: numpy's first
    frames·channels standard normals of ``default_rng(seed)``."""
    draw = np.random.default_rng(seed).standard_normal((frames, channels)).astype(np.float32)
    return torch.from_numpy(draw).to(device)


class Driver(Base):
    def setup(self) -> None:
        from openvoice_tpu_torch.api import ToneColorConverter

        from ovbench.drivers import port_config, port_model

        self.tc = ToneColorConverter(cfg=port_config(self.fields("model")), device=self.device)
        self.tc.set_model(port_model(self.fields("model"), self.weights("model", 0), self.device))
        for item in self.traffic.pool:  # every bucket the pool uses: captured, then replayed
            self.call(item)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, req: dict) -> np.ndarray:
        return self.tc.convert(req["audio"], req["src"], req["tgt"], tau=req["tau"], seed=req["seed"],
                               message=MESSAGE, fast=self.fast)

    def work(self, req: dict, out: np.ndarray) -> dict:
        return {"convert": [frames_of(len(req["audio"]), self.ref_cfg("model"))]}

    def graph_caches(self) -> list:
        return [self.tc.graphs]

    def close(self) -> None:
        self.tc = None

    def reference(self, items: list[dict], outs: list | None = None, kind: str | None = None) -> list[np.ndarray]:
        """What each request should have returned, by the reference
        (`kind` None), its bf16 twin (``"bf16"``) or the control
        (``"control"``)."""
        model = self.ref_model("model", 0)
        stage = stage_kind(self.fast, kind)
        out = []
        with torch.no_grad(), R.precision("tf32" if kind == "control" else "f32"):
            for req in items:
                n = frames_of(len(req["audio"]), model.cfg)
                noise = host_noise(req["seed"], n, model.cfg.inter_channels, self.device)
                audio = reference_convert(model, req["audio"], req["src"], req["tgt"], req["tau"], noise, stage)
                out.append(add_watermark(audio, MESSAGE))
        return out
