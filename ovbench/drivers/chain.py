"""``api.tts_convert_batched``: the served V1 chain from text to cloned
audio (OpenVoice's openvoice_app.py:131-141), in the configuration's mode.
Its answer is the joined, watermarked float audio of every sentence.

The reference recomputes each sampled request from its text: its own copy
of the English front end (sentences, IPA, token ids), the text encoder and
both duration predictors in f32, the ceiling of the durations, the decode,
the STFT of each sentence at its true length, the conversion, the 0.05 s
gaps and the watermark.  Every noise is drawn as OpenVoice's port derives
it from the request's seed: per sentence, numpy generators spawned from
``SeedSequence(seed)`` (duration noise, then decode noise) and from
``SeedSequence([seed, 0xC04])`` (conversion noise), each drawn at the
sentence's true length.

A duration is an integer, the ceiling of a float32 product: where the
reference's value lies within `TIE` of an integer, rounding alone may put
the program's on the other side.  Only there does the reference accept the
other ceiling: when the program's answer has another length than the
reference's, it tries the other ceiling of its near-integer durations, in
every combination that gives the program's length, and judges the answer
against the nearest of those.  A length no combination explains is a
mismatch.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ovbench.drivers import Base
from ovbench.drivers.convert import MESSAGE, reference_convert, stage_kind
from ovbench.harness import rel_err
from ovbench.reference import model as R
from ovbench.reference.text import english_tokens
from ovbench.reference.watermark import add_watermark

TIE = 1e-3          # frames: a float32 duration's rounding is under 1e-4 at these sizes
MAX_TIES = 10       # near-integer durations tried at most, a request
MAX_CHOICES = 8     # combinations judged at most, a request
SPEED = 1.0
GAP_S = 0.05


def sentence_rngs(seed: int, n: int) -> list[tuple]:
    """Per sentence (duration noise, decode noise, conversion noise)
    generators."""
    conv = [np.random.default_rng(ss) for ss in np.random.SeedSequence([seed, 0xC04]).spawn(n)]
    out = []
    for child, c in zip(np.random.SeedSequence(seed).spawn(n), conv):
        w_ss, y_ss = child.spawn(2)
        out.append((np.random.default_rng(w_ss), np.random.default_rng(y_ss), c))
    return out


class Driver(Base):
    def __init__(self, *args):
        super().__init__(*args)
        self._chosen: dict[int, list] = {}   # pool item → the durations the reference judged it by

    def setup(self) -> None:
        from openvoice_tpu_torch.api import BaseSpeakerTTS, ToneColorConverter

        from ovbench.drivers import port_config, port_model

        self.tts = BaseSpeakerTTS(cfg=port_config(self.fields("tts")), device=self.device)
        self.tts.set_model(port_model(self.fields("tts"), self.weights("tts", 0), self.device))
        self.conv = ToneColorConverter(cfg=port_config(self.fields("converter")), device=self.device)
        self.conv.set_model(port_model(self.fields("converter"), self.weights("converter", 1), self.device))
        self.tokens = {item["index"]: [len(t) for t in english_tokens(item["text"])] for item in self.traffic.pool}
        for item in self.traffic.pool:  # every shape the pool uses: captured, then replayed
            self.call(item)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, req: dict) -> np.ndarray:
        from openvoice_tpu_torch.api import tts_convert_batched

        return tts_convert_batched(self.tts, self.conv, req["text"], req["speaker"], req["src"], req["tgt"],
                                   language="English", speed=SPEED, tau=req["tau"], seed=req["seed"],
                                   message=MESSAGE, fast=self.fast)

    def gap(self) -> int:
        return int(self.fields("tts")["sampling_rate"] * GAP_S / SPEED)

    def work(self, req: dict, out: np.ndarray) -> dict:
        """Tokens a sentence (the reference's front end); the answer's
        frames, shared among the sentences by their tokens."""
        tokens = self.tokens[req["index"]]
        hop = self.ref_cfg("tts").upsample_factor
        frames = max(len(out) - len(tokens) * self.gap(), 0) // hop
        per = [frames * t // max(sum(tokens), 1) for t in tokens]
        return {"tts": list(zip(tokens, per)), "convert": per}

    def graph_caches(self) -> list:
        return [self.tts.graphs, self.conv.graphs, self.tts.chain_graphs(self.conv)]

    def close(self) -> None:
        self.tts = self.conv = None

    def reference(self, items: list[dict], outs: list | None = None, kind: str | None = None) -> list:
        """What each request should have returned, by the reference (`kind`
        None: its durations, judged against `outs`' lengths), its bf16 twin
        (``"bf16"``: the reference's last choice of durations) or the
        control (``"control"``: its own durations)."""
        tts, conv = self.ref_model("tts", 0), self.ref_model("converter", 1)
        stage = stage_kind(self.fast, kind)
        answers = []
        with torch.no_grad(), R.precision("tf32" if kind == "control" else "f32"):
            for k, req in enumerate(items):
                enc = self._encode(tts, req)
                if kind == "bf16":
                    durations = self._chosen.get(req["index"])
                    answers.append(None if durations is None else
                                   self._decode(tts, conv, req, enc, durations, stage))
                else:
                    answers.append(self._choose(tts, conv, req, enc, None if outs is None else outs[k], stage))
        return answers

    def _encode(self, tts: R.Synthesizer, req: dict) -> list:
        """Each sentence's (m_p, logs_p, durations before the ceiling, g)."""
        dev, enc = self.device, []
        sentences = english_tokens(req["text"])
        for toks, (rng_w, _, _) in zip(sentences, sentence_rngs(req["seed"], len(sentences))):
            noise_w = torch.from_numpy(rng_w.standard_normal((len(toks), 2)).astype(np.float32)).to(dev)
            enc.append(R.tts_durations(tts, torch.tensor(toks, device=dev), req["speaker"], noise_w))
        return enc

    def _choose(self, tts, conv, req: dict, enc: list, out: np.ndarray | None, stage):
        """The answer for the ceilings of the durations or, where `out` has
        another length, for the near-integer ceilings' combination that
        gives out's length and lies nearest to it; None when none does."""
        hop, gap = tts.cfg.upsample_factor, self.gap()
        ceils = [torch.ceil(e[2]) for e in enc]
        choices = [ceils]
        if out is not None:
            want = (len(out) - len(enc) * gap) / hop
            have = sum(max(int(c.sum()), 1) for c in ceils)
            ties = [(s, t, 1.0 if float(e[2][t]) <= float(torch.round(e[2][t])) else -1.0)
                    for s, e in enumerate(enc)
                    for t in torch.nonzero((e[2] - torch.round(e[2])).abs() < TIE).flatten().tolist()]
            choices = []
            for r in range(min(len(ties), MAX_TIES) + 1):
                for combo in itertools.combinations(ties[:MAX_TIES], r):
                    if have + sum(d for _, _, d in combo) == want and len(choices) < MAX_CHOICES:
                        alt = [c.clone() for c in ceils]
                        for s, t, d in combo:
                            alt[s][t] += d
                        choices.append(alt)
            if not choices:
                return None
        best, best_err = None, np.inf
        for durations in choices:
            audio = self._decode(tts, conv, req, enc, durations, stage)
            err = np.inf if out is None or len(out) != len(audio) else rel_err(out, audio)
            if best is None or err < best_err:
                best, best_err = audio, err
                self._chosen[req["index"]] = durations
        return best

    def _decode(self, tts, conv, req, enc, durations, stage) -> np.ndarray:
        """The sentences' decode and conversion with the given durations,
        each noise from fresh generators; the program's bf16 stages (the
        flow and decoder of the TTS, the conversion) store in `stage`."""
        dev, pieces, gap = self.device, [], self.gap()
        rngs = sentence_rngs(req["seed"], len(enc))
        for (m_p, logs_p, _, g), w_ceil, (_, rng_y, rng_c) in zip(enc, durations, rngs):
            t_y = max(int(w_ceil.sum()), 1)
            noise = torch.from_numpy(rng_y.standard_normal((t_y, tts.cfg.inter_channels)).astype(np.float32)).to(dev)
            z_p = R.tts_latents(m_p, logs_p, w_ceil, noise)
            with R.stored(stage, [tts.flow, tts.dec]):
                base = R.tts_decode(tts, z_p, g)
            conv_noise = rng_c.standard_normal((t_y, conv.cfg.inter_channels)).astype(np.float32)
            pieces.append(reference_convert(conv, R.np_audio(base), req["src"], req["tgt"], req["tau"],
                                            torch.from_numpy(conv_noise).to(dev), stage))
            pieces.append(np.zeros(gap, np.float32))
        joined = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        return add_watermark(joined, MESSAGE) if joined.size else joined
