"""``BaseSpeakerTTS.tts_batched`` of MeloTTS-English, OpenVoice V2's base
speaker, as ``melo/api.py::tts_to_file`` reads a line: one piece a line
(pieces of about 256 characters), speaker one of the five English ones
(``spk2id`` 0-4: the request's style speaker mod 5), speed 1, sdp_ratio 0.2,
noise scales 0.6 and 0.8, 0.05 s gaps, in the configuration's mode.  Its
answer is the joined float audio (MeloTTS marks no watermark).

The reference (``ovbench/reference/melo.py``) recomputes each sampled
request from its text: its own copy of the text side, BERT, the text
encoder and both duration predictors in f32, the ceilings, the flow and
the decoder at each piece's true length, with every noise drawn as the port
draws it from the line's seed (`Driver.line_seed`; per piece, numpy
generators spawned from ``SeedSequence(seed)``: durations, then decode), at
the true length.  A
duration within `chain.TIE` of an integer may take the other ceiling where
the answer's length asks for it (`chain.Driver._choose`).

Weights (`melo_weights`): as ``ovbench/weights.py`` draws them, from the
reference's module tree, with MeloTTS's tone and language tables normal
(0, hidden^-½) and BERT's own initialisation (every weight normal(0, 0.02),
biases 0, LayerNorms 1 and 0).  The text side (text encoder, duration
predictors, speaker table) and BERT come from one fixed seed, drawn on the
CPU so that every device gets the same; their durations carry the
configuration's ``duration_shrink`` and ``duration_offset``
(`offset_durations`).  The decode side
(flow, decoder) comes from the run's seed on the device.
"""

from __future__ import annotations

import math
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):   # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from ovbench.drivers import chain  # noqa: E402
from ovbench.reference import melo as RM  # noqa: E402
from ovbench.reference import model as R  # noqa: E402
from ovbench.weights import FIXED_SEED, _rule, sub_seed  # noqa: E402

SPEAKERS = 5            # MeloTTS-English's spk2id: EN-US, EN-BR, EN_INDIA, EN-AU, EN-Default
NOISE_SCALE, NOISE_SCALE_W, SDP_RATIO = 0.6, 0.8, 0.2   # tts_to_file's defaults
BERT_STD = 0.02         # bert-base-uncased's initializer_range


def _draw(shapes: dict, rules: dict, seed: int, device) -> dict:
    """Tensors of `shapes` by `rules` ((kind, scale): "one", "zero",
    "normal", "uniform"), cut from one uniform and one normal draw of a
    generator on `device` seeded with `seed` (as ``weights.make_weights``)."""
    gen = torch.Generator(device).manual_seed(seed)
    size = {kind: sum(math.prod(shapes[k]) for k, (kd, _) in rules.items() if kd == kind)
            for kind in ("uniform", "normal")}
    src = {"uniform": torch.rand(size["uniform"], generator=gen, device=device) * 2.0 - 1.0,
           "normal": torch.randn(size["normal"], generator=gen, device=device)}
    out, at = {}, {"uniform": 0, "normal": 0}
    for name in sorted(shapes):
        kind, scale = rules[name]
        shape, n = shapes[name], math.prod(shapes[name])
        if kind in at:
            out[name] = (src[kind][at[kind] : at[kind] + n] * scale).reshape(shape)
            at[kind] += n
        else:
            out[name] = torch.full(shape, scale, device=device)
    return out


def _synth_rules(cfg: RM.MeloConfig, spec: dict) -> tuple[dict, dict]:
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in RM.Synthesizer(cfg).state_dict().items()}
    rules = {}
    for k, s in shapes.items():
        if k in ("enc_p.tone_emb.weight", "enc_p.language_emb.weight"):
            rules[k] = ("normal", cfg.hidden_channels ** -0.5)   # melo/models.py TextEncoder's init
        elif k == "emb_g.weight":
            rules[k] = ("normal", float(spec["speaker_std"]))
        else:
            rules[k] = _rule(k, s, cfg, shapes)
    return shapes, rules


def _bert_rules(cfg: RM.BertConfig) -> tuple[dict, dict]:
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in RM.Bert(cfg).state_dict().items()}
    rules = {}
    for k in shapes:
        if "LayerNorm" in k:
            rules[k] = ("one", 1.0) if k.endswith("weight") else ("zero", 0.0)
        elif k.endswith("bias"):
            rules[k] = ("zero", 0.0)
        else:
            rules[k] = ("normal", BERT_STD)
    return shapes, rules


def offset_durations(sd: dict, offset: float, shrink: float = 1.0) -> None:
    """Scale both duration predictors' log-durations by `shrink`, then add
    `offset`, so their blend moves the same way: the deterministic one's
    last projection (weight and bias by `shrink`, `offset` onto the bias),
    and the stochastic one's last step in reverse, (z − m)·exp(−logs),
    through logs (less log `shrink`) and m."""
    with torch.no_grad():
        sd["dp.proj.weight"] *= shrink
        sd["dp.proj.bias"] *= shrink
        sd["dp.proj.bias"] += offset
        sd["sdp.flows.0.logs"][0] -= math.log(shrink)
        sd["sdp.flows.0.m"][0] -= offset * torch.exp(sd["sdp.flows.0.logs"][0])


def melo_weights(config: dict, seed: int, device) -> tuple[dict, dict]:
    """(the synthesizer's state dict, BERT's) of a run with `seed`, on
    `device` (module docstring)."""
    spec = config["weights"]
    cfg, bcfg = RM.MeloConfig.from_dict(config["model"]), RM.BertConfig.from_dict(config["bert"])
    shapes, rules = _synth_rules(cfg, spec)
    fixed = tuple(spec["fixed"])
    ours = _draw(shapes, rules, seed, device)
    held = _draw(shapes, rules, FIXED_SEED, "cpu")
    sd = {k: held[k].to(device) if k.startswith(fixed) else v for k, v in ours.items()}
    for k in sd:   # drawn, then set to 0, so that the other tensors' draws stay as they are
        if k.endswith("bias") and k.startswith(tuple(spec["zero_bias"])):
            sd[k] = torch.zeros_like(sd[k])
    sd["dec.conv_post.weight"] = sd["dec.conv_post.weight"] * float(spec["conv_post_gain"])
    offset_durations(sd, float(spec["duration_offset"]), float(spec["duration_shrink"]))
    bshapes, brules = _bert_rules(bcfg)
    bert = {k: v.to(device) for k, v in _draw(bshapes, brules, FIXED_SEED + 1, "cpu").items()}
    return sd, bert


def reference_models(config: dict, seed: int, device) -> tuple[RM.Synthesizer, RM.Bert]:
    sd, bsd = melo_weights(config, seed, device)
    with torch.device(device):
        model = RM.Synthesizer(RM.MeloConfig.from_dict(config["model"]))
        bert = RM.Bert(RM.BertConfig.from_dict(config["bert"]))
    model.load_state_dict(sd, strict=True)
    bert.load_state_dict(bsd, strict=True)
    return model.eval(), bert.eval()


class Driver(chain.Driver):
    def setup(self) -> None:
        from openvoice_tpu_torch.api import BaseSpeakerTTS
        from openvoice_tpu_torch.config import MeloTTSConfig   # a program without MeloTTS fails here, at once
        from openvoice_tpu_torch.models.synthesizer import Synthesizer
        from openvoice_tpu_torch.nn.bert import Bert, BertConfig

        cfg = MeloTTSConfig(**{k: tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list)
                               else v for k, v in self.fields("model").items()})
        bert_cfg = BertConfig(**self.config["bert"])
        sd, bsd = melo_weights(self.config, sub_seed(self.seed, 0), self.device)
        with torch.device(self.device):
            model, bert = Synthesizer(cfg), Bert(bert_cfg)
        model.load_state_dict(sd, strict=True)
        bert.load_state_dict(bsd, strict=True)
        self.tts = BaseSpeakerTTS(cfg=cfg, device=self.device, bert_cfg=bert_cfg)
        self.tts.set_model(model.eval())
        self.tts.set_bert(bert)
        cfg_r = RM.MeloConfig.from_dict(self.fields("model"))
        self.pieces = {item["index"]: [(len(t.wordpieces), len(t.phones)) for t in self.tokens_of(item["text"], cfg_r)]
                       for item in self.traffic.pool}
        for item in self.traffic.pool:  # every shape the pool uses: captured, then replayed
            self.call(item)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tokens_of(self, text: str, cfg: RM.MeloConfig) -> list:
        return [RM.melo_tokens(p, cfg.n_vocab, int(self.config["bert"]["vocab_size"])) for p in RM.split_pieces(text)]

    @staticmethod
    def speaker(req: dict) -> int:
        return int(req["speaker"]) % SPEAKERS

    @staticmethod
    def line_seed(req: dict) -> int:
        """The seed of a line's noise (its durations', then its decode's):
        fixed by the line's words and speaker, as the traffic fixes each
        line's length, so that every run asks the same work of the card
        (the durations set the frames, and a line near a frame bucket's
        edge would change bucket from run to run); the run's seed draws the
        decoder's weights and the lines' order."""
        return zlib.crc32(f"{req['speaker']}:{req['text']}".encode("utf-8"))

    def call(self, req: dict) -> np.ndarray:
        return self.tts.tts_batched(req["text"], None, self.speaker(req), speed=chain.SPEED,
                                    seed=self.line_seed(req), fast=self.fast)

    def work(self, req: dict, out: np.ndarray) -> dict:
        """Each piece's (wordpieces, tokens, frames): the answer's frames
        shared among the pieces by their tokens."""
        pieces = self.pieces[req["index"]]
        hop = self.ref_cfg("model").upsample_factor
        frames = max(len(out) - len(pieces) * self.gap(), 0) // hop
        total = max(sum(t for _, t in pieces), 1)
        return {"melo": [(w, t, frames * t // total) for w, t in pieces]}

    def graph_caches(self) -> list:
        return [self.tts.graphs]

    def counters(self) -> dict:
        from openvoice_tpu_torch.runtime.profiler import METRICS

        return dict(METRICS.snapshot()["counters"])

    def close(self) -> None:
        self.tts = None

    def reference(self, items: list[dict], outs: list | None = None, kind: str | None = None) -> list:
        """As `chain.Driver.reference`: the reference (`kind` None, its
        durations judged against `outs`' lengths), its bf16 twin (the flow
        and decoder storing in bf16, with the durations last chosen) or the
        control (TF32 text side, fp8 flow and decoder)."""
        tts, self._bert = reference_models(self.config, sub_seed(self.seed, 0), self.device)
        stage = chain.stage_kind(self.fast, kind)
        answers = []
        with torch.no_grad(), R.precision("tf32" if kind == "control" else "f32"):
            for k, req in enumerate(items):
                enc = self._encode(tts, req)
                if kind == "bf16":
                    durations = self._chosen.get(req["index"])
                    answers.append(None if durations is None else self._decode(tts, None, req, enc, durations, stage))
                else:
                    answers.append(self._choose(tts, None, req, enc, None if outs is None else outs[k], stage))
        return answers

    def _encode(self, tts: RM.Synthesizer, req: dict) -> list:
        """Each piece's (m_p, logs_p, durations before the ceiling, g)."""
        pieces = self.tokens_of(req["text"], tts.cfg)
        enc = []
        for toks, (rng_w, _, _) in zip(pieces, chain.sentence_rngs(self.line_seed(req), len(pieces))):
            noise_w = torch.from_numpy(rng_w.standard_normal((len(toks.phones), 2)).astype(np.float32)).to(self.device)
            enc.append(RM.tts_durations(tts, self._bert, toks, self.speaker(req), noise_w, NOISE_SCALE_W, SDP_RATIO,
                                        1.0 / chain.SPEED))
        return enc

    def _decode(self, tts, conv, req, enc, durations, stage) -> np.ndarray:
        """The pieces' decode with the given durations, each with its 0.05 s
        gap; the flow and decoder store in `stage`."""
        pieces = []
        rngs = chain.sentence_rngs(self.line_seed(req), len(enc))
        for (m_p, logs_p, _, g), w_ceil, (_, rng_y, _) in zip(enc, durations, rngs):
            t_y = max(int(w_ceil.sum()), 1)
            noise = torch.from_numpy(rng_y.standard_normal((t_y, tts.cfg.inter_channels)).astype(np.float32))
            z_p = R.tts_latents(m_p, logs_p, w_ceil, noise.to(self.device), NOISE_SCALE)
            with R.stored(stage, [tts.flow, tts.dec]):
                pieces += [R.np_audio(R.tts_decode(tts, z_p, g)), np.zeros(self.gap(), np.float32)]
        return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)


def pool_seconds(config: dict, mix: dict, overrides: dict | None = None) -> list[float]:
    """Each pool line's audio seconds (no gaps) by the reference's text side
    on the CPU, with the line's own duration noise (`Driver.line_seed`);
    `overrides` in place of the configuration's ``weights`` entries."""
    from ovbench.traffic import text_lines

    config = dict(config, weights=dict(config["weights"], **(overrides or {})))
    sd, bsd = melo_weights(config, 0, "cpu")   # the text side is the fixed seed's
    cfg = RM.MeloConfig.from_dict(config["model"])
    model, bert = RM.Synthesizer(cfg), RM.Bert(RM.BertConfig.from_dict(config["bert"]))
    model.load_state_dict(sd, strict=True)
    bert.load_state_dict(bsd, strict=True)
    out = []
    with torch.no_grad(), R.precision("f32"):
        for text, style in text_lines(mix):
            pieces = RM.split_pieces(text)
            rngs = chain.sentence_rngs(Driver.line_seed({"speaker": style, "text": text}), len(pieces))
            frames = 0
            for piece, (rng_w, _, _) in zip(pieces, rngs):
                toks = RM.melo_tokens(piece, cfg.n_vocab, int(config["bert"]["vocab_size"]))
                noise_w = torch.from_numpy(rng_w.standard_normal((len(toks.phones), 2)).astype(np.float32))
                w = RM.tts_durations(model, bert, toks, style % SPEAKERS, noise_w, NOISE_SCALE_W, SDP_RATIO)[2]
                frames += max(int(torch.ceil(w).sum()), 1)
            out.append(frames * cfg.upsample_factor / cfg.sampling_rate)
    return out


def levels(config: dict, mix: dict, seed: int) -> dict:
    """rms and peak of the reference's f32 answers to six pool requests on
    the card, each piece alone, gaps left out (what ``conv_post_gain`` was
    set from)."""
    from ovbench.traffic import Traffic

    fields = config["model"]
    traffic = Traffic(mix, seed, int(fields["gin_channels"]), int(fields["sampling_rate"]))
    driver = Driver({"driver": "melo_tts"}, config, traffic, seed, torch.device("cuda", 0))
    audio = [a[np.abs(a) > 0] for a in driver.reference(traffic.pool[:6])]
    return {"seed": seed, "rms": [float(np.sqrt(np.mean(a ** 2))) for a in audio],
            "peak": [float(np.abs(a).max()) for a in audio]}


def main(argv: list[str]) -> int:
    """``python3 ovbench/drivers/melo_tts.py durations [key=value …]``: each pool
    line's seconds against the LJ Speech length it was drawn for, with its
    own duration noise, on the CPU (how ``duration_shrink`` and
    ``duration_offset`` were chosen).
    ``… levels [key=value …]``: `levels` on the card at two seeds."""
    import json

    from ovbench.traffic import load_mix, seconds

    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / "configs" / "melo_tts_en.json").read_text())
    mix = load_mix("prose_lines")
    if argv[0] == "levels":
        config["weights"].update({k: float(v) for k, v in (a.split("=") for a in argv[1:])})
        for seed in (2718281828459, 31415926535):
            print(json.dumps({**levels(config, mix, seed), "conv_post_gain": config["weights"]["conv_post_gain"]}))
        return 0
    overrides = {k: float(v) for k, v in (a.split("=") for a in argv[1:])}
    want = [seconds(mix)[j] for j in np.random.default_rng(0).permutation(mix["pool"])]
    got = np.asarray(pool_seconds(config, mix, overrides))
    ratio = got / np.asarray(want)
    print(json.dumps({**config["weights"], **overrides,
                      "mean_ratio": float(got.mean() / np.mean(want)), "ratio_min": float(ratio.min()),
                      "ratio_max": float(ratio.max()), "seconds_min": float(got.min()),
                      "seconds_max": float(got.max()), "seconds_mean": float(got.mean())}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
