"""The plain f32 reference of MeloTTS-English, OpenVoice V2's base speaker
(https://github.com/myshell-ai/MeloTTS: melo/models.py, melo/attentions.py,
melo/modules.py, melo/text/english_bert.py, melo/utils.py::
get_text_for_tts_infer, melo/api.py::tts_to_file; its BERT
https://huggingface.co/google-bert/bert-base-uncased).

One sentence at a time at its true length, with no bucket, batch, mask,
kernel or graph: BERT (post-LayerNorm, erf GELU, layers 1-10, whose output
is ``hidden_states[-3]``), the text encoder with its tone, language and BERT
inputs and the speaker before layer 2, both duration predictors, the length
regulation, the transformer-coupling flow in reverse and the five-stage
HiFi-GAN.  Convolutions and products in float32 with TF32 off
(`model.precision`).  The stock modules come from ``layers.py`` (the
relative-attention `Encoder` with its speaker input, the duration
predictors, the generator) and are used as they are; nothing here imports
the program.

Departures from melo/*.py, each where it is made:

* the text side's stand-ins for files the repository does not hold (its
  symbol table, cmudict and g2p_en, bert-base-uncased's ``vocab.txt``):
  `melo_tokens`, this module's own copy of the program's;
* the posterior encoder is held so that the state dict is the checkpoint's,
  and never run (inference does not use it);
* the English ``bert`` input is zeros, as melo/utils.py makes it, so
  ``bert_proj`` reads a zero [1024, T] tensor here, literally.
"""

from __future__ import annotations

import dataclasses
import math
import re
import zlib
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ovbench.reference.layers import (
    DurationPredictor, Encoder, Flip, Generator, StochasticDurationPredictor, conv1d,
)
from ovbench.reference.model import Config, PosteriorEncoder
from ovbench.reference.text.english import normalize_english, word_to_ipa

# -- the text side (melo/text/english.py::g2p, get_text_for_tts_infer) ------------

EN_LANGUAGE_ID = 2          # melo/text/symbols.py language_id_map["EN"]
EN_TONE_START = 7           # its language_tone_start_map["EN"]: 6 Chinese tones + 1 Japanese
CLS_ID, SEP_ID = 101, 102   # bert-base-uncased's [CLS] and [SEP]
WORDPIECE_FIRST = 1996      # its first whole-word row
_DIPHTHONGS = ("aɪ", "eɪ", "oʊ", "aʊ", "ɔɪ")
_VOWELS = set("aeiouæɑɔəɛɪʊʌɜɚ")
_STRESS_TONE = {"ˈ": 2, "ˌ": 3}


class Tokens(NamedTuple):
    phones: list[int]
    tones: list[int]
    languages: list[int]
    wordpieces: list[int]
    word2ph: list[int]


def _hash(text: str, first: int, rows: int) -> int:
    return first + zlib.crc32(text.encode("utf-8")) % rows


def _word_phones(word: str) -> tuple[list[str], list[int]]:
    """Stand-in for MeloTTS's ARPAbet g2p: the IPA of the English front end
    split into phonemes (diphthongs whole); a vowel's tone is ARPAbet's
    stress digit + 1 (1 unstressed, 2 after ˈ, 3 after ˌ), a consonant's 0."""
    ipa = word_to_ipa(word)
    phones, tones, stress, i = [], [], 0, 0
    while i < len(ipa):
        if ipa[i] in _STRESS_TONE:
            stress, i = _STRESS_TONE[ipa[i]], i + 1
            continue
        ph = ipa[i : i + 2] if ipa[i : i + 2] in _DIPHTHONGS else ipa[i]
        i += len(ph)
        if ph[0] in _VOWELS:
            tones.append(stress or 1)
            stress = 0
        else:
            tones.append(0)
        phones.append(ph)
    return phones, tones


def melo_tokens(sentence: str, n_vocab: int, vocab_size: int) -> Tokens:
    """One piece → phones, tones, languages (pad phone at each end, blanks
    interspersed with 0 in all three), wordpieces ([CLS], one a word or
    punctuation mark by a fixed hash, [SEP]) and word2ph (each wordpiece's
    phones, doubled, one more on the first).  Phone ids: a fixed hash into
    rows 1 … n_vocab − 1 (row 0 is the pad and the blank)."""
    words = re.findall(r"[a-z']+|[^a-z'\s]", normalize_english(sentence))
    phones, tones, word2ph, pieces = ["_"], [0], [1], [CLS_ID]
    for w in words:
        ph, tn = _word_phones(w) if re.fullmatch(r"[a-z']+", w) else ([w], [0])
        phones, tones = phones + ph, tones + tn
        word2ph.append(len(ph))
        pieces.append(_hash(w, WORDPIECE_FIRST, vocab_size - WORDPIECE_FIRST))
    phones, tones, word2ph, pieces = phones + ["_"], tones + [0], word2ph + [1], pieces + [SEP_ID]
    ids = [0 if p == "_" else _hash(p, 1, n_vocab - 1) for p in phones]

    def blank(seq):
        out = [0] * (2 * len(seq) + 1)
        out[1::2] = seq
        return out

    word2ph = [2 * n for n in word2ph]
    word2ph[0] += 1
    return Tokens(blank(ids), blank([t + EN_TONE_START for t in tones]), blank([EN_LANGUAGE_ID] * len(ids)),
                  pieces, word2ph)


def split_pieces(text: str) -> list[str]:
    """melo/split_utils.py::split_sentences_latin: txtsplit(text, 256, 512)."""
    text = re.sub("[。！？；]", ".", text)
    text = re.sub("[，]", ",", text)
    text = re.sub("[“”]", '"', text)
    text = re.sub("[‘’]", "'", text)
    text = re.sub(r"[\<\>\(\)\[\]\"\«\»]+", "", text)
    return [p.strip() for p in _txtsplit(text, 256, 512) if p.strip()]


def _txtsplit(text: str, desired_length: int, max_length: int) -> list[str]:
    text = re.sub(r"\n\n+", "\n", text)
    text = re.sub(r"\s+", " ", text)
    text = re.sub(r"[“”]", '"', text)
    text = re.sub(r"([,.?!])", r"\1 ", text)
    text = re.sub(r"\s+", " ", text)
    rv, state = [], {"pos": -1, "quote": False, "cur": "", "splits": []}
    end = len(text) - 1

    def seek(delta: int) -> str:
        for _ in range(abs(delta)):
            if delta < 0:
                state["pos"] -= 1
                state["cur"] = state["cur"][:-1]
            else:
                state["pos"] += 1
                state["cur"] += text[state["pos"]]
            if text[state["pos"]] == '"':
                state["quote"] = not state["quote"]
        return text[state["pos"]]

    def peek(delta: int) -> str:
        p = state["pos"] + delta
        return text[p] if 0 <= p < end else ""

    def commit() -> None:
        rv.append(state["cur"])
        state["cur"], state["splits"] = "", []

    while state["pos"] < end:
        c = seek(1)
        if len(state["cur"]) >= max_length:
            if state["splits"] and len(state["cur"]) > desired_length / 2:
                seek(-(state["pos"] - state["splits"][-1]))
            else:
                while c not in "!?.\n " and state["pos"] > 0 and len(state["cur"]) > desired_length:
                    c = seek(-1)
            commit()
        elif not state["quote"] and (c in "!?\n" or (c in ".," and peek(1) in "\n ")):
            while state["pos"] < len(text) - 1 and len(state["cur"]) < max_length and peek(1) in "!?.":
                c = seek(1)
            state["splits"].append(state["pos"])
            if len(state["cur"]) >= desired_length:
                commit()
        elif state["quote"] and peek(1) == '"' and peek(2) in "\n ":
            seek(2)
            state["splits"].append(state["pos"])
    rv.append(state["cur"])
    return [s.strip() for s in rv if s.strip() and not re.match(r"^[\s\.,;:!?]*$", s.strip())]


# -- the configuration ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeloConfig(Config):
    """MeloTTS's widths (its config.json and SynthesizerTrn's arguments)."""

    num_tones: int = 16
    num_languages: int = 10
    bert_channels: int = 1024
    ja_bert_channels: int = 768
    n_layers_trans_flow: int = 3

    @staticmethod
    def from_dict(d: dict) -> "MeloConfig":
        known = {f.name for f in dataclasses.fields(MeloConfig)}
        kw = {k: v for k, v in d.items() if k in known}
        for k in ("resblock_kernel_sizes", "upsample_rates", "upsample_kernel_sizes"):
            if k in kw:
                kw[k] = tuple(kw[k])
        if "resblock_dilation_sizes" in kw:
            kw["resblock_dilation_sizes"] = tuple(tuple(x) for x in kw["resblock_dilation_sizes"])
        return MeloConfig(**kw)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """bert-base-uncased's widths; `num_layers` the layers run."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_layers: int = 10

    @staticmethod
    def from_dict(d: dict) -> "BertConfig":
        known = {f.name for f in dataclasses.fields(BertConfig)}
        return BertConfig(**{k: v for k, v in d.items() if k in known})


# -- BERT (Hugging Face's BertModel, in the layout of its state dict) ------------------

class _Embeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class _SelfAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.query, self.key, self.value = (nn.Linear(c.hidden_size, c.hidden_size) for _ in range(3))


class _Output(nn.Module):
    def __init__(self, c: BertConfig, width_in: int):
        super().__init__()
        self.dense = nn.Linear(width_in, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class _Attention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _Output(c, c.hidden_size)


class _Intermediate(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size)


class _Layer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _Output(c, c.intermediate_size)


class _Encoder(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c.num_layers))


class Bert(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.cfg = c
        self.embeddings = _Embeddings(c)
        self.encoder = _Encoder(c)


def bert_features(bert: Bert, wordpieces: list[int], device) -> torch.Tensor:
    """One sentence's wordpieces (no padding, so no mask) → the output of
    the last layer run [W, hidden], MeloTTS's ``hidden_states[-3]``."""
    c = bert.cfg
    ids = torch.tensor(wordpieces, device=device)
    e = bert.embeddings
    x = e.word_embeddings(ids) + e.token_type_embeddings(torch.zeros_like(ids))
    x = e.LayerNorm(x + e.position_embeddings(torch.arange(len(wordpieces), device=device)))
    heads, dk = c.num_attention_heads, c.hidden_size // c.num_attention_heads
    for layer in bert.encoder.layer:
        a = layer.attention.self
        q, k, v = (m(x).reshape(-1, heads, dk).transpose(0, 1) for m in (a.query, a.key, a.value))
        ctx = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(dk), dim=-1) @ v
        x = layer.attention.output.LayerNorm(layer.attention.output.dense(ctx.transpose(0, 1).reshape(x.shape)) + x)
        y = layer.output.dense(F.gelu(layer.intermediate.dense(x)))
        x = layer.output.LayerNorm(y + x)
    return x


# -- the synthesizer (melo/models.py) ------------------------------------------------

class TextEncoder(nn.Module):
    """melo/models.py TextEncoder: ``emb``, ``tone_emb``, ``language_emb``,
    ``bert_proj``, ``ja_bert_proj``, ``encoder`` (speaker before layer 2),
    ``proj``."""

    def __init__(self, cfg: MeloConfig):
        super().__init__()
        h = cfg.hidden_channels
        self.emb = nn.Embedding(cfg.n_vocab, h)
        self.tone_emb = nn.Embedding(cfg.num_tones, h)
        self.language_emb = nn.Embedding(cfg.num_languages, h)
        self.bert_proj = nn.Conv1d(cfg.bert_channels, h, 1)
        self.ja_bert_proj = nn.Conv1d(cfg.ja_bert_channels, h, 1)
        self.encoder = Encoder(h, cfg.filter_channels, cfg.n_heads, cfg.n_layers, cfg.kernel_size,
                               cfg.attn_window_size, gin_channels=cfg.gin_channels)
        self.proj = conv1d(h, 2 * cfg.inter_channels)


class TransformerCouplingLayer(nn.Module):
    """melo/modules.py TransformerCouplingLayer, mean-only: ``pre``, ``enc``
    (a relative-attention encoder over the frames, FFN kernel 5, speaker
    before layer 2), ``post``."""

    def __init__(self, cfg: MeloConfig):
        super().__init__()
        self.half = cfg.inter_channels // 2
        self.pre = conv1d(self.half, cfg.hidden_channels)
        self.enc = Encoder(cfg.hidden_channels, cfg.filter_channels, cfg.n_heads, cfg.n_layers_trans_flow,
                           cfg.flow_kernel_size, cfg.attn_window_size, gin_channels=cfg.gin_channels)
        self.post = conv1d(cfg.hidden_channels, self.half)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, : self.half], x[:, self.half :]
        h = self.enc(self.pre(x0) * x_mask, x_mask, g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else m + x1 * x_mask   # exp(±logs) = 1: mean-only
        return torch.cat([x0, x1], dim=1)


class TransformerCouplingBlock(nn.Module):
    """4 × [coupling, Flip]; ``flows.{0,2,4,6}`` the couplings."""

    def __init__(self, cfg: MeloConfig):
        super().__init__()
        flows: list[nn.Module] = []
        for _ in range(cfg.flow_n_flows):
            flows += [TransformerCouplingLayer(cfg), Flip()]
        self.flows = nn.ModuleList(flows)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        for flow in (reversed(self.flows) if reverse else self.flows):
            x = flow(x, x_mask, g=g, reverse=reverse)
        return x


class Synthesizer(nn.Module):
    """melo/models.py SynthesizerTrn under its state-dict names: ``enc_p``,
    ``enc_q`` (held, not run), ``flow``, ``dec``, ``sdp``, ``dp``,
    ``emb_g``."""

    def __init__(self, cfg: MeloConfig):
        super().__init__()
        self.cfg = cfg
        self.enc_p = TextEncoder(cfg)
        self.enc_q = PosteriorEncoder(cfg)
        self.flow = TransformerCouplingBlock(cfg)
        self.dec = Generator(cfg)
        self.sdp = StochasticDurationPredictor(cfg.hidden_channels, cfg.sdp_kernel_size, gin_channels=cfg.gin_channels)
        self.dp = DurationPredictor(cfg.hidden_channels, cfg.dp_filter_channels, cfg.dp_kernel_size,
                                    cfg.gin_channels)
        self.emb_g = nn.Embedding(cfg.n_speakers, cfg.gin_channels)


def tts_durations(model: Synthesizer, bert: Bert, toks: Tokens, sid: int, noise_w: torch.Tensor,
                  noise_scale_w: float = 0.8, sdp_ratio: float = 0.2, length_scale: float = 1.0):
    """The text side of one piece (SynthesizerTrn.infer up to w): → (m_p,
    logs_p [T_x, inter], w [T_x] durations before the ceiling, g [gin]).
    noise_w [T_x, 2] standard normal."""
    cfg, dev = model.cfg, noise_w.device
    feats = bert_features(bert, toks.wordpieces, dev)                       # [W, 768]
    ja_bert = torch.repeat_interleave(feats, torch.tensor(toks.word2ph, device=dev), dim=0).t()[None]
    t_x = len(toks.phones)
    bert_zeros = torch.zeros(1, cfg.bert_channels, t_x, device=dev)
    enc = model.enc_p
    x = (enc.emb(torch.tensor(toks.phones, device=dev)) + enc.tone_emb(torch.tensor(toks.tones, device=dev))
         + enc.language_emb(torch.tensor(toks.languages, device=dev)) + enc.bert_proj(bert_zeros)[0].t()
         + enc.ja_bert_proj(ja_bert)[0].t()) * math.sqrt(cfg.hidden_channels)
    x = x.t()[None]                                                         # [1, H, T_x]
    mask = torch.ones(1, 1, t_x, device=dev)
    g = model.emb_g.weight[sid].reshape(1, -1, 1)
    h = enc.encoder(x, mask, g)
    stats = enc.proj(h)
    m_p, logs_p = stats[0, : cfg.inter_channels].t(), stats[0, cfg.inter_channels:].t()
    logw = (model.sdp.reverse(h, mask, noise_w.t()[None], g, noise_scale_w) * sdp_ratio
            + model.dp(h, mask, g) * (1.0 - sdp_ratio))
    return m_p, logs_p, (torch.exp(logw) * length_scale)[0, 0], g.reshape(-1)
