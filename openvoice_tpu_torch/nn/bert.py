"""The BERT encoder that gives MeloTTS its word features
(melo/text/english_bert.py: bert-base-uncased,
https://huggingface.co/google-bert/bert-base-uncased).

Post-LayerNorm BERT in plain PyTorch, f32: word, position and token-type
embeddings → LayerNorm → `num_layers` × [self-attention → dense → LayerNorm
(x + y) → dense → GELU (erf) → dense → LayerNorm (x + y)].  MeloTTS keeps
``hidden_states[-3]`` of the 12-layer model, the output of layer 10, so only
those layers are built and run.  Attributes follow the Hugging Face
``BertModel`` state-dict keys (``embeddings.word_embeddings``,
``encoder.layer.N.attention.self.query``, …): a bert-base-uncased state dict
loads with its layers past `num_layers` and its pooler left out.

A padded batch gives each row what it gives alone: keys past a row's length
are masked with float32's lowest value (as Hugging Face's extended mask), so
their softmax weight is exactly 0; positions past the length hold values
that no true position reads.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """bert-base-uncased's widths (its config.json), and the layers run."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_layers: int = 10  # hidden_states[-3] of the 12-layer model


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = self.word_embeddings(ids) + self.token_type_embeddings(torch.zeros_like(ids))
        return self.LayerNorm(x + self.position_embeddings(pos)[None])


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """x [B, W, H], key_mask [B, 1, 1, W] bool → [B, W, H]."""
        b, w, h = x.shape
        dk = h // self.heads

        def split(z):  # [B, W, H] → [B, heads, W, dk]
            return z.reshape(b, w, self.heads, dk).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = (q @ k.transpose(2, 3)) / math.sqrt(dk)
        scores = scores.masked_fill(~key_mask, torch.finfo(scores.dtype).min)
        return (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, w, h)


class _DenseNorm(nn.Module):
    """``dense`` then ``LayerNorm(x + residual)``: BERT's attention output
    and layer output."""

    def __init__(self, cfg: BertConfig, width_in: int):
        super().__init__()
        self.dense = nn.Linear(width_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = _DenseNorm(cfg, cfg.hidden_size)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = _DenseNorm(cfg, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        x = self.attention.output(self.attention.self(x, key_mask), x)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


class Bert(nn.Module):
    """``embeddings`` and ``encoder.layer.0 … num_layers − 1``."""

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(self, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """ids [B, W] wordpieces ([CLS] … [SEP], padded), lengths [B] →
        the last built layer's output [B, W, hidden]."""
        key_mask = (torch.arange(ids.shape[1], device=ids.device)[None, :] < lengths[:, None])[:, None, None, :]
        x = self.embeddings(ids.long())
        for layer in self.encoder.layer:
            x = layer(x, key_mask)
        return x


def init_bert(cfg: BertConfig, generator: torch.Generator) -> Bert:
    """Random weights with BERT's own initialisation (initializer_range
    0.02): every embedding and dense weight normal(0, 0.02), biases 0,
    LayerNorms 1 and 0."""
    model = Bert(cfg)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, 0.02, generator=generator)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
    return model


def load_bert_state_dict(state_dict: dict, cfg: BertConfig = BertConfig()) -> Bert:
    """A Hugging Face ``BertModel`` state dict (bert-base-uncased's, with or
    without the ``bert.`` prefix of its pretraining heads) → a CPU `Bert` of
    `cfg`'s layers, strictly: the layers past them, the pooler and any head
    are left out."""
    keep = {}
    for key, value in state_dict.items():
        key = key[len("bert."):] if key.startswith("bert.") else key
        parts = key.split(".")
        if parts[0] == "embeddings" and "position_ids" not in key:
            keep[key] = value
        elif parts[:2] == ["encoder", "layer"] and int(parts[2]) < cfg.num_layers:
            keep[key] = value
    model = Bert(cfg)
    model.load_state_dict(keep, strict=True)
    return model.eval()
