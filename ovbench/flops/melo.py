"""Operations of MeloTTS-English's work, from shapes alone, as the package's
counts (a multiply-add is 2 operations; elementwise work, gathers and
softmax are not counted; a request's work at its true sizes, whatever pads
it).

A piece of a request is (wordpieces W, tokens T, frames F):

* `bert`: layers 1 … num_layers of BERT over W wordpieces (Q, K, V and the
  output projection, the W² scores and weighted values, the FFN);
* `text_side`: the V1 text encoder, stochastic and deterministic duration
  predictors (`flops.tts_encode`, the same layers), plus MeloTTS's BERT
  projection of each phone's feature (``ja_bert_proj``; the English
  ``bert`` input is zeros, whose product is no work) and the speaker's
  projection into the encoder;
* `flow`: the transformer-coupling flow in one direction over F frames:
  per coupling pre, a relative-attention encoder of ``n_layers_trans_flow``
  layers with its F² scores and FFN of kernel ``flow_kernel_size``, the
  speaker's projection, post;
* the length regulation (`flops.tts_decode`'s alignment products) and the
  decoder (`flops.decoder`); K3 and K4's shares through `flops.k3` and
  `flops.k4`, which read the stages from the configuration.

Every width is read from the configuration file (``model`` and ``bert``).
"""

from __future__ import annotations

import json
from pathlib import Path

from ovbench import flops
from ovbench.reference.model import Config

ROOT = Path(__file__).resolve().parent.parent


def cell_config(cell: str) -> dict:
    """The configuration file of benchmark cell `cell`."""
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    return json.loads((ROOT / "configs" / f"{entry['config']}.json").read_text())


def bert(b: dict, wordpieces: int) -> float:
    w, h, i = wordpieces, b["hidden_size"], b["intermediate_size"]
    return b["num_layers"] * (8.0 * w * h * h + 4.0 * w * w * h + 4.0 * w * h * i)


def _encoder(m: dict, t: int, n_layers: int, k: int) -> float:
    """`n_layers` relative-attention layers over t positions, FFN kernel k."""
    h, f, w = m["hidden_channels"], m["filter_channels"], m["attn_window_size"]
    layer = 4 * 2.0 * t * h * h + 2 * 2.0 * t * t * h + 2 * 2.0 * t * (2 * w + 1) * h
    return n_layers * (layer + 2 * 2.0 * t * h * f * k)


def text_side(m: dict, tokens: int) -> float:
    cfg = Config.from_dict(m)
    extra = 2.0 * tokens * m["ja_bert_channels"] * m["hidden_channels"] + 2.0 * m["gin_channels"] * m["hidden_channels"]
    return flops.tts_encode(cfg, tokens) + extra


def flow(m: dict, frames: int) -> float:
    h, half = m["hidden_channels"], m["inter_channels"] // 2
    coupling = (2 * 2.0 * frames * half * h + 2.0 * m["gin_channels"] * h
                + _encoder(m, frames, m["n_layers_trans_flow"], m["flow_kernel_size"]))
    return m["flow_n_flows"] * coupling


def decode(m: dict, tokens: int, frames: int) -> float:
    """Length regulation, the flow in reverse and the decoder."""
    cfg = Config.from_dict(m)
    return 2 * 2.0 * frames * tokens * m["inter_channels"] + flow(m, frames) + flops.decoder(cfg, frames)


def request(config: dict, work: dict) -> float:
    """Every product of one request: ``work["melo"]`` its pieces."""
    m, b = config["model"], config["bert"]
    return sum(bert(b, w) + text_side(m, t) + decode(m, t, f) for w, t, f in work.get("melo", []))


def kernels(config: dict, work: dict) -> dict[str, tuple[float, float]]:
    """(operations, bytes) of K3 (decoder stages 0-1) and K4 (stages 2 on,
    conv_post with the last) for one request, by wrapper module."""
    cfg = Config.from_dict(config["model"])
    out = {"mrf_cuda": [0.0, 0.0], "tail_cuda": [0.0, 0.0]}
    for _, _, f in work.get("melo", []):
        for module, fb in (("mrf_cuda", flops.k3(cfg, f)), ("tail_cuda", flops.k4(cfg, f))):
            out[module][0] += fb[0]
            out[module][1] += fb[1]
    return {k: (v[0], v[1]) for k, v in out.items()}


def roofline_share(ctx, cell: str, modules: dict) -> float | None:
    """The share of their rooflines that the kernels of `modules` (wrapper
    module → kernel names in the trace) reach in a traced run of `cell`:
    the least time their work in the traced requests takes over their
    records' device time.  None without a complete trace."""
    if ctx.trace is None or not ctx.trace.complete or ctx.peaks is None or not ctx.traced:
        return None
    config = cell_config(cell)
    bound = 0.0
    for r in ctx.traced:
        for module, (flop, nbytes) in kernels(config, r.work).items():
            if module in modules and flop:
                bound += flops.bound_s(module, flop, nbytes, ctx.peaks)
    spent = sum(ctx.trace.time_of(names) for names in modules.values())
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
