"""Reference ``.pth`` checkpoints → the port's `Synthesizer` (the port of
``openvoice_tpu/ckpt/torch_import.py``).

The JAX package's importer decides, key by key, what a reference checkpoint
gives each parameter; this module makes the same decisions and writes every
parameter of the module explicitly, so that no leaf keeps a random draw:

* weight norm is folded in both of its styles (``X.weight_g`` /
  ``X.weight_v``, and torch ≥ 2.1's ``X.parametrizations.weight.original0``
  / ``original1``): w = g · v / ‖v‖, the norm over every dimension but 0;
* a missing bias becomes zeros (JAX's ``sd.get(key, shape)``), and is
  reported missing;
* a missing conv weight raises ``KeyError("missing conv weight for X")``;
* a leaf that JAX reads with no shape to fall back on (layer norms, token
  and speaker tables, the relative-position embeddings, the duration
  flows' elementwise affine, the GRU and the linear layers) is left
  ``None`` there and fails later; here it raises a ``KeyError`` that names
  the key, at load;
* optional layers follow JAX's presence tests: a conditioning layer
  (``dec.cond``, ``sdp.cond``, ``dp.cond``, a WaveNet's ``cond_layer``) or
  the reference encoder's ``layernorm`` that the file lacks is taken out of
  the module (set to ``None``, the layer norm to an identity), as JAX
  leaves it out of the pytree, and is not reported;
* the report is ``{"missing": [...], "unexpected": [...]}``, the keys in
  the order JAX lists them (``strict=False`` semantics, reference
  api.py:37).

`load_torch_checkpoint` reads the file with ``weights_only=False``, as the
JAX package does: reference checkpoints written by training scripts carry
non-tensor entries (iteration counts, numpy learning rates), and a
weights-only unpickler refuses them.  Load only checkpoints you trust.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from openvoice_tpu_torch.ckpt.native_io import load_npz
from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.models.synthesizer import Synthesizer

# the JAX package's ``load_params_npz``: the same tree of numpy arrays as
# `native_io.load_npz` (numeric keys become lists, in numeric order)
load_params_npz = load_npz


class _SD:
    """State-dict view that records which keys were consumed / missing."""

    def __init__(self, sd: Mapping[str, torch.Tensor]):
        self.sd = {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}
        self.used: set[str] = set()
        self.missing: list[str] = []

    def get(self, key: str, shape: tuple | None = None) -> torch.Tensor | None:
        if key in self.sd:
            self.used.add(key)
            return self.sd[key].to(torch.float32)
        self.missing.append(key)
        return None if shape is None else torch.zeros(shape, dtype=torch.float32)

    def need(self, key: str) -> torch.Tensor:
        """A leaf JAX reads with no fallback shape: absent, it raises."""
        value = self.get(key)
        if value is None:
            raise KeyError(f"missing {key}: the checkpoint has no value for it and no default exists")
        return value

    def has(self, key: str) -> bool:
        return key in self.sd

    def unexpected(self) -> list[str]:
        return [k for k in self.sd if k not in self.used]


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch._weight_norm(v, g, dim=0): w = g · v / ‖v‖, norm over dims > 0."""
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    return g * v / norm


def _conv_w(sd: _SD, prefix: str) -> torch.Tensor:
    """A conv weight in torch layout, weight norm folded."""
    if sd.has(f"{prefix}.weight_v"):
        return fold_weight_norm(sd.get(f"{prefix}.weight_g"), sd.get(f"{prefix}.weight_v"))
    if sd.has(f"{prefix}.parametrizations.weight.original0"):
        return fold_weight_norm(sd.get(f"{prefix}.parametrizations.weight.original0"),
                                sd.get(f"{prefix}.parametrizations.weight.original1"))
    w = sd.get(f"{prefix}.weight")
    if w is None:
        raise KeyError(f"missing conv weight for {prefix}")
    return w


def _conv(sd: _SD, prefix: str, out: dict, bias: bool = True, transposed: bool = False) -> None:
    """Conv1d, Conv2d, ConvTranspose1d ([in, out, k]: `transposed`), or a
    1×1 conv used as a linear projection; the bias has the output
    channels' width."""
    w = _conv_w(sd, prefix)
    out[f"{prefix}.weight"] = w
    if bias:
        out[f"{prefix}.bias"] = sd.get(f"{prefix}.bias", (w.shape[1] if transposed else w.shape[0],))


def _linear(sd: _SD, prefix: str, out: dict) -> None:
    w = sd.need(f"{prefix}.weight")
    out[f"{prefix}.weight"] = w
    out[f"{prefix}.bias"] = sd.get(f"{prefix}.bias", (w.shape[0],))


def _ln(sd: _SD, prefix: str, out: dict, names: tuple[str, str] = ("gamma", "beta")) -> None:
    for name in names:
        out[f"{prefix}.{name}"] = sd.need(f"{prefix}.{name}")


def _has_conv(sd: _SD, prefix: str) -> bool:
    return any(sd.has(f"{prefix}.{leaf}") for leaf in
               ("weight_v", "weight", "parametrizations.weight.original0"))


def _wn(sd: _SD, wn: nn.Module, prefix: str, n_layers: int, gin: int, out: dict) -> None:
    for i in range(n_layers):
        _conv(sd, f"{prefix}.in_layers.{i}", out)
        _conv(sd, f"{prefix}.res_skip_layers.{i}", out)
    if gin and _has_conv(sd, f"{prefix}.cond_layer"):
        _conv(sd, f"{prefix}.cond_layer", out)
    else:
        wn.cond_layer = None


def _ddsconv(sd: _SD, prefix: str, n_layers: int, out: dict) -> None:
    for i in range(n_layers):
        _conv(sd, f"{prefix}.convs_sep.{i}", out)
        _conv(sd, f"{prefix}.convs_1x1.{i}", out)
        _ln(sd, f"{prefix}.norms_1.{i}", out)
        _ln(sd, f"{prefix}.norms_2.{i}", out)


def _sdp_flows(sd: _SD, prefix: str, out: dict) -> None:
    """[EA, CF, Flip, CF, Flip, CF, Flip, CF, Flip]."""
    out[f"{prefix}.0.m"] = sd.need(f"{prefix}.0.m")
    out[f"{prefix}.0.logs"] = sd.need(f"{prefix}.0.logs")
    for i in (1, 3, 5, 7):
        _conv(sd, f"{prefix}.{i}.pre", out)
        _ddsconv(sd, f"{prefix}.{i}.convs", 3, out)
        _conv(sd, f"{prefix}.{i}.proj", out)


def _optional_conv(sd: _SD, owner: nn.Module, prefix: str, out: dict) -> None:
    """A conditioning conv that JAX takes only when ``<prefix>.weight`` is in
    the file; otherwise it leaves the module."""
    if sd.has(f"{prefix}.weight"):
        _conv(sd, prefix, out)
    else:
        setattr(owner, prefix.rsplit(".", 1)[1], None)


def import_synthesizer(state_dict: Mapping[str, torch.Tensor],
                       cfg: SynthesizerConfig) -> tuple[Synthesizer, dict]:
    """A reference SynthesizerTrn state dict → (a CPU `Synthesizer` in eval
    mode, report), with the JAX importer's semantics (module docstring)."""
    sd = _SD(state_dict)
    with torch.device("meta"):
        model = Synthesizer(cfg)
    out: dict[str, torch.Tensor] = {}

    _conv(sd, "enc_q.pre", out)
    _wn(sd, model.enc_q.enc, "enc_q.enc", cfg.enc_q_layers, cfg.gin_channels, out)
    _conv(sd, "enc_q.proj", out)
    for i in range(cfg.flow_n_flows):
        fp = f"flow.flows.{2 * i}"  # odd slots are the parameter-free flips
        _conv(sd, f"{fp}.pre", out)
        _wn(sd, model.flow.flows[2 * i].enc, f"{fp}.enc", cfg.flow_wn_layers, cfg.gin_channels, out)
        _conv(sd, f"{fp}.post", out)

    for i in range(len(cfg.upsample_rates)):
        _conv(sd, f"dec.ups.{i}", out, transposed=True)
    n_res = len(cfg.upsample_rates) * len(cfg.resblock_kernel_sizes)
    for n in range(n_res):
        if cfg.resblock == "1":
            n_d = len(cfg.resblock_dilation_sizes[n % len(cfg.resblock_kernel_sizes)])
            for name in ("convs1", "convs2"):
                for j in range(n_d):
                    _conv(sd, f"dec.resblocks.{n}.{name}.{j}", out)
        else:
            for j in range(2):
                _conv(sd, f"dec.resblocks.{n}.convs.{j}", out)
    _conv(sd, "dec.conv_pre", out)
    _conv(sd, "dec.conv_post", out, bias=False)
    _optional_conv(sd, model.dec, "dec.cond", out)

    if cfg.n_speakers == 0:
        for i in range(6):
            _conv(sd, f"ref_enc.convs.{i}", out)
        for leaf in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
            out[f"ref_enc.gru.{leaf}"] = sd.need(f"ref_enc.gru.{leaf}")
        if sd.has("ref_enc.layernorm.weight"):
            _ln(sd, "ref_enc.layernorm", out, names=("weight", "bias"))
        else:
            model.ref_enc.layernorm = nn.Identity()
        _linear(sd, "ref_enc.proj", out)
    else:
        for i in range(cfg.n_layers):
            ap = f"enc_p.encoder.attn_layers.{i}"
            for name in ("q", "k", "v", "o"):
                _conv(sd, f"{ap}.conv_{name}", out)
            out[f"{ap}.emb_rel_k"] = sd.need(f"{ap}.emb_rel_k")
            out[f"{ap}.emb_rel_v"] = sd.need(f"{ap}.emb_rel_v")
            _ln(sd, f"enc_p.encoder.norm_layers_1.{i}", out)
            _conv(sd, f"enc_p.encoder.ffn_layers.{i}.conv_1", out)
            _conv(sd, f"enc_p.encoder.ffn_layers.{i}.conv_2", out)
            _ln(sd, f"enc_p.encoder.norm_layers_2.{i}", out)
        out["enc_p.emb.weight"] = sd.need("enc_p.emb.weight")
        _conv(sd, "enc_p.proj", out)
        for name in ("pre", "proj"):
            _conv(sd, f"sdp.{name}", out)
        _ddsconv(sd, "sdp.convs", 3, out)
        _sdp_flows(sd, "sdp.flows", out)
        for name in ("post_pre", "post_proj"):
            _conv(sd, f"sdp.{name}", out)
        _ddsconv(sd, "sdp.post_convs", 3, out)
        _sdp_flows(sd, "sdp.post_flows", out)
        _optional_conv(sd, model.sdp, "sdp.cond", out)
        _conv(sd, "dp.conv_1", out)
        _ln(sd, "dp.norm_1", out)
        _conv(sd, "dp.conv_2", out)
        _ln(sd, "dp.norm_2", out)
        _conv(sd, "dp.proj", out)
        _optional_conv(sd, model.dp, "dp.cond", out)
        out["emb_g.weight"] = sd.need("emb_g.weight")

    # strict: every parameter the (pruned) module holds is written above
    model.load_state_dict({k: v.contiguous() for k, v in out.items()}, strict=True, assign=True)
    return model.eval(), {"missing": sd.missing, "unexpected": sd.unexpected()}


def load_torch_checkpoint(ckpt_path: str, cfg: SynthesizerConfig) -> tuple[Synthesizer, dict]:
    """A reference ``.pth`` (``torch.load`` → ``checkpoint['model']``, or a
    bare state dict) → `import_synthesizer`.  Read with
    ``weights_only=False``, as the JAX package reads it; entries that are
    not tensors are skipped."""
    checkpoint = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = checkpoint["model"] if "model" in checkpoint else checkpoint
    return import_synthesizer({k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}, cfg)
