"""Weights for the port's `Synthesizer`.

* `synthesizer_from_jax`: a JAX parameter pytree (nested dicts and lists of
  arrays, as ``openvoice_tpu`` builds or imports them) → a `Synthesizer`.
  It inverts the layouts of ``openvoice_tpu/ckpt/torch_import.py``:
  conv [K, C_in, C_out] → [C_out, C_in, K]; transposed conv, stored there
  with the kernel axis flipped → [C_in, C_out, K] unflipped; conv2d HWIO →
  [C_out, C_in, KH, KW]; linear [in, out] → [out, in] (as a 1×1 conv
  [out, in, 1] for the attention projections); GRU ``w_ih`` [in, 3H] and
  ``w_hh`` [H, 3H] (gate order r, z, n in both) → transposed; relative
  embeddings [2w+1, dk] → [1, 2w+1, dk]; the duration flows' affine
  ``m``/``logs`` [C] → [C, 1].
* `dec_cache_from_jax`: the same pytree → the model and its packed serving
  cache, so that a test starts both packages from the same arrays.
* `load_ckpt`: a reference-format ``.pth`` checkpoint → a state dict with
  weight norm folded into plain weights, ready for ``load_state_dict``.
* `synthesizer_to_jax`: a converter `Synthesizer` → the JAX pytree, the
  inverse of `synthesizer_from_jax` (what ``ckpt/native_io.py::save_npz``
  writes for the JAX package to read).
* `extras_from_jax`: the pytree of one of the JAX package's auxiliary
  blocks (``nn/extras.py``) → the port's module of it.
* `discriminators_from_jax`: the JAX discriminators' pytree
  (``training/discriminator.py::init_discriminators``) → the port's
  `Discriminators`: conv2d HWIO (5, 1, C_in, C_out) → [C_out, C_in, 5, 1],
  grouped conv1d (K, C_in/groups, C_out) → [C_out, C_in/groups, K].

The pytrees cross as ``.npz`` files through ``ckpt/native_io.py``
(`load_npz` / `save_npz`).  Only numpy arrays cross the boundary: nothing here imports JAX.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Mapping

import numpy as np
import torch

from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.models.synthesizer import Synthesizer, make_dec_cache
from openvoice_tpu_torch.nn.extras import ConvReluNorm, Decoder, TransformerCouplingLayer

if TYPE_CHECKING:
    from openvoice_tpu_torch.training.discriminator import Discriminators


def _conv(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = np.transpose(np.asarray(p["w"]), (2, 1, 0))
    if p.get("b") is not None:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _conv_transpose(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    w = np.asarray(p["w"])[::-1]  # undo the import-time kernel flip
    sd[f"{prefix}.weight"] = np.transpose(w, (1, 2, 0))
    sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _wn(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    for i, lp in enumerate(p["in"]):
        _conv(lp, f"{prefix}.in_layers.{i}", sd)
    for i, lp in enumerate(p["res_skip"]):
        _conv(lp, f"{prefix}.res_skip_layers.{i}", sd)
    if p.get("cond") is not None:
        _conv(p["cond"], f"{prefix}.cond_layer", sd)


def _ln(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    sd[f"{prefix}.gamma"] = np.asarray(p["gamma"])
    sd[f"{prefix}.beta"] = np.asarray(p["beta"])


def _linear_1x1(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["w"]).T[:, :, None]
    sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _ddsconv(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    for i, lp in enumerate(p["layers"]):
        _conv(lp["sep"], f"{prefix}.convs_sep.{i}", sd)
        _conv(lp["pw"], f"{prefix}.convs_1x1.{i}", sd)
        _ln(lp["norm1"], f"{prefix}.norms_1.{i}", sd)
        _ln(lp["norm2"], f"{prefix}.norms_2.{i}", sd)


def _sdp_flows(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    """[EA, CF, Flip, CF, Flip, ...]: the conv flows sit at the odd slots."""
    sd[f"{prefix}.0.m"] = np.asarray(p["ea"]["m"])[:, None]
    sd[f"{prefix}.0.logs"] = np.asarray(p["ea"]["logs"])[:, None]
    for i, cf in enumerate(p["conv_flows"]):
        _conv(cf["pre"], f"{prefix}.{2 * i + 1}.pre", sd)
        _ddsconv(cf["dds"], f"{prefix}.{2 * i + 1}.convs", sd)
        _conv(cf["proj"], f"{prefix}.{2 * i + 1}.proj", sd)


def _attn_encoder(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    for i, lp in enumerate(p["layers"]):
        attn = f"{prefix}.attn_layers.{i}"
        for name in ("q", "k", "v", "o"):
            _linear_1x1(lp["attn"][name], f"{attn}.conv_{name}", sd)
        sd[f"{attn}.emb_rel_k"] = np.asarray(lp["attn"]["emb_rel_k"])[None]
        sd[f"{attn}.emb_rel_v"] = np.asarray(lp["attn"]["emb_rel_v"])[None]
        _ln(lp["norm1"], f"{prefix}.norm_layers_1.{i}", sd)
        _conv(lp["ffn"]["conv1"], f"{prefix}.ffn_layers.{i}.conv_1", sd)
        _conv(lp["ffn"]["conv2"], f"{prefix}.ffn_layers.{i}.conv_2", sd)
        _ln(lp["norm2"], f"{prefix}.norm_layers_2.{i}", sd)


def _sdp(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    for name in ("pre", "proj", "post_pre", "post_proj"):
        _conv(p[name], f"{prefix}.{name}", sd)
    _ddsconv(p["convs"], f"{prefix}.convs", sd)
    _ddsconv(p["post_convs"], f"{prefix}.post_convs", sd)
    _sdp_flows(p["flows"], f"{prefix}.flows", sd)
    _sdp_flows(p["post_flows"], f"{prefix}.post_flows", sd)
    if p.get("cond") is not None:
        _conv(p["cond"], f"{prefix}.cond", sd)


def _dp(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    _conv(p["conv1"], f"{prefix}.conv_1", sd)
    _ln(p["norm1"], f"{prefix}.norm_1", sd)
    _conv(p["conv2"], f"{prefix}.conv_2", sd)
    _ln(p["norm2"], f"{prefix}.norm_2", sd)
    _conv(p["proj"], f"{prefix}.proj", sd)
    if p.get("cond") is not None:
        _conv(p["cond"], f"{prefix}.cond", sd)


def _text_path(params: Mapping[str, Any], sd: dict) -> None:
    """enc_p, sdp, dp and emb_g of a base-speaker TTS pytree."""
    enc = params["enc_p"]
    sd["enc_p.emb.weight"] = np.asarray(enc["emb"])
    _attn_encoder(enc["encoder"], "enc_p.encoder", sd)
    _conv(enc["proj"], "enc_p.proj", sd)
    _sdp(params["sdp"], "sdp", sd)
    _dp(params["dp"], "dp", sd)
    sd["emb_g.weight"] = np.asarray(params["emb_g"])


def jax_state_dict(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """The reference-named state dict of a JAX pytree: a converter's (with
    ``ref_enc``) or a base-speaker TTS's (with ``enc_p``, ``sdp``, ``dp``,
    ``emb_g``)."""
    sd: dict[str, np.ndarray] = {}
    enc_q = params["enc_q"]
    _conv(enc_q["pre"], "enc_q.pre", sd)
    _wn(enc_q["wn"], "enc_q.enc", sd)
    _conv(enc_q["proj"], "enc_q.proj", sd)
    for i, lp in enumerate(params["flow"]["layers"]):
        prefix = f"flow.flows.{2 * i}"  # odd slots are the parameter-free flips
        _conv(lp["pre"], f"{prefix}.pre", sd)
        _wn(lp["wn"], f"{prefix}.enc", sd)
        _conv(lp["post"], f"{prefix}.post", sd)
    dec = params["dec"]
    _conv(dec["conv_pre"], "dec.conv_pre", sd)
    for i, up in enumerate(dec["ups"]):
        _conv_transpose(up, f"dec.ups.{i}", sd)
    for n, rb in enumerate(dec["resblocks"]):
        for name in ("convs1", "convs2", "convs"):
            for j, c in enumerate(rb.get(name, [])):
                _conv(c, f"dec.resblocks.{n}.{name}.{j}", sd)
    _conv(dec["conv_post"], "dec.conv_post", sd)
    if dec.get("cond") is not None:
        _conv(dec["cond"], "dec.cond", sd)
    if "enc_p" in params:
        _text_path(params, sd)
        return sd
    ref = params["ref_enc"]
    if ref.get("layernorm") is not None:
        sd["ref_enc.layernorm.weight"] = np.asarray(ref["layernorm"]["gamma"])
        sd["ref_enc.layernorm.bias"] = np.asarray(ref["layernorm"]["beta"])
    for i, c in enumerate(ref["convs"]):
        sd[f"ref_enc.convs.{i}.weight"] = np.transpose(np.asarray(c["w"]), (3, 2, 0, 1))
        sd[f"ref_enc.convs.{i}.bias"] = np.asarray(c["b"])
    gru = ref["gru"]
    sd["ref_enc.gru.weight_ih_l0"] = np.asarray(gru["w_ih"]).T
    sd["ref_enc.gru.weight_hh_l0"] = np.asarray(gru["w_hh"]).T
    sd["ref_enc.gru.bias_ih_l0"] = np.asarray(gru["b_ih"])
    sd["ref_enc.gru.bias_hh_l0"] = np.asarray(gru["b_hh"])
    sd["ref_enc.proj.weight"] = np.asarray(ref["proj"]["w"]).T
    sd["ref_enc.proj.bias"] = np.asarray(ref["proj"]["b"])
    return sd


def synthesizer_from_jax(params: Mapping[str, Any], cfg: SynthesizerConfig) -> Synthesizer:
    """A CPU `Synthesizer` holding the JAX pytree's weights (strict: every
    parameter of the module must be in the pytree and vice versa)."""
    model = Synthesizer(cfg)
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in jax_state_dict(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def dec_cache_from_jax(params: Mapping[str, Any], cfg: SynthesizerConfig,
                       dtype: torch.dtype = torch.bfloat16) -> tuple[Synthesizer, dict]:
    """What the JAX ``make_dec_cache(params, cfg, dtype)`` is given, as the
    port's model (`synthesizer_from_jax`) and the port's own packing of it."""
    model = synthesizer_from_jax(params, cfg).eval()
    return model, make_dec_cache(model, dtype)


def _np(sd: Mapping[str, torch.Tensor], key: str) -> np.ndarray:
    return sd[key].detach().cpu().numpy()


def _conv_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> dict:
    p = {"w": np.ascontiguousarray(np.transpose(_np(sd, f"{prefix}.weight"), (2, 1, 0)))}
    if f"{prefix}.bias" in sd:
        p["b"] = _np(sd, f"{prefix}.bias")
    return p


def _conv_transpose_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> dict:
    w = np.transpose(_np(sd, f"{prefix}.weight"), (2, 0, 1))[::-1]  # the import-time kernel flip
    return {"w": np.ascontiguousarray(w), "b": _np(sd, f"{prefix}.bias")}


def _wn_to_jax(sd: Mapping[str, torch.Tensor], wn, prefix: str) -> dict:
    p = {"in": [_conv_to_jax(sd, f"{prefix}.in_layers.{i}") for i in range(len(wn.in_layers))],
         "res_skip": [_conv_to_jax(sd, f"{prefix}.res_skip_layers.{i}") for i in range(len(wn.res_skip_layers))]}
    if wn.cond_layer is not None:
        p["cond"] = _conv_to_jax(sd, f"{prefix}.cond_layer")
    return p


def synthesizer_to_jax(model: Synthesizer) -> dict:
    """A converter (n_speakers == 0) → the JAX package's parameter pytree of
    numpy arrays: the inverse of `synthesizer_from_jax`, exact."""
    if model.cfg.n_speakers != 0:
        raise ValueError("synthesizer_to_jax takes a converter (n_speakers == 0)")
    sd = model.state_dict()
    dec = model.dec
    resblocks = []
    for n, rb in enumerate(dec.resblocks):
        names = ("convs1", "convs2") if hasattr(rb, "convs1") else ("convs",)
        resblocks.append({name: [_conv_to_jax(sd, f"dec.resblocks.{n}.{name}.{j}")
                                 for j in range(len(getattr(rb, name)))] for name in names})
    dec_p = {"conv_pre": _conv_to_jax(sd, "dec.conv_pre"),
             "ups": [_conv_transpose_to_jax(sd, f"dec.ups.{i}") for i in range(len(dec.ups))],
             "resblocks": resblocks,
             "conv_post": _conv_to_jax(sd, "dec.conv_post")}
    if dec.cond is not None:
        dec_p["cond"] = _conv_to_jax(sd, "dec.cond")
    flows = model.flow.flows[::2]  # odd slots are the parameter-free flips
    ref = model.ref_enc
    return {
        "enc_q": {"pre": _conv_to_jax(sd, "enc_q.pre"), "wn": _wn_to_jax(sd, model.enc_q.enc, "enc_q.enc"),
                  "proj": _conv_to_jax(sd, "enc_q.proj")},
        "flow": {"layers": [{"pre": _conv_to_jax(sd, f"flow.flows.{2 * i}.pre"),
                             "wn": _wn_to_jax(sd, layer.enc, f"flow.flows.{2 * i}.enc"),
                             "post": _conv_to_jax(sd, f"flow.flows.{2 * i}.post")}
                            for i, layer in enumerate(flows)]},
        "dec": dec_p,
        "ref_enc": {
            "layernorm": {"gamma": _np(sd, "ref_enc.layernorm.weight"), "beta": _np(sd, "ref_enc.layernorm.bias")},
            "convs": [{"w": np.ascontiguousarray(np.transpose(_np(sd, f"ref_enc.convs.{i}.weight"), (2, 3, 1, 0))),
                       "b": _np(sd, f"ref_enc.convs.{i}.bias")} for i in range(len(ref.convs))],
            "gru": {"w_ih": np.ascontiguousarray(_np(sd, "ref_enc.gru.weight_ih_l0").T),
                    "w_hh": np.ascontiguousarray(_np(sd, "ref_enc.gru.weight_hh_l0").T),
                    "b_ih": _np(sd, "ref_enc.gru.bias_ih_l0"), "b_hh": _np(sd, "ref_enc.gru.bias_hh_l0")},
            "proj": {"w": np.ascontiguousarray(_np(sd, "ref_enc.proj.weight").T), "b": _np(sd, "ref_enc.proj.bias")},
        },
    }


def extras_from_jax(module, params: Mapping[str, Any]):
    """Load the JAX package's parameter pytree of an ``nn/extras.py`` block
    (``init_conv_relu_norm``, ``init_transformer_coupling_layer``,
    ``init_decoder``) into the port's module of the same shapes, strictly;
    returns the module.  Layouts as in `synthesizer_from_jax`; the decoder's
    attention projections are 1×1 convs, the coupling's speaker projection
    ``spk_emb`` is the reference's ``enc.spk_emb_linear`` (an nn.Linear)."""
    sd: dict[str, np.ndarray] = {}
    if isinstance(module, ConvReluNorm):
        for i, (c, n) in enumerate(zip(params["convs"], params["norms"])):
            _conv(c, f"conv_layers.{i}", sd)
            _ln(n, f"norm_layers.{i}", sd)
        _conv(params["proj"], "proj", sd)
    elif isinstance(module, TransformerCouplingLayer):
        _conv(params["pre"], "pre", sd)
        _attn_encoder(params["enc"], "enc", sd)
        if params["enc"].get("spk_emb") is not None:
            sd["enc.spk_emb_linear.weight"] = np.asarray(params["enc"]["spk_emb"]["w"]).T
            sd["enc.spk_emb_linear.bias"] = np.asarray(params["enc"]["spk_emb"]["b"])
        _conv(params["post"], "post", sd)
    elif isinstance(module, Decoder):
        for i, lp in enumerate(params["layers"]):
            for attn, prefix in (("self_attn", "self_attn_layers"), ("cross_attn", "encdec_attn_layers")):
                for name in ("q", "k", "v", "o"):
                    _linear_1x1(lp[attn][name], f"{prefix}.{i}.conv_{name}", sd)
            for n in range(3):
                _ln(lp[f"norm{n}"], f"norm_layers_{n}.{i}", sd)
            _conv(lp["ffn"]["conv1"], f"ffn_layers.{i}.conv_1", sd)
            _conv(lp["ffn"]["conv2"], f"ffn_layers.{i}.conv_2", sd)
    else:
        raise TypeError(f"no JAX bridge for {type(module).__name__}")
    module.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}, strict=True)
    return module


def discriminators_from_jax(d_params: Mapping[str, Any]) -> Discriminators:
    """The JAX discriminators' pytree (``{"scale": {"convs", "post"},
    "periods": [{"convs", "post"}, ...]}``) → a CPU `Discriminators` (strict).
    The training layer is imported here, so that loading a converter's
    weights does not load it."""
    from openvoice_tpu_torch.training.discriminator import Discriminators

    def conv2d_hwio(c: Mapping[str, Any], prefix: str) -> None:
        sd[f"{prefix}.weight"] = np.transpose(np.asarray(c["w"]), (3, 2, 0, 1))
        sd[f"{prefix}.bias"] = np.asarray(c["b"])

    sd: dict[str, np.ndarray] = {}
    for i, c in enumerate(d_params["scale"]["convs"]):
        _conv(c, f"scale.convs.{i}", sd)  # (K, C_in/groups, C_out) → [C_out, C_in/groups, K]
    _conv(d_params["scale"]["post"], "scale.post", sd)
    for n, per in enumerate(d_params["periods"]):
        for i, c in enumerate(per["convs"]):
            conv2d_hwio(c, f"periods.{n}.convs.{i}")
        conv2d_hwio(per["post"], f"periods.{n}.post")
    disc = Discriminators()
    disc.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}, strict=True)
    return disc
