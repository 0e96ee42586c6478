"""The port's reference-checkpoint importer (``ckpt/torch_import.py``)
against the JAX package's (``openvoice_tpu/ckpt/torch_import.py``) on the
same ``.pth`` files: a missing bias is zeros, a missing conv weight raises,
a file with non-tensor entries loads, the missing/unexpected report is
JAX's, key for key, and ``convert_torch_checkpoint`` writes a directory that
loads back to the same weights."""

import jax
import numpy as np
import pytest
import torch

from openvoice_tpu.ckpt.torch_import import load_torch_checkpoint as jax_load
from openvoice_tpu_torch.api import ToneColorConverter
from openvoice_tpu_torch.ckpt import native_io as CIO
from openvoice_tpu_torch.ckpt.from_jax import jax_state_dict
from openvoice_tpu_torch.ckpt.torch_import import load_params_npz, load_torch_checkpoint
from openvoice_tpu_torch.models.synthesizer import Synthesizer
from tests._torch_port import TINY, TINY_TTS, jax_cfg, jax_params, torch_cfg, torch_model


@pytest.fixture(scope="module")
def ref_sd():
    """A reference-named state dict of JAX-initialised weights."""
    return {k: v.clone() for k, v in torch_model(TINY, jax_params(TINY, seed=11)).state_dict().items()}


def _save(tmp_path, sd, name="ckpt.pth", **extra) -> str:
    path = str(tmp_path / name)
    torch.save({"model": sd, **extra}, path)
    return path


def _weight_normed(sd: dict, style: str) -> dict:
    """The convs the reference weight-norms (the WaveNets, the decoder's
    upsamples and resblocks) as weight-norm pairs of `style`."""
    gen = torch.Generator().manual_seed(3)
    out = {}
    for key, value in sd.items():
        normed = ".enc." in key or key.startswith(("dec.ups.", "dec.resblocks."))
        if normed and key.endswith(".weight") and value.any():
            v = value * (1.0 + torch.rand(value.shape[0], 1, 1, generator=gen))
            g = torch.sqrt(torch.sum(value * value, dim=(1, 2), keepdim=True))
            prefix = key[: -len(".weight")]
            names = (("weight_g", "weight_v") if style == "weight_g"
                     else ("parametrizations.weight.original0", "parametrizations.weight.original1"))
            out[f"{prefix}.{names[0]}"], out[f"{prefix}.{names[1]}"] = g, v
        else:
            out[key] = value
    return out


def _assert_same_weights(model, jax_params_tree, atol=0.0):
    ref = jax_state_dict(jax.tree.map(np.asarray, jax_params_tree))
    got = model.state_dict()
    assert set(got) == set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(got[key].numpy(), value, rtol=1e-6 if atol else 0, atol=atol, err_msg=key)


def test_missing_bias_is_zeros_as_in_jax(tmp_path, ref_sd):
    """Both packages fill a missing bias with zeros; the port used to keep an
    unseeded random draw."""
    sd = dict(ref_sd)
    for key in ("dec.ups.0.bias", "enc_q.pre.bias", "flow.flows.2.enc.in_layers.1.bias"):
        del sd[key]
    path = _save(tmp_path, sd)
    params, jax_report = jax_load(path, jax_cfg(TINY))
    tc = ToneColorConverter(cfg=torch_cfg(TINY), device="cpu")
    report = tc.load_ckpt(path)
    assert report == jax_report
    assert report["missing"] == ["enc_q.pre.bias", "flow.flows.2.enc.in_layers.1.bias", "dec.ups.0.bias"]
    assert not tc.model.dec.ups[0].bias.any() and not tc.model.enc_q.pre.bias.any()
    _assert_same_weights(tc.model, params)


def test_missing_conv_weight_raises_as_in_jax(tmp_path, ref_sd):
    sd = {k: v for k, v in ref_sd.items() if k != "dec.conv_pre.weight"}
    path = _save(tmp_path, sd)
    with pytest.raises(KeyError, match="missing conv weight for dec.conv_pre"):
        jax_load(path, jax_cfg(TINY))
    with pytest.raises(KeyError, match="missing conv weight for dec.conv_pre"):
        ToneColorConverter(cfg=torch_cfg(TINY), device="cpu").load_ckpt(path)


def test_non_tensor_entries_load(tmp_path, ref_sd):
    """A training script's checkpoint carries an iteration count and a numpy
    learning rate beside the weights: both packages read it."""
    path = _save(tmp_path, dict(ref_sd), iteration=7, learning_rate=np.float64(2e-4))
    params, jax_report = jax_load(path, jax_cfg(TINY))
    tc = ToneColorConverter(cfg=torch_cfg(TINY), device="cpu")
    assert tc.load_ckpt(path) == jax_report == {"missing": [], "unexpected": []}
    _assert_same_weights(tc.model, params)


@pytest.mark.parametrize("case", ["weight_g", "parametrizations", "unexpected", "no_conditioning"])
def test_report_and_weights_equal_jax(tmp_path, ref_sd, case):
    """Weight norm in both styles (folded within f32 rounding of JAX's fold),
    an unexpected key, and optional layers the file lacks (the decoder's and
    the first coupling's conditioning), which both packages take out."""
    sd = dict(ref_sd)
    if case in ("weight_g", "parametrizations"):
        sd = _weight_normed(sd, case)
    elif case == "unexpected":
        sd["enc_q.extra.weight"] = torch.zeros(3)
        sd["dec.resblocks.0.convs1.0.bias"] = sd.pop("dec.resblocks.0.convs1.0.bias")
    else:
        for key in ("dec.cond.weight", "dec.cond.bias", "flow.flows.0.enc.cond_layer.weight"):
            del sd[key]
    path = _save(tmp_path, sd)
    params, jax_report = jax_load(path, jax_cfg(TINY))
    model, report = load_torch_checkpoint(path, torch_cfg(TINY))
    assert report == jax_report
    if case == "unexpected":
        assert report["unexpected"] == ["enc_q.extra.weight"]
    if case == "no_conditioning":
        assert report["unexpected"] == ["flow.flows.0.enc.cond_layer.bias"]
        assert params["dec"]["cond"] is None and model.dec.cond is None
        assert params["flow"]["layers"][0]["wn"]["cond"] is None and model.flow.flows[0].enc.cond_layer is None
        _convert_without_conditioning(model, params)
        return
    _assert_same_weights(model, params, atol=1e-7 if case in ("weight_g", "parametrizations") else 0.0)


def _convert_without_conditioning(model, params) -> None:
    """The pruned model converts as JAX's pytree with those layers None
    does (f32), and its serving route (the packed cache, the plain versions
    here) takes the missing conditioning as zeros."""
    from openvoice_tpu.models import synthesizer as JS
    from openvoice_tpu_torch.models import synthesizer as S

    rng = np.random.default_rng(8)
    spec = np.abs(rng.standard_normal((1, 32, TINY["spec_channels"]))).astype(np.float32)
    g_src, g_tgt = (rng.standard_normal((1, 1, TINY["gin_channels"])).astype(np.float32) for _ in range(2))
    noise = rng.standard_normal((1, 32, TINY["inter_channels"])).astype(np.float32)
    ref, _ = JS.voice_conversion(params, jax_cfg(TINY), spec, np.asarray([32]), g_src, g_tgt, 0.3, noise)
    args = [torch.from_numpy(a) for a in (spec, np.asarray([32]), g_src, g_tgt)]
    with torch.no_grad():
        got, _ = S.voice_conversion(model, *args, 0.3, torch.from_numpy(noise))
        fast, _ = S.voice_conversion(model, *args, 0.3, torch.from_numpy(noise), fast=True,
                                     dec_cache=S.make_dec_cache(model))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4)
    assert fast.shape == got.shape and torch.isfinite(fast).all()


def test_leaf_without_default_raises_naming_the_key(tmp_path, ref_sd):
    """Where JAX leaves a leaf None (no shape to fill), the port refuses the
    file at load and names the key."""
    sd = {k: v for k, v in ref_sd.items() if k != "ref_enc.gru.weight_hh_l0"}
    with pytest.raises(KeyError, match="ref_enc.gru.weight_hh_l0"):
        load_torch_checkpoint(_save(tmp_path, sd), torch_cfg(TINY))


def test_tts_layer_norm_and_speaker_table_raise(tmp_path):
    sd = torch_model(TINY_TTS, jax_params(TINY_TTS, seed=2)).state_dict()
    for key in ("enc_p.encoder.norm_layers_1.0.gamma", "emb_g.weight", "sdp.flows.0.logs"):
        path = _save(tmp_path, {k: v for k, v in sd.items() if k != key})
        with pytest.raises(KeyError, match=key.replace(".", r"\.")):
            load_torch_checkpoint(path, torch_cfg(TINY_TTS))
    model, report = load_torch_checkpoint(_save(tmp_path, dict(sd)), torch_cfg(TINY_TTS))
    assert report == {"missing": [], "unexpected": []}
    for key, value in sd.items():
        assert torch.equal(model.state_dict()[key], value), key


def test_convert_torch_checkpoint_loads_back(tmp_path, ref_sd):
    """.pth → weight-norm-folded directory → a Synthesizer template: the same
    weights as the importer gives."""
    path = _save(tmp_path, _weight_normed(dict(ref_sd), "weight_g"))
    out = CIO.convert_torch_checkpoint(path, str(tmp_path / "converted"), torch_cfg(TINY))
    model, _ = load_torch_checkpoint(path, torch_cfg(TINY))
    back = CIO.load_checkpoint(out, template=Synthesizer(torch_cfg(TINY)))
    for key, value in model.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key


def test_load_params_npz_reads_the_jax_tree(tmp_path):
    from openvoice_tpu.ckpt.native_io import save_npz

    params = jax_params(TINY, seed=5)
    save_npz(str(tmp_path / "p.npz"), params)
    back = load_params_npz(str(tmp_path / "p.npz"))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves) == len(back_leaves)
    for p, leaf in leaves:
        np.testing.assert_array_equal(back_leaves[p], leaf)
