"""The port's weights: the JAX → PyTorch bridge inverts every layout of the
JAX package's checkpoint importer, reference `.pth` files load with weight
norm folded, and the port's random init has the JAX init's distributions."""

import jax
import numpy as np
import pytest
import torch

from openvoice_tpu.ckpt.torch_import import import_synthesizer
from openvoice_tpu_torch.api import ToneColorConverter
from openvoice_tpu_torch.models.synthesizer import init_synthesizer
from tests._torch_port import TINY, jax_cfg, jax_params, torch_cfg, torch_model


def test_bridge_state_dict_reimports_to_the_same_jax_params():
    """JAX params → bridge → port state_dict() (reference-named) → the JAX
    importer gives back equal arrays: conv, flipped transposed conv, conv2d,
    linear and GRU layouts all invert exactly."""
    params = jax_params(TINY, seed=3)
    sd = {k: v.numpy() for k, v in torch_model(TINY, params).state_dict().items()}
    back, report = import_synthesizer(sd, jax_cfg(TINY))
    assert report == {"missing": [], "unexpected": []}
    leaves = jax.tree_util.tree_leaves_with_path(params)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves) == len(back_leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(back_leaves[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("style", ["weight_g", "parametrizations"])
def test_load_ckpt_folds_weight_norm(tmp_path, style):
    """A reference-format checkpoint stores weight-normed convs as (g, v);
    load_ckpt folds them back to the plain weights."""
    cfg = torch_cfg(TINY)
    ref = init_synthesizer(cfg, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    sd = {}
    for key, value in ref.state_dict().items():
        # weight-normed convs (a zero weight, as in each flow's post, has none;
        # the decoder's conditioning conv is a plain conv in the reference, and
        # the importer takes it only as a plain weight, as the JAX one does)
        if key.endswith(".weight") and value.dim() == 3 and value.any() and not key.startswith("dec.cond."):
            v = value * (1.0 + torch.rand(value.shape[0], 1, 1, generator=gen))
            g = torch.sqrt(torch.sum(value * value, dim=(1, 2), keepdim=True))
            prefix = key[: -len(".weight")]
            if style == "weight_g":
                sd[prefix + ".weight_g"], sd[prefix + ".weight_v"] = g, v
            else:
                sd[prefix + ".parametrizations.weight.original0"] = g
                sd[prefix + ".parametrizations.weight.original1"] = v
        else:
            sd[key] = value
    path = tmp_path / "checkpoint.pth"
    torch.save({"model": sd, "iteration": 7}, path)
    tc = ToneColorConverter(cfg=cfg, device="cpu")
    report = tc.load_ckpt(str(path))
    assert report == {"missing": [], "unexpected": []}
    for key, value in ref.state_dict().items():
        torch.testing.assert_close(tc.model.state_dict()[key], value, rtol=1e-6, atol=1e-7)


def test_init_synthesizer_distributions_and_seed():
    cfg = torch_cfg(TINY)
    a = init_synthesizer(cfg, torch.Generator().manual_seed(0)).state_dict()
    b = init_synthesizer(cfg, torch.Generator().manual_seed(0)).state_dict()
    c = init_synthesizer(cfg, torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["enc_q.pre.weight"], c["enc_q.pre.weight"])
    # each coupling's post is zero: a fresh flow is the identity
    for i in (0, 2, 4, 6):
        assert not a[f"flow.flows.{i}.post.weight"].any()
        assert not a[f"flow.flows.{i}.post.bias"].any()
    # decoder upsamples and resblocks: normal(0, 0.01), zero bias
    ups = a["dec.ups.0.weight"]
    assert 0.005 < float(ups.std()) < 0.015 and not a["dec.ups.0.bias"].any()
    assert not a["dec.resblocks.0.convs1.0.bias"].any()
    # convs and linears: uniform within ±1/sqrt(fan_in), weight and bias
    w = a["enc_q.pre.weight"]
    bound = 1.0 / np.sqrt(w.shape[1] * w.shape[2])
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert float(a["enc_q.pre.bias"].abs().max()) <= bound
    assert torch.equal(a["ref_enc.layernorm.weight"], torch.ones(cfg.spec_channels))
    assert float(a["ref_enc.gru.weight_hh_l0"].abs().max()) <= 1.0 / np.sqrt(128)
