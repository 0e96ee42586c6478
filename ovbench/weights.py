"""Random weights from the seed, made on the device in a few large draws.

The benchmark makes the weights; the program and the reference each load
the same tensors.  Names and shapes come from the reference's module tree
(`reference.model.Synthesizer`), whose state dict is the checkpoints'; the
program loads them strictly, so a key that differs fails the run.

Distributions (the configuration files list them under ``assumed``):
LayerNorm scales 1 and shifts 0; the token embedding normal with deviation
hidden**-0.5, the relative-position tables dk**-0.5, the speaker table 1;
every other tensor uniform in ±1/√fan_in of its layer (a bias takes its
weight's bound; fan_in is a weight's size over its first axis); the
decoder's ``conv_post`` then times the configuration's ``conv_post_gain``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ovbench.reference.model import Config, Synthesizer


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one consumer of `seed` (a model, a pool)."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _rule(name: str, shape: tuple, cfg: Config, weight_shapes: dict) -> tuple[str, float]:
    """(kind, scale) of one tensor: kind "one", "zero", "normal" or
    "uniform"."""
    if name.endswith(("gamma", "layernorm.weight")):
        return "one", 1.0
    if name.endswith(("beta", "layernorm.bias")):
        return "zero", 0.0
    if name == "emb_g.weight":
        return "normal", 1.0
    if name == "enc_p.emb.weight":
        return "normal", cfg.hidden_channels ** -0.5
    if name.endswith(("emb_rel_k", "emb_rel_v")):
        return "normal", shape[-1] ** -0.5
    ref = shape
    if len(shape) == 1 and name.endswith("bias"):
        ref = weight_shapes.get(name[: -len("bias")] + "weight", shape)
    elif "gru" in name:
        ref = (0, 128)  # the GRU's uniform bound, 1/√hidden
    fan_in = math.prod(ref[1:]) if len(ref) > 1 else ref[0]
    return "uniform", 1.0 / math.sqrt(max(fan_in, 1))


FIXED_SEED = 0x0F1CED  # the seed of the tensors a configuration holds fixed across runs


def make_weights(cfg: Config, seed: int, device: torch.device, conv_post_gain: float = 1.0,
                 fixed: tuple[str, ...] = ()) -> dict:
    """The state dict of a `cfg` synthesizer drawn from `seed` on `device`:
    one uniform and one normal draw from a generator on the device, cut
    into the tensors.  Tensors whose names start with one of `fixed` come
    from `FIXED_SEED` instead, the same in every run."""
    if fixed:
        out = make_weights(cfg, seed, device, conv_post_gain)
        held = make_weights(cfg, FIXED_SEED, device, conv_post_gain)
        return {k: held[k] if k.startswith(tuple(fixed)) else v for k, v in out.items()}
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in Synthesizer(cfg).state_dict().items()}
    rules = {k: _rule(k, s, cfg, shapes) for k, s in shapes.items()}
    gen = torch.Generator(device).manual_seed(seed)
    n_uniform = sum(math.prod(shapes[k]) for k, (kind, _) in rules.items() if kind == "uniform")
    n_normal = sum(math.prod(shapes[k]) for k, (kind, _) in rules.items() if kind == "normal")
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(n_normal, generator=gen, device=device)
    out, at = {}, {"uniform": 0, "normal": 0}
    for name in sorted(shapes):
        kind, scale = rules[name]
        shape, n = shapes[name], math.prod(shapes[name])
        if kind in at:
            src = uniform if kind == "uniform" else normal
            out[name] = (src[at[kind] : at[kind] + n] * scale).reshape(shape)
            at[kind] += n
        else:
            out[name] = torch.full(shape, scale, device=device)
    out["dec.conv_post.weight"] = out["dec.conv_post.weight"] * conv_post_gain
    return out


def reference_model(cfg: Config, weights: dict) -> Synthesizer:
    """The reference's module tree on the weights' device, in eval mode."""
    device = next(iter(weights.values())).device
    with torch.device(device):
        model = Synthesizer(cfg)
    model.load_state_dict(weights, strict=True)
    return model.eval()
