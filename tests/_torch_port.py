"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Every comparison feeds the same numpy inputs, made from a seed, to the JAX
function and to its counterpart in ``openvoice_tpu_torch``; weights are JAX
``init_synthesizer`` draws sent through the port's weight bridge.
"""

from __future__ import annotations

import numpy as np
import torch

from tests._regen_golden import _CONVERT_CFG, _TTS_CFG

# the suite runs on several xdist workers at once, beside timing-sensitive
# multi-process tests: keep each worker's torch to a couple of cores
torch.set_num_threads(2)

# the port's audio bar against JAX on the CPU, f32 (tests/test_torch_convert.py)
AUDIO_TOL = 5e-4

# the golden's tiny converter (tests/_regen_golden.py)
TINY = dict(_CONVERT_CFG)

# a tiny converter whose decoder upsamples by the hop (64 = 8·8), as the
# shipped V2 config does (256 = 8·8·2·2): API-level runs produce audio at
# the input's length, long enough to carry a watermark
TINY_API = dict(
    n_speakers=0, zero_g=True,
    spec_channels=129, filter_length=256, hop_length=64, win_length=256,
    inter_channels=64, hidden_channels=64,
    upsample_initial_channel=64, upsample_rates=(8, 8),
    upsample_kernel_sizes=(16, 16),
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    gin_channels=64,
)

# a tiny converter whose decoder takes every route of the serving mode, by
# the JAX package's stage plan: stage 0 (256 → 128 channels, ×4) is a stock
# transposed convolution and the MRF kernel, stage 1 (128 → 64, ×2) the tail
# kernel as a middle stage, stage 2 (64 → 32, ×2) the tail kernel with
# conv_post and tanh
TINY_TAIL = dict(
    n_speakers=0, zero_g=True,
    spec_channels=65, filter_length=128, hop_length=16, win_length=128,
    inter_channels=32, hidden_channels=32,
    upsample_initial_channel=256, upsample_rates=(4, 2, 2),
    upsample_kernel_sizes=(8, 4, 4),
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)),
    gin_channels=32, enc_q_layers=4, flow_wn_layers=2,
)

# the same converter at widths the kernels' stage plan leaves partly on stock
# layers: stage 0 (384 → 192 channels) takes the MRF kernel, stages 1 and 2
# (96 and 48 channels, which tile no 128 lanes) and conv_post stay stock, so
# the serving branch must carry its mask up to audio rate
TINY_STOCK = dict(TINY_TAIL, upsample_initial_channel=384)


# the V1 converter: the same tiny converter with zero_g=False, so the posterior
# encoder and the decoder see the real speaker embeddings
TINY_V1 = dict(TINY_API, zero_g=False)
TINY_TAIL_V1 = dict(TINY_TAIL, zero_g=False)

# the golden's tiny base-speaker TTS (tests/_regen_golden.py)
TINY_TTS = dict(_TTS_CFG)

# a tiny TTS whose decoder takes every route of the serving mode, as
# TINY_TAIL's does, with a token table as large as the text front end's
# symbol set
TINY_TTS_TAIL = dict(
    TINY_TAIL, n_vocab=68, n_speakers=4, zero_g=False,
    filter_channels=64, n_heads=2, n_layers=2, enc_q_layers=2,
)


def jax_cfg(fields: dict):
    from openvoice_tpu.config import SynthesizerConfig

    return SynthesizerConfig(**fields)


def torch_cfg(fields: dict):
    from openvoice_tpu_torch.config import SynthesizerConfig

    return SynthesizerConfig(**fields)


def jax_params(fields: dict, seed: int, random_post: bool = True) -> dict:
    """JAX init_synthesizer weights as a numpy pytree.  JAX zero-initialises
    each coupling's `post` conv, which makes the flow the identity; with
    random_post the flow is exercised by seeded non-zero `post` weights."""
    import jax

    from openvoice_tpu.models.synthesizer import init_synthesizer

    params = jax.tree.map(np.asarray, init_synthesizer(jax.random.PRNGKey(seed), jax_cfg(fields)))
    if random_post:
        rng = np.random.default_rng(seed + 1)
        for layer in params["flow"]["layers"]:
            w = layer["post"]["w"]
            s = 1.0 / np.sqrt(w.shape[0] * w.shape[1])
            layer["post"]["w"] = rng.uniform(-s, s, w.shape).astype(np.float32)
            layer["post"]["b"] = rng.uniform(-s, s, w.shape[2]).astype(np.float32)
    return params


def torch_model(fields: dict, params: dict):
    from openvoice_tpu_torch.ckpt.from_jax import synthesizer_from_jax

    return synthesizer_from_jax(params, torch_cfg(fields)).eval()


# the data section of a reference-format config.json (the rest is the model's)
REFERENCE_DATA_KEYS = ("filter_length", "hop_length", "win_length", "n_speakers")


def write_reference_checkpoint(root, fields: dict, seed: int, random_post: bool = False,
                               **config_extra) -> tuple[str, str]:
    """`fields` as the reference ships a checkpoint: ``root/config.json`` (data
    and model sections, plus `config_extra` at the top level, e.g. a TTS's
    symbols and speakers) and ``root/ckpt.pth`` of seeded port weights (with
    random_post, each coupling's zero-initialised ``post`` conv drawn too), the
    decoder's conv_post scaled ×100, so that the audio stands well above the
    int16 step, the upsamples weight-normed as the reference stores them, and
    a numpy learning rate beside them.  Returns (config path, ckpt path)."""
    import json

    from openvoice_tpu_torch.models.synthesizer import init_synthesizer

    model = {k: (list(v) if isinstance(v, tuple) else v) for k, v in fields.items()
             if k not in REFERENCE_DATA_KEYS}
    model["resblock_dilation_sizes"] = [list(d) for d in fields["resblock_dilation_sizes"]]
    data = {"sampling_rate": 22050, **{k: fields[k] for k in REFERENCE_DATA_KEYS}}
    config = {"_version_": "v2" if fields["zero_g"] else "v1", "data": data, "model": model}
    for key, value in config_extra.items():
        if key == "data":
            data.update(value)
        else:
            config[key] = value
    (root / "config.json").write_text(json.dumps(config))
    gen = torch.Generator().manual_seed(seed)
    sd = init_synthesizer(torch_cfg(fields), gen).state_dict()
    if random_post:
        for key in [k for k in sd if ".post." in k and k.startswith("flow.")]:
            sd[key] = (torch.rand(sd[key].shape, generator=gen) - 0.5) * 0.2
    sd["dec.conv_post.weight"] = sd["dec.conv_post.weight"] * 100.0
    for key in [k for k in sd if k.startswith("dec.ups.") and k.endswith(".weight")]:
        w = sd.pop(key)
        sd[key[:-len("weight")] + "weight_g"] = torch.sqrt(torch.sum(w * w, dim=(1, 2), keepdim=True))
        sd[key[:-len("weight")] + "weight_v"] = w
    torch.save({"model": sd, "iteration": 3, "learning_rate": np.float64(2e-4)}, root / "ckpt.pth")
    return str(root / "config.json"), str(root / "ckpt.pth")


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def lengths_mask(lengths, t_max: int) -> np.ndarray:
    """[B] lengths → float32 [B, T, 1] frame mask."""
    return (np.arange(t_max)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def jax_elastic_truth(params: dict, req: dict) -> np.ndarray:
    """The JAX package's single-device convert of one elastic-tier request
    (tests/_elastic_child.py's tiny converter), with the distributed
    service's noise: ``default_rng(seed)`` over the live frames, in the
    request's own bucket."""
    import jax.numpy as jnp

    from openvoice_tpu.models import synthesizer as S
    from openvoice_tpu.runtime.bucketing import round_up_to_bucket
    from tests._elastic_child import TINY as cfg

    nf = int(req["n_frames"])
    bucket = round_up_to_bucket(nf)
    spec = np.zeros((1, bucket, cfg.spec_channels), np.float32)
    spec[0, :nf] = req["spec"]
    noise = np.zeros((1, bucket, cfg.inter_channels), np.float32)
    noise[0, :nf] = np.random.default_rng(int(req["seed"])).standard_normal((nf, cfg.inter_channels))
    audio, _ = S.voice_conversion_jit(
        params, cfg, jnp.asarray(spec), jnp.asarray([nf]), jnp.asarray(req["g_src"])[None, None],
        jnp.asarray(req["g_tgt"])[None, None], jnp.full((1, 1, 1), float(req["tau"]), np.float32),
        jnp.asarray(noise))
    return np.asarray(audio)[0, : nf * cfg.upsample_factor, 0]
