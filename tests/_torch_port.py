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


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def lengths_mask(lengths, t_max: int) -> np.ndarray:
    """[B] lengths → float32 [B, T, 1] frame mask."""
    return (np.arange(t_max)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
