"""Shared pieces of the training parity tests (tests/test_torch_training*.py):
the JAX suite's tiny training config and batch (tests/test_training.py), JAX's
draws of noise and slice starts, JAX weights, and the gradient bar."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from openvoice_tpu.training import discriminator as JD
from openvoice_tpu_torch.ckpt.from_jax import jax_state_dict
from tests._torch_port import jax_cfg, jax_params, torch_cfg

# the JAX suite's training config (tests/test_training.py)
TINY_TRAIN = dict(
    n_speakers=0, zero_g=True,
    spec_channels=129, filter_length=256, hop_length=64, win_length=256,
    inter_channels=64, hidden_channels=64,
    upsample_initial_channel=128, upsample_rates=(4, 4, 4), upsample_kernel_sizes=(8, 8, 8),
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    gin_channels=64,
)
B, T_FRAMES, SEG = 2, 48, 16
JCFG, TCFG = jax_cfg(TINY_TRAIN), torch_cfg(TINY_TRAIN)


def batch(seed: int = 0):
    """tests/test_training.py's batch, as numpy."""
    rng = np.random.default_rng(seed)
    spec = np.abs(rng.standard_normal((B, T_FRAMES, TINY_TRAIN["spec_channels"]))).astype(np.float32)
    audio = (rng.standard_normal((B, T_FRAMES * TINY_TRAIN["hop_length"])) * 0.1).astype(np.float32)
    lens = np.array([T_FRAMES, T_FRAMES - 8], np.int32)
    g = rng.standard_normal((B, 1, TINY_TRAIN["gin_channels"])).astype(np.float32) * 0.1
    return spec, audio, lens, g


def jax_draws(rng, lens, seg: int = SEG):
    """The noise and slice starts JAX's converter_loss / _generator_forward
    draw from `rng` (training/train.py:87-89, :106-107), as numpy."""
    k_noise, k_slice = jax.random.split(rng)
    noise = jax.random.normal(k_noise, (B, T_FRAMES, TINY_TRAIN["inter_channels"]), jnp.float32)
    max_start = jnp.maximum(jnp.asarray(lens) - seg, 1)
    starts = (jax.random.uniform(k_slice, (B,)) * max_start).astype(jnp.int32)
    return np.asarray(noise), np.asarray(starts)


def train_weights() -> dict:
    """JAX generator weights (the flow's `post` seeded non-zero) and JAX
    discriminator weights, as numpy pytrees."""
    return {"gen": jax_params(TINY_TRAIN, seed=0),
            "disc": jax.tree.map(np.asarray, JD.init_discriminators(jax.random.PRNGKey(1)))}


def assert_grads_close(torch_grads: dict, jax_grads: dict, rel: float = 1e-3) -> None:
    """Leaf by leaf: |port − JAX| ≤ rel × the leaf's peak |JAX|."""
    assert torch_grads.keys() == jax_grads.keys()
    for name, ref in jax_grads.items():
        got = torch_grads[name]
        assert got.shape == ref.shape, name
        peak = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        assert err <= rel * peak or err == 0.0, f"{name}: max err {err:.3e}, peak {peak:.3e}"


def gen_grads_by_name(model, grads) -> dict:
    return {name: gr.numpy() for (name, _), gr in zip(model.named_parameters(), grads)}


def jax_gen_grads_by_name(jax_grads) -> dict:
    """JAX generator gradients in the port's names and layouts (the weight
    bridge is a pure re-layout, so it carries gradients as it does weights)."""
    return {k: np.asarray(v, np.float32) for k, v in jax_state_dict(jax.tree.map(np.asarray, jax_grads)).items()}
