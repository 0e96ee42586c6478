"""The port's converter training (``openvoice_tpu_torch/training``) against
the JAX package's (``openvoice_tpu/training``) on the CPU, at the JAX
suite's tiny training shapes (tests/test_training.py): the losses, the mel
filterbank and spectrogram, the discriminators, the gradients of both
objectives, AdamW against optax's ``adamw``, both train steps' metrics on
JAX's own draws of noise and slice starts, and the JAX suite's behaviour
tests (the 50-step overfit and the 20-step GAN run)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openvoice_tpu.audio import mel as jmel
from openvoice_tpu.audio import stft as jstft
from openvoice_tpu.training import discriminator as JD
from openvoice_tpu.training import losses as JL
from openvoice_tpu.training import train as JT
from openvoice_tpu_torch.audio import mel as tmel
from openvoice_tpu_torch.audio import stft as tstft
from openvoice_tpu_torch.ckpt.from_jax import discriminators_from_jax, synthesizer_from_jax
from openvoice_tpu_torch.training import discriminator as TD
from openvoice_tpu_torch.training import losses as TL
from openvoice_tpu_torch.training import train as TT
from tests._torch_port import t
from tests._torch_training import (
    B, JCFG, SEG, TCFG, assert_grads_close, batch, gen_grads_by_name, jax_draws, jax_gen_grads_by_name,
    train_weights,
)

@pytest.fixture(scope="module")
def weights():
    return train_weights()


# -- losses, mel, spectrogram -------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(3)
    z_p, m_q, logs_q = (rng.standard_normal((2, 20, 8)).astype(np.float32) for _ in range(3))
    mask = (np.arange(20)[None, :] < np.array([20, 13])[:, None]).astype(np.float32)[..., None]
    fm_real = [[rng.standard_normal((2, 5, 3)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    fm_fake = [[rng.standard_normal((2, 5, 3)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    logits_r = [rng.standard_normal((2, n)).astype(np.float32) for n in (7, 11, 4)]
    logits_f = [rng.standard_normal((2, n)).astype(np.float32) for n in (7, 11, 4)]
    tt = lambda tree: jax.tree.map(lambda a: t(a), tree)  # noqa: E731
    jj = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    pairs = [
        (TL.kl_to_standard_normal(t(z_p), t(m_q), t(logs_q), t(mask)),
         JL.kl_to_standard_normal(*jj((z_p, m_q, logs_q, mask)))),
        (TL.mel_l1(t(z_p), t(m_q)), JL.mel_l1(jnp.asarray(z_p), jnp.asarray(m_q))),
        (TL.feature_matching_loss(tt(fm_real), tt(fm_fake)), JL.feature_matching_loss(jj(fm_real), jj(fm_fake))),
        (TL.generator_adv_loss(tt(logits_f)), JL.generator_adv_loss(jj(logits_f))),
        (TL.discriminator_adv_loss(tt(logits_r), tt(logits_f)), JL.discriminator_adv_loss(jj(logits_r), jj(logits_f))),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (22050, 1024, 80, 0.0, None), (22050, 256, 80, 0.0, None), (16000, 512, 40, 20.0, 7000.0),
])
def test_mel_filterbank_is_jax_exactly(sr, n_fft, n_mels, fmin, fmax):
    np.testing.assert_array_equal(tmel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                                  jmel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax))


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (256, 64, 256), (512, 128, 400)])
def test_linear_spectrogram_and_mel_match_jax(n_fft, hop, win):
    y = (np.random.default_rng(n_fft).standard_normal((2, 6000)) * 0.3).astype(np.float32)
    spec = tstft.linear_spectrogram(t(y), n_fft, hop, win)
    ref = np.asarray(jstft.linear_spectrogram(jnp.asarray(y), n_fft, hop, win))
    assert spec.shape == ref.shape == (2, n_fft // 2 + 1, (6000 + n_fft - hop - n_fft) // hop + 1)
    np.testing.assert_allclose(spec.numpy(), ref, atol=1e-4 * float(np.abs(ref).max()), rtol=1e-4)
    mel = tmel.spec_to_mel(spec, 22050, n_fft, 80)
    mel_ref = np.asarray(jmel.spec_to_mel(jnp.asarray(ref), 22050, n_fft, 80))
    np.testing.assert_allclose(mel.numpy(), mel_ref, atol=1e-4, rtol=1e-4)
    full = tmel.mel_spectrogram(t(y), n_fft, 80, 22050, hop, win)
    full_ref = np.asarray(jmel.mel_spectrogram(jnp.asarray(y), n_fft, 80, 22050, hop, win))
    np.testing.assert_allclose(full.numpy(), full_ref, atol=1e-4, rtol=1e-4)


def test_mel_from_audio_frames_matches_jax():
    y = (np.random.default_rng(5).standard_normal((2, SEG * 64)) * 0.3).astype(np.float32)
    got = TT._mel_from_audio_frames(t(y), TCFG)
    ref = np.asarray(JT._mel_from_audio_frames(jnp.asarray(y), JCFG))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("length", [1009, 2 * 3 * 5 * 7 * 11])
def test_discriminators_match_jax(weights, length):
    """Every logit and every feature map within 1e-4 of its peak, on a
    length the periods do not divide (the reflect pad) and one they all do."""
    disc = discriminators_from_jax(weights["disc"]).eval()
    audio = (np.random.default_rng(length).standard_normal((B, length)) * 0.3).astype(np.float32)
    with torch.no_grad():
        logits, fmaps = disc(t(audio))
    j_logits, j_fmaps = jax.jit(JD.apply_discriminators)(weights["disc"], jnp.asarray(audio))
    assert len(logits) == len(j_logits) == 1 + len(TD.PERIODS)
    for lo, jlo in zip(logits, j_logits):
        ref = np.asarray(jlo)
        assert lo.shape == ref.shape
        np.testing.assert_allclose(lo.numpy(), ref, atol=1e-4 * float(np.abs(ref).max()))
    for i, (fs, jfs) in enumerate(zip(fmaps, j_fmaps)):
        for f, jf in zip(fs, jfs):
            # the port's maps are NC(H)(W); JAX's N(H)(W)C
            got = f.permute(0, 2, 3, 1).numpy() if f.dim() == 4 else f.transpose(1, 2).numpy()
            ref = np.asarray(jf)
            assert got.shape == ref.shape, i
            np.testing.assert_allclose(got, ref, atol=1e-4 * float(np.abs(ref).max()))


def test_discriminator_init_distribution():
    """normal(0, 0.01) weights and zero biases, as JAX's init draws them,
    reproducibly from the generator."""
    disc = TD.init_discriminators(torch.Generator().manual_seed(0))
    again = TD.init_discriminators(torch.Generator().manual_seed(0))
    for (name, p), q in zip(disc.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
    w = disc.periods[0].convs[4].weight
    assert abs(float(w.std()) - 0.01) < 2e-4 and abs(float(w.mean())) < 2e-4


# -- objectives and gradients ---------------------------------------------------

def test_slice_segments_clamps_like_dynamic_slice():
    x = np.arange(2 * 10 * 3, dtype=np.float32).reshape(2, 10, 3)
    starts = np.array([8, 100], np.int32)  # past T − seg: both clamp to 6
    got = TT._slice_segments(t(x), t(starts), 4).numpy()
    ref = np.asarray(JT._slice_segments(jnp.asarray(x), jnp.asarray(starts), 4))
    np.testing.assert_array_equal(got, ref)


def test_converter_loss_and_gradients_match_jax(weights):
    spec, audio, lens, g = batch()
    rng = jax.random.PRNGKey(1)
    noise, starts = jax_draws(rng, lens)

    def loss_fn(p):
        return JT.converter_loss(p, JCFG, jnp.asarray(spec), jnp.asarray(audio), jnp.asarray(lens),
                                 jnp.asarray(g), rng, segment_frames=SEG)

    (j_total, j_metrics), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(weights["gen"])
    model = synthesizer_from_jax(weights["gen"], TCFG)
    total, metrics = TT.converter_loss(model, TCFG, t(spec), t(audio), t(lens), t(g), segment_frames=SEG,
                                       noise=t(noise), starts=t(starts))
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-5)
    for k in ("mel", "kl"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-5)
    grads = TT.grads_of(total, model)
    assert_grads_close(gen_grads_by_name(model, grads), jax_gen_grads_by_name(j_grads))


# -- the optimizer --------------------------------------------------------------

def test_adamw_matches_optax_adamw():
    """3 steps on identical gradients, one leaf's gradient always zero (it is
    still decayed, as optax decays every leaf)."""
    rng = np.random.default_rng(11)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [(rng.uniform(0.5, 1.5, s) * rng.choice([-1, 1], s)).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * (i != 1) for i, s in enumerate(shapes)]
             for _ in range(3)]
    tparams = [torch.nn.Parameter(t(p.copy())) for p in params]
    opt = TT.make_optimizer(tparams, lr=1e-2)
    jopt = optax.adamw(1e-2, b1=0.8, b2=0.99, weight_decay=0.01)
    jparams = [jnp.asarray(p) for p in params]
    state_j = jopt.init(jparams)
    for step_grads in grads:
        for p, gr in zip(tparams, step_grads):
            p.grad = t(gr.copy())
        opt.step()
        updates, state_j = jopt.update([jnp.asarray(gr) for gr in step_grads], state_j, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for p, jp in zip(tparams, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6)
    assert not np.array_equal(tparams[1].detach().numpy(), params[1])  # decayed with a zero gradient


def test_train_steps_hand_every_parameter_a_gradient(weights):
    """AdamW skips a parameter whose .grad is None: the step must give each
    one its gradient, zeros included, so that ref_enc (unused in training)
    is decayed as optax decays it."""
    spec, audio, lens, g = batch()
    state = TT.make_train_state(synthesizer_from_jax(weights["gen"], TCFG))
    ref_before = state.model.ref_enc.proj.weight.detach().clone()
    state, _ = TT.train_step(state, TCFG, t(spec), t(audio), t(lens), t(g), torch.Generator().manual_seed(0),
                             segment_frames=SEG)
    assert state.step == 1
    assert all(p.grad is None for p in state.model.parameters())
    n_params = len(list(state.model.parameters()))
    assert len(state.opt.state) == n_params
    torch.testing.assert_close(state.model.ref_enc.proj.weight.detach(), ref_before * (1 - 2e-4 * 0.01),
                               rtol=1e-6, atol=0)


# -- whole steps against JAX -----------------------------------------------------

def test_train_step_metrics_match_jax(weights):
    """Two steps on JAX's draws: the second sees the weights after one AdamW
    update on each side."""
    spec, audio, lens, g = batch()
    jstate = JT.TrainState(params=jax.tree.map(jnp.asarray, weights["gen"]),
                           opt_state=JT.make_optimizer(2e-4).init(weights["gen"]), step=jnp.zeros((), jnp.int32))
    state = TT.make_train_state(synthesizer_from_jax(weights["gen"], TCFG))
    for seed in (1, 2):
        rng = jax.random.PRNGKey(seed)
        noise, starts = jax_draws(rng, lens)
        jstate, j_metrics = JT.train_step(jstate, JCFG, jnp.asarray(spec), jnp.asarray(audio), jnp.asarray(lens),
                                          jnp.asarray(g), rng, segment_frames=SEG)
        state, metrics = TT.train_step(state, TCFG, t(spec), t(audio), t(lens), t(g), segment_frames=SEG,
                                       noise=t(noise), starts=t(starts))
        for k in ("mel", "kl", "total"):
            np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-4, err_msg=k)


# -- the JAX suite's behaviour tests ---------------------------------------------

def test_training_learns_50_step_overfit():
    """tests/test_training.py's overfit: 50 steps on one fixed batch with
    fixed draws at lr 1e-3 must cut the total and the mel term."""
    state = TT.init_train_state(TCFG, torch.Generator().manual_seed(0), lr=1e-3, device="cpu")
    spec, audio, lens, g = (t(a) for a in batch())
    totals, mels = [], []
    for _ in range(50):
        state, metrics = TT.train_step(state, TCFG, spec, audio, lens, g, torch.Generator().manual_seed(42),
                                       lr=1e-3)
        totals.append(float(metrics["total"]))
        mels.append(float(metrics["mel"]))
    assert all(np.isfinite(totals))
    assert totals[-1] < 0.7 * totals[0], (totals[0], totals[-1])
    assert mels[-1] < 0.8 * mels[0], (mels[0], mels[-1])
    assert np.mean(totals[-10:]) < np.mean(totals[:10]) * 0.75


def test_steps_need_a_generator_or_draws(weights):
    spec, audio, lens, g = batch()
    model = synthesizer_from_jax(weights["gen"], TCFG)
    with pytest.raises(ValueError, match="Generator"):
        TT.converter_loss(model, TCFG, t(spec), t(audio), t(lens), t(g), segment_frames=SEG)
