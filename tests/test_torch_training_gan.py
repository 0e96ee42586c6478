"""The port's adversarial training step against the JAX package's on the
CPU, at the JAX suite's tiny training shapes (tests/test_training.py): the
discriminator's and the generator's objectives and every gradient leaf of
each, one whole ``gan_train_step`` on JAX's own draws, and the JAX suite's
20-step "losses move" run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu.training import discriminator as JD
from openvoice_tpu.training import losses as JL
from openvoice_tpu.training import train as JT
from openvoice_tpu_torch.ckpt.from_jax import discriminators_from_jax, synthesizer_from_jax
from openvoice_tpu_torch.training import train as TT
from tests._torch_port import t
from tests._torch_training import (
    JCFG, SEG, TCFG, assert_grads_close, batch, gen_grads_by_name, jax_draws, jax_gen_grads_by_name,
    train_weights,
)


@pytest.fixture(scope="module")
def weights():
    return train_weights()


def _jax_gan_pieces(weights, spec, audio, lens, g, rng):
    """JAX's two GAN objectives at fixed weights: the discriminator's loss
    and the generator's through that same discriminator, with their grads."""
    args = (JCFG, jnp.asarray(spec), jnp.asarray(audio), jnp.asarray(lens), jnp.asarray(g), rng, SEG)
    a_hat, tgt, *_ = JT._generator_forward(weights["gen"], *args)
    fake = jax.lax.stop_gradient(a_hat)

    def d_loss_fn(d_params):
        lr_, _ = JD.apply_discriminators(d_params, tgt)
        lf_, _ = JD.apply_discriminators(d_params, fake)
        return JL.discriminator_adv_loss(lr_, lf_)

    def g_loss_fn(g_params):
        a_hat, tgt, z_p, m_q, logs_q, mask = JT._generator_forward(g_params, *args)
        loss_mel = JL.mel_l1(JT._mel_from_audio_frames(a_hat, JCFG), JT._mel_from_audio_frames(tgt, JCFG))
        loss_kl = JL.kl_to_standard_normal(z_p, m_q, logs_q, mask)
        _, fmaps_real = JD.apply_discriminators(weights["disc"], tgt)
        logits_fake, fmaps_fake = JD.apply_discriminators(weights["disc"], a_hat)
        loss_fm = JL.feature_matching_loss(jax.tree.map(jax.lax.stop_gradient, fmaps_real), fmaps_fake)
        return 45.0 * loss_mel + loss_kl + JL.generator_adv_loss(logits_fake) + 2.0 * loss_fm

    d_loss, d_grads = jax.jit(jax.value_and_grad(d_loss_fn))(weights["disc"])
    g_loss, g_grads = jax.jit(jax.value_and_grad(g_loss_fn))(weights["gen"])
    return d_loss, d_grads, g_loss, g_grads


def test_gan_objectives_and_gradients_match_jax(weights):
    """The discriminator's gradients of its loss, and the generator's of its
    loss through the same fixed discriminator, leaf by leaf."""
    spec, audio, lens, g = batch()
    rng = jax.random.PRNGKey(2)
    noise, starts = jax_draws(rng, lens)
    j_d_loss, j_d_grads, j_g_loss, j_g_grads = _jax_gan_pieces(weights, spec, audio, lens, g, rng)

    model = synthesizer_from_jax(weights["gen"], TCFG)
    disc = discriminators_from_jax(weights["disc"])
    fwd = TT._generator_forward(model, TCFG, t(spec), t(audio), t(lens), t(g), None, SEG, t(noise), t(starts))
    d_loss = TT.discriminator_loss(disc, fwd.target, fwd.audio_hat)
    np.testing.assert_allclose(float(d_loss), float(j_d_loss), rtol=1e-5)
    d_grads = TT.grads_of(d_loss, disc)
    j_d = discriminators_from_jax(jax.tree.map(np.asarray, j_d_grads)).state_dict()
    assert_grads_close({n: gr.numpy() for (n, _), gr in zip(disc.named_parameters(), d_grads)},
                        {k: v.numpy() for k, v in j_d.items()})

    g_loss, _ = TT.generator_loss(disc, fwd, TCFG)
    np.testing.assert_allclose(float(g_loss), float(j_g_loss), rtol=1e-5)
    g_grads = TT.grads_of(g_loss, model)
    assert all(p.grad is None for p in disc.parameters())  # the generator's grads leave D's alone
    assert_grads_close(gen_grads_by_name(model, g_grads), jax_gen_grads_by_name(j_g_grads))



def test_gan_train_step_metrics_match_jax(weights):
    spec, audio, lens, g = batch()
    opt = JT.make_optimizer(2e-4)
    gen_p = jax.tree.map(jnp.asarray, weights["gen"])
    disc_p = jax.tree.map(jnp.asarray, weights["disc"])
    jstate = JT.GanTrainState(gen=JT.TrainState(gen_p, opt.init(gen_p), jnp.zeros((), jnp.int32)),
                              disc=JT.TrainState(disc_p, opt.init(disc_p), jnp.zeros((), jnp.int32)))
    rng = jax.random.PRNGKey(3)
    noise, starts = jax_draws(rng, lens)
    _, j_metrics = JT.gan_train_step(jstate, JCFG, jnp.asarray(spec), jnp.asarray(audio), jnp.asarray(lens),
                                     jnp.asarray(g), rng, segment_frames=SEG)
    state = TT.GanTrainState(gen=TT.make_train_state(synthesizer_from_jax(weights["gen"], TCFG)),
                             disc=TT.make_train_state(discriminators_from_jax(weights["disc"])))
    d_before = [p.detach().clone() for p in state.disc.model.parameters()]
    state, metrics = TT.gan_train_step(state, TCFG, t(spec), t(audio), t(lens), t(g), segment_frames=SEG,
                                       noise=t(noise), starts=t(starts))
    assert set(metrics) == set(j_metrics) == {"mel", "kl", "adv", "fm", "gen_total", "disc"}
    for k in ("mel", "kl", "disc"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-4, err_msg=k)
    # adv, fm and gen_total see D after one Adam step, where a near-zero
    # gradient element may round to either sign
    for k in ("adv", "fm", "gen_total"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-3, err_msg=k)
    assert state.gen.step == state.disc.step == 1
    assert all(not torch.equal(p, q) for p, q in zip(state.disc.model.parameters(), d_before))



def test_gan_training_losses_move_the_right_way():
    """tests/test_training.py's GAN run: 20 steps on one fixed batch with
    fixed draws; the discriminator's loss and the mel term both fall."""
    state = TT.init_gan_train_state(TCFG, torch.Generator().manual_seed(0), lr=1e-3, device="cpu")
    spec, audio, lens, g = (t(a) for a in batch())
    discs, mels = [], []
    for _ in range(20):
        state, metrics = TT.gan_train_step(state, TCFG, spec, audio, lens, g, torch.Generator().manual_seed(7),
                                           segment_frames=SEG)
        discs.append(float(metrics["disc"]))
        mels.append(float(metrics["mel"]))
    assert np.mean(discs[-5:]) < np.mean(discs[:5]), (discs[:5], discs[-5:])
    assert np.mean(mels[-5:]) < np.mean(mels[:5]), (mels[:5], mels[-5:])
