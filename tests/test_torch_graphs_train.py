"""The port's train steps as CUDA graphs (``training/train.py`` through
``runtime/graphs.py``) on the CPU: each step's key against the JAX package's
jitted ``train_step`` / ``gan_train_step`` (static cfg and segment_frames,
shapes), each step's body filled twice against the eager step and against
JAX on the same draws, N replayed steps against N eager ones (parameters,
moments, step counts, metrics), ``train()`` through the graphs, and what
drops a train state's graphs.  Capture and replay go through the stand-ins
of ``tests/_torch_graphs.py``, whose capture must not step the state."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu.training import train as JT
from openvoice_tpu_torch.audio.io import write_wav
from openvoice_tpu_torch.ckpt import native_io as CIO
from openvoice_tpu_torch.ckpt.from_jax import discriminators_from_jax, synthesizer_from_jax
from openvoice_tpu_torch.runtime import graphs as G
from openvoice_tpu_torch.training import train as TT
from openvoice_tpu_torch.training.loop import train
from tests._torch_graphs import fake_graphs, install_fake_graphs  # noqa: F401 (fixture)
from tests._torch_port import t, torch_cfg
from tests._torch_training import B, JCFG, SEG, T_FRAMES, TCFG, TINY_TRAIN, batch, train_weights


@pytest.fixture(scope="module")
def weights():
    return train_weights()


def _jax_draws(rng):
    """JAX's noise and uniform u of the slice starts from `rng`
    (training/train.py:87-89, :106-107), as numpy."""
    k_noise, k_slice = jax.random.split(rng)
    noise = jax.random.normal(k_noise, (B, T_FRAMES, TINY_TRAIN["inter_channels"]), jnp.float32)
    return np.asarray(noise), np.asarray(jax.random.uniform(k_slice, (B,)))


def _gen_state(weights) -> TT.TrainState:
    return TT.make_train_state(synthesizer_from_jax(weights["gen"], TCFG))


def _gan_state(weights) -> TT.GanTrainState:
    return TT.GanTrainState(gen=_gen_state(weights), disc=TT.make_train_state(discriminators_from_jax(weights["disc"])))


def _jax_state(weights, gan: bool):
    """The JAX package's train state (or GAN state) on the same weights."""
    def one(params):
        params = jax.tree.map(jnp.asarray, params)
        return JT.TrainState(params, JT.make_optimizer(2e-4).init(params), jnp.zeros((), jnp.int32))

    return JT.GanTrainState(one(weights["gen"]), one(weights["disc"])) if gan else one(weights["gen"])


def _states(state) -> list:
    return [state.gen, state.disc] if isinstance(state, TT.GanTrainState) else [state]


def _assert_same_states(a, b) -> None:
    """Bit for bit: every parameter, every optimizer state (moments and
    step counts), the param groups and the step counts."""
    for x, y in zip(_states(a), _states(b)):
        assert x.step == y.step
        for (name, p), q in zip(x.model.state_dict().items(), y.model.state_dict().values()):
            assert torch.equal(p, q), name
        sx, sy = x.opt.state_dict(), y.opt.state_dict()
        assert sx["param_groups"] == sy["param_groups"] and sx["state"].keys() == sy["state"].keys()
        for i, st in sx["state"].items():
            for k, v in st.items():
                assert torch.equal(v, sy["state"][i][k]), (i, k)


def _host(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# -- keys ----------------------------------------------------------------------------

@pytest.mark.parametrize("gan", [False, True], ids=["mel_kl", "gan"])
def test_train_step_keys_follow_the_jitted_steps(weights, fake_graphs, monkeypatch, gan):
    """One graph per (site, B, T, segment_frames): a second step of a shape
    replays, another segment_frames or T captures anew, as the JAX step
    (static cfg and segment_frames; the GAN step's are the same) compiles
    anew.  The segment lengths are ones no other test file steps JAX with,
    so that its jit cache grows by this test's calls alone."""
    state = _gan_state(weights) if gan else _gen_state(weights)
    keys, real = [], state.graphs.run
    monkeypatch.setattr(state.graphs, "run", lambda key, body, inputs, consume=None: (
        keys.append(key), real(key, body, inputs, consume))[1])
    spec, audio, lens, g = batch()
    short = (spec[:, :40], audio[:, : 40 * TINY_TRAIN["hop_length"]], np.minimum(lens, 40), g)
    gen = torch.Generator().manual_seed(0)
    cases = [((spec, audio, lens, g), 12), ((spec, audio, lens, g), 12), ((spec, audio, lens, g), 8),
             (short, 12)]
    for arrays, seg in cases:
        (TT.gan_train_step if gan else TT.train_step)(state, TCFG, *(_host(a) for a in arrays), gen,
                                                      segment_frames=seg)
    site = "gan_train_step" if gan else "train_step"
    assert keys == [G.GraphKey(site, bucket=a[0].shape[1], batch=B, segment_frames=seg) for a, seg in cases]
    assert len(state.graphs) == state.graphs.captures == 3 and state.graphs.replays == 1
    assert all(ts.step == len(cases) for ts in _states(state))
    if not gan:
        jstate = _jax_state(weights, False)
        before = JT.train_step._cache_size()
        for arrays, seg in cases:
            jstate, _ = JT.train_step(jstate, JCFG, *(jnp.asarray(a) for a in arrays), jax.random.PRNGKey(0),
                                      segment_frames=seg)
        assert JT.train_step._cache_size() - before == len(set(keys)) == 3


# -- the bodies, filled twice -----------------------------------------------------------

def _cases(n: int) -> list[dict]:
    """n steps' staged inputs: the JAX suite's batch, JAX's draws from
    PRNGKey(i + 1)."""
    spec, audio, lens, g = batch()
    out = []
    for i in range(n):
        noise, u = _jax_draws(jax.random.PRNGKey(i + 1))
        out.append({"spec": spec, "audio": audio, "lengths": lens, "g": g, "noise": noise, "u": u,
                    "lr": np.float64(2e-4)})
    return out


@pytest.mark.parametrize("gan", [False, True], ids=["mel_kl", "gan"])
def test_step_bodies_filled_twice_equal_the_eager_step_and_jax(weights, gan):
    """Static buffers made once, filled with two steps' inputs in turn, the
    body run on them (the state updated in place each time): each step's
    metrics and the state after it equal the eager step's on the same
    draws exactly, and JAX's step on the same draws at the training
    suite's bars."""
    cases = _cases(2)
    body_state = _gan_state(weights) if gan else _gen_state(weights)
    eager_state = _gan_state(weights) if gan else _gen_state(weights)
    scalars = {"c_mel": 45.0, "c_kl": 1.0, "c_fm": 2.0} if gan else {}
    for c in cases:
        c.update({k: np.float32(v) for k, v in scalars.items()})
    body = partial(TT.gan_train_step_body if gan else TT.train_step_body, body_state, TCFG, SEG)
    names = TT.GAN_METRICS if gan else TT.TRAIN_METRICS
    static = {k: torch.empty(G._as_tensor(v).shape, dtype=G._as_tensor(v).dtype) for k, v in cases[0].items()}

    jstate = _jax_state(weights, gan)
    step, jstep = (TT.gan_train_step, JT.gan_train_step) if gan else (TT.train_step, JT.train_step)
    for i, c in enumerate(cases):
        G.stage(static, c)
        got = dict(zip(names, body(**static)))
        starts = TT.starts_from_u(t(c["u"]), t(c["lengths"]), SEG)
        _, want = step(eager_state, TCFG, t(c["spec"]), t(c["audio"]), t(c["lengths"]), t(c["g"]),
                       segment_frames=SEG, noise=t(c["noise"]), starts=starts)
        assert got.keys() == want.keys()
        for k in names:
            assert torch.equal(got[k], want[k]), k
        for ts in _states(body_state):
            ts.step += 1  # the caller's count, outside the body
        _assert_same_states(body_state, eager_state)
        jstate, jm = jstep(jstate, JCFG, *(jnp.asarray(c[k]) for k in ("spec", "audio", "lengths", "g")),
                           jax.random.PRNGKey(i + 1), segment_frames=SEG)
        for k in names:
            # adv, fm and gen_total see D after one Adam step, where a
            # near-zero gradient element may round to either sign
            rtol = 1e-3 if k in ("adv", "fm", "gen_total") else 1e-4
            np.testing.assert_allclose(float(got[k]), float(jm[k]), rtol=rtol, err_msg=f"step {i + 1} {k}")


# -- replays against eager steps -----------------------------------------------------------

@pytest.mark.parametrize("gan", [False, True], ids=["mel_kl", "gan"])
def test_replayed_steps_equal_eager_steps(weights, fake_graphs, gan):
    """Three steps from one state with one generator's draws, through the
    graphs (the first call eager and captured, the others replays) and
    with the graphs off: the same parameters, moments, step counts and
    metrics, bit for bit; three calls took three optimizer steps."""
    states = [_gan_state(weights) if gan else _gen_state(weights) for _ in range(2)]
    states[1].graphs.enabled = False
    step = TT.gan_train_step if gan else TT.train_step
    spec, audio, lens, g = (_host(a) for a in batch())
    metrics = [[], []]
    for state, out in zip(states, metrics):
        gen = torch.Generator().manual_seed(11)
        for lr in (2e-4, 2e-4, 1e-3):  # a changed rate reaches the graph: it is an input
            _, m = step(state, TCFG, spec, audio, lens, g, gen, segment_frames=SEG, lr=lr)
            out.append({k: float(v) for k, v in m.items()})
    assert (states[0].graphs.captures, states[0].graphs.replays) == (1, 2)
    assert states[1].graphs.captures == states[1].graphs.replays == 0
    assert metrics[0] == metrics[1]
    _assert_same_states(states[0], states[1])
    for ts in _states(states[0]):
        assert ts.step == 3
        assert all(float(st["step"]) == 3 for st in ts.opt.state.values())
        assert all(p.grad is None for p in ts.model.parameters())


def test_a_step_given_its_starts_refuses_an_active_graph_cache(weights, fake_graphs):
    state = _gen_state(weights)
    spec, audio, lens, g = (t(a) for a in batch())
    noise, u = _jax_draws(jax.random.PRNGKey(1))
    starts = TT.starts_from_u(t(u), lens, SEG)
    with pytest.raises(ValueError, match="pass u instead of starts"):
        TT.train_step(state, TCFG, spec, audio, lens, g, segment_frames=SEG, noise=t(noise), starts=starts)
    _, by_u = TT.train_step(state, TCFG, spec, audio, lens, g, segment_frames=SEG, noise=t(noise), u=t(u))
    assert state.step == 1 and state.graphs.captures == 1
    eager = _gen_state(weights)
    eager.graphs.enabled = False
    _, by_starts = TT.train_step(eager, TCFG, spec, audio, lens, g, segment_frames=SEG, noise=t(noise),
                                 starts=starts)
    assert {k: float(v) for k, v in by_u.items()} == {k: float(v) for k, v in by_starts.items()}


def test_the_cpu_optimizer_stays_as_it_is():
    """Off the card the optimizer is optax-algebra AdamW with a float rate,
    not capturable (the card's is capturable, its rate a device tensor)."""
    opt = TT.make_optimizer([torch.nn.Parameter(torch.zeros(3))], lr=3e-4)
    group = opt.param_groups[0]
    assert group["lr"] == 3e-4 and not torch.is_tensor(group["lr"]) and not group["capturable"]


# -- train() and what drops the graphs --------------------------------------------------------

TINY_DATA = dict(TINY_TRAIN, enc_q_layers=4, flow_n_flows=2, flow_wn_layers=2, upsample_rates=(4, 4),
                 upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Two speakers, one 2 s tone each."""
    root = tmp_path_factory.mktemp("graphs_ds")
    for s, f0 in enumerate((140.0, 230.0)):
        (root / f"speaker{s}").mkdir()
        x = np.arange(2 * 22050) / 22050
        write_wav(str(root / f"speaker{s}" / "utt0.wav"), (0.3 * np.sin(2 * np.pi * f0 * x)).astype(np.float32),
                  22050)
    return str(root)


@pytest.mark.parametrize("adversarial", [False, True], ids=["mel_kl", "gan"])
def test_train_loop_replays_and_equals_the_eager_loop(dataset_dir, monkeypatch, adversarial):
    """train() through the stand-in graphs (one capture, the rest replays)
    ends where train() with no graphs (the CPU: eager) ends, bit for bit."""
    cfg = torch_cfg(TINY_DATA)
    kw = dict(steps=3, batch_size=2, segment_frames=24, adversarial=adversarial, log_every=0, device="cpu")
    eager = train(dataset_dir, cfg, **kw)
    assert eager.graphs.captures == 0
    with monkeypatch.context() as m:
        install_fake_graphs(m)
        graphed = train(dataset_dir, cfg, **kw)
    assert (graphed.graphs.captures, graphed.graphs.replays) == (1, 2)
    _assert_same_states(graphed, eager)


def test_a_loaded_checkpoint_drops_the_train_graphs(weights, fake_graphs, tmp_path):
    """load_checkpoint(template=state) replaces the optimizer's moments the
    graphs read: it drops them, and the next step captures anew."""
    state = _gan_state(weights)
    spec, audio, lens, g = (_host(a) for a in batch())
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        TT.gan_train_step(state, TCFG, spec, audio, lens, g, gen, segment_frames=SEG)
    assert len(state.graphs) == 1
    path = CIO.save_checkpoint(str(tmp_path), state, step=2)
    assert CIO.load_checkpoint(path, template=state) is state and len(state.graphs) == 0
    assert state.gen.step == state.disc.step == 2
    TT.gan_train_step(state, TCFG, spec, audio, lens, g, gen, segment_frames=SEG)
    assert state.graphs.captures == 2 and state.gen.step == 3
