"""The port's training input pipeline, loop and checkpoints
(``openvoice_tpu_torch/training/{data,loop}.py``, ``ckpt/native_io.py``)
against the JAX package's on the CPU: the same segments and bit-equal
batches from one directory, speaker embeddings from a converter (in the
prefetch worker thread) within 1e-4, the prefetch iterator's close and
slow-consumer cases, the loop's resume, the train-state checkpoint's exact
round trip, and the npz interchange with the JAX package both ways."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu.api import ToneColorConverter as JaxConverter
from openvoice_tpu.ckpt import native_io as JCIO
from openvoice_tpu.models import synthesizer as JS
from openvoice_tpu.training import data as JDATA
from openvoice_tpu_torch.api import ToneColorConverter
from openvoice_tpu_torch.audio.io import write_wav
from openvoice_tpu_torch.ckpt import native_io as CIO
from openvoice_tpu_torch.ckpt.from_jax import synthesizer_from_jax, synthesizer_to_jax
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.training import data as TDATA
from openvoice_tpu_torch.training import train as TT
from openvoice_tpu_torch.training.loop import train
from tests._torch_port import TINY_API, jax_cfg, jax_params, lengths_mask, t, torch_cfg

# the JAX suite's data config (tests/test_training_data.py)
TINY_DATA = dict(
    n_speakers=0, zero_g=True,
    spec_channels=129, filter_length=256, hop_length=64, win_length=256,
    inter_channels=64, hidden_channels=64,
    upsample_initial_channel=128, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    gin_channels=64, enc_q_layers=4, flow_n_flows=2, flow_wn_layers=2,
)
SR = 22050


def _tone(seconds: float, f0: float, seed: int) -> np.ndarray:
    """A harmonic tone with a syllable-rate envelope and a little noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * SR)) / SR
    x = sum(np.sin(2 * np.pi * k * f0 * tt) / k for k in range(1, 6))
    env = np.clip(np.sin(2 * np.pi * 2.5 * tt), 0, None) ** 0.5
    return (0.3 * x * env + 0.01 * rng.standard_normal(len(tt))).astype(np.float32)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """tests/test_training_data.py's layout: alice 2 files, bob 1, 3 s each."""
    root = tmp_path_factory.mktemp("ds")
    for s, (speaker, n_files, f0) in enumerate((("alice", 2, 140.0), ("bob", 1, 230.0))):
        (root / speaker).mkdir()
        for i in range(n_files):
            write_wav(str(root / speaker / f"utt{i}.wav"), _tone(3.0, f0, seed=10 * s + i), SR)
    return str(root)


def test_scan_matches_jax_and_shards(dataset_dir):
    segs = TDATA.scan_dataset(dataset_dir, torch_cfg(TINY_DATA), segment_frames=64)
    ref = JDATA.scan_dataset(dataset_dir, jax_cfg(TINY_DATA), segment_frames=64, process_index=0, process_count=1)
    assert [(s.path, s.start, s.frames, s.speaker) for s in segs] == \
        [(s.path, s.start, s.frames, s.speaker) for s in ref]
    assert {s.speaker for s in segs} == {"alice", "bob"}
    s0 = TDATA.scan_dataset(dataset_dir, torch_cfg(TINY_DATA), 64, process_index=0, process_count=2)
    s1 = TDATA.scan_dataset(dataset_dir, torch_cfg(TINY_DATA), 64, process_index=1, process_count=2)
    assert len(s0) + len(s1) == len(segs)
    assert {x.path for x in s0}.isdisjoint({x.path for x in s1})


def test_batches_are_bit_equal_to_jax(dataset_dir):
    ds = TDATA.ConverterDataset(dataset_dir, torch_cfg(TINY_DATA), batch_size=2, segment_frames=64, seed=5)
    ref = JDATA.ConverterDataset(dataset_dir, jax_cfg(TINY_DATA), batch_size=2, segment_frames=64, seed=5)
    got, want = list(ds), list(ref)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    spec, audio, lengths, g = got[0]
    assert spec.shape == (2, 64, TINY_DATA["spec_channels"]) and audio.shape == (2, 64 * 64)
    assert lengths.tolist() == [64, 64] and not g.any()


def test_speaker_embeddings_from_a_converter_match_jax(dataset_dir):
    """With a converter the batches carry each speaker's SE from its own
    reference encoder; the port extracts them in the prefetch worker thread."""
    params = jax_params(TINY_API, seed=31)
    jconv = JaxConverter(cfg=jax_cfg(TINY_API), enable_watermark=False)
    jconv.params = params
    tconv = ToneColorConverter(cfg=torch_cfg(TINY_API), device="cpu", enable_watermark=False)
    tconv.set_model(synthesizer_from_jax(params, torch_cfg(TINY_API)))
    ref = JDATA.ConverterDataset(dataset_dir, jax_cfg(TINY_API), 4, 64, seed=1, converter=jconv)
    ds = TDATA.ConverterDataset(dataset_dir, torch_cfg(TINY_API), 4, 64, seed=1, converter=tconv)
    with TDATA.PrefetchIterator(iter(ds)) as it:
        spec, audio, _, g = next(it)
    r_spec, r_audio, _, r_g = next(iter(ref))
    np.testing.assert_array_equal(spec, r_spec)
    np.testing.assert_array_equal(audio, r_audio)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(g, r_g, atol=1e-4 * float(np.abs(r_g).max()), rtol=1e-4)


def test_prefetch_iterator_matches_direct_and_raises_worker_errors(dataset_dir):
    cfg = torch_cfg(TINY_DATA)
    direct = list(TDATA.ConverterDataset(dataset_dir, cfg, 2, 64, seed=5))
    fetched = list(TDATA.PrefetchIterator(iter(TDATA.ConverterDataset(dataset_dir, cfg, 2, 64, seed=5)), depth=2))
    assert len(direct) == len(fetched) > 0
    for a, b in zip(direct, fetched):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    def boom():
        yield 1
        raise RuntimeError("worker died")

    it = TDATA.PrefetchIterator(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="worker died"):
        next(it)


def test_prefetch_iterator_close_stops_worker():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = TDATA.PrefetchIterator(endless(), depth=2)
    assert next(it) == 0
    it.close()
    assert not it._thread.is_alive()
    it.close()  # idempotent
    with TDATA.PrefetchIterator(endless(), depth=2) as it2:
        assert next(it2) == 0
    assert not it2._thread.is_alive()


def test_prefetch_iterator_slow_consumer_gets_stop_iteration():
    """The queue is full when a fast producer ends: the done marker must
    still be delivered, or a drained consumer blocks forever."""
    import threading
    import time

    got: list[int] = []
    finished = threading.Event()

    def consume():
        for x in TDATA.PrefetchIterator(iter(range(8)), depth=2):
            got.append(x)
            time.sleep(0.05)
        finished.set()

    threading.Thread(target=consume, daemon=True).start()
    assert finished.wait(timeout=10.0), "consumer deadlocked after drain"
    assert got == list(range(8))


def test_loop_train_checkpoint_resume_and_on_step(dataset_dir, tmp_path):
    """tests/test_training_data.py's resume test: periodic checkpoints land,
    a second call resumes from latest_step, on_step fires for exactly the
    steps run."""
    ckpt = str(tmp_path / "ck")
    cfg = torch_cfg(TINY_DATA)
    seen: list[int] = []
    train(dataset_dir, cfg, steps=5, batch_size=2, segment_frames=24, adversarial=False, ckpt_dir=ckpt,
          ckpt_every=2, log_every=0, on_step=lambda s, m: seen.append(s), device="cpu")
    assert seen == [1, 2, 3, 4, 5]
    assert CIO.latest_step(ckpt) == 5  # final save on exit
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_2", "step_4", "step_5"]

    seen2: list[int] = []
    state = train(dataset_dir, cfg, steps=8, batch_size=2, segment_frames=24, adversarial=False, ckpt_dir=ckpt,
                  ckpt_every=2, log_every=0, on_step=lambda s, m: seen2.append(s), device="cpu")
    assert seen2 == [6, 7, 8]  # resumed, not restarted
    assert CIO.latest_step(ckpt) == 8 and state.step == 8


def test_loop_stops_on_exhausted_dataset_and_refuses_small_ones(dataset_dir, monkeypatch):
    cfg = torch_cfg(TINY_DATA)
    with pytest.raises(ValueError, match="no full batch"):
        train(dataset_dir, cfg, steps=1, batch_size=10_000, segment_frames=24, adversarial=False, device="cpu")
    monkeypatch.setattr(TDATA.ConverterDataset, "__iter__", lambda self: iter(()))
    seen: list[int] = []
    train(dataset_dir, cfg, steps=3, batch_size=2, segment_frames=24, adversarial=False, log_every=0,
          on_step=lambda s, m: seen.append(s), device="cpu")
    assert seen == []


def test_gan_checkpoint_round_trip_is_exact(tmp_path):
    """Weights, both optimizers' moments and the steps come back bit for
    bit, and a step from the loaded state equals a step from the saved one."""
    cfg = torch_cfg(TINY_DATA)
    rng = np.random.default_rng(0)
    spec = t(np.abs(rng.standard_normal((2, 32, 129))).astype(np.float32))
    audio = t((rng.standard_normal((2, 32 * 64)) * 0.1).astype(np.float32))
    lens, g = torch.tensor([32, 30]), t(rng.standard_normal((2, 1, 64)).astype(np.float32))
    state = TT.init_gan_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    state, _ = TT.gan_train_step(state, cfg, spec, audio, lens, g, torch.Generator().manual_seed(1),
                                 segment_frames=16)
    path = CIO.save_checkpoint(str(tmp_path), state, step=1)
    assert path.endswith("step_1") and CIO.latest_step(str(tmp_path)) == 1
    loaded = CIO.load_checkpoint(path, template=TT.init_gan_train_state(cfg, torch.Generator().manual_seed(9),
                                                                         device="cpu"))
    for a, b in ((state.gen, loaded.gen), (state.disc, loaded.disc)):
        assert a.step == b.step == 1
        for (name, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
            assert torch.equal(p, q), name
        sa, sb = a.opt.state_dict(), b.opt.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, st in sa["state"].items():
            for k, v in st.items():
                assert torch.equal(v, sb["state"][i][k]), (i, k)
    _, m_a = TT.gan_train_step(state, cfg, spec, audio, lens, g, torch.Generator().manual_seed(2), segment_frames=16)
    _, m_b = TT.gan_train_step(loaded, cfg, spec, audio, lens, g, torch.Generator().manual_seed(2), segment_frames=16)
    assert {k: float(v) for k, v in m_a.items()} == {k: float(v) for k, v in m_b.items()}
    assert CIO.load_checkpoint(path)["gen"]["step"] == 1  # the raw payload without a template


# -- npz interchange with the JAX package -----------------------------------------

def _flat(tree) -> dict:
    return CIO._flatten(tree)


def test_synthesizer_to_jax_inverts_the_bridge_exactly():
    params = jax_params(TINY_API, seed=4)
    back = synthesizer_to_jax(synthesizer_from_jax(params, torch_cfg(TINY_API)))
    want, got = _flat(params), _flat(back)
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_npz_is_read_by_jax(tmp_path):
    """A port-written npz loads in the JAX package, whose voice_conversion on
    it matches the port's within 5e-4; and the port reads a JAX-written npz
    back to the same weights."""
    cfg = torch_cfg(TINY_API)
    model = TS.init_synthesizer(cfg, torch.Generator().manual_seed(3))
    path = str(tmp_path / "conv.npz")
    CIO.save_npz(path, synthesizer_to_jax(model))
    jparams = JCIO.load_npz(path)
    rng = np.random.default_rng(8)
    lengths, n = np.asarray([40, 29]), 40
    spec = np.abs(rng.standard_normal((2, n, cfg.spec_channels))).astype(np.float32) * lengths_mask(lengths, n)
    g_s, g_t = (rng.standard_normal((2, 1, cfg.gin_channels)).astype(np.float32) for _ in range(2))
    noise = rng.standard_normal((2, n, cfg.inter_channels)).astype(np.float32)
    ref, _ = JS.voice_conversion(jparams, jax_cfg(TINY_API), jnp.asarray(spec), jnp.asarray(lengths),
                                 jnp.asarray(g_s), jnp.asarray(g_t), 0.3, jnp.asarray(noise))
    with torch.no_grad():
        out, _ = TS.voice_conversion(model, t(spec), t(lengths), t(g_s), t(g_t), 0.3, t(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4)

    jax_path = str(tmp_path / "from_jax.npz")
    JCIO.save_npz(jax_path, jparams)
    again = synthesizer_from_jax(CIO.load_npz(jax_path), cfg)
    for (name, p), q in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q), name


def test_npz_tolerates_none_gaps(tmp_path):
    path = str(tmp_path / "t.npz")
    CIO.save_npz(path, {"xs": [np.ones(2), None, torch.full((2,), 3.0)], "cond": None})
    restored = CIO.load_npz(path)
    assert list(restored) == ["xs"] and len(restored["xs"]) == 2  # None leaves dropped, order kept
    np.testing.assert_array_equal(restored["xs"][1], np.full(2, 3.0, np.float32))
    assert JCIO.load_npz(path)["xs"][1].tolist() == [3.0, 3.0]
