"""The slice end to end: the port's conversion graph against the checked-in
golden and the JAX graph, and the port's `ToneColorConverter` (extract_se,
extract_se_from_file, convert with tau 0.3, seeded noise and the watermark
on) against the JAX package's, on the same weights and synthetic audio, for
the V2 converter and the V1 one (zero_g=False); `get_se` and its cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu.api import ToneColorConverter as JaxConverter
from openvoice_tpu.models import synthesizer as JS
from openvoice_tpu.pipeline import watermark as jwm
from openvoice_tpu_torch.api import ToneColorConverter
from openvoice_tpu_torch.audio.io import load_audio, write_wav
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.pipeline import watermark as twm
from tests._regen_golden import GOLDEN_DIR
from tests._torch_port import (
    TINY, TINY_API, TINY_V1, jax_cfg, jax_params, lengths_mask, t, torch_cfg, torch_model,
)

SR = 22050


@torch.inference_mode()
def test_golden_convert_audio():
    """The golden case of tests/_regen_golden.py (JAX PRNGKey(123) weights,
    tau 0, zero noise) through the bridge and the port's graph."""
    model = torch_model(TINY, jax_params(TINY, seed=123, random_post=False))
    rng = np.random.default_rng(77)
    n = 60
    spec = np.abs(rng.standard_normal((1, n, TINY["spec_channels"]))).astype(np.float32)
    g_s = rng.standard_normal((1, 1, TINY["gin_channels"])).astype(np.float32)
    g_t = rng.standard_normal((1, 1, TINY["gin_channels"])).astype(np.float32)
    audio, _ = TS.voice_conversion(model, t(spec), torch.tensor([n]), t(g_s), t(g_t), 0.0,
                                   torch.zeros(1, n, TINY["inter_channels"]))
    ref = np.load(GOLDEN_DIR / "convert_audio_tiny.npy")
    assert audio.shape[1] == ref.shape[0]
    np.testing.assert_allclose(audio[0, :, 0].numpy(), ref, atol=2e-5, rtol=1e-4)


@torch.inference_mode()
def test_voice_conversion_graph_matches_jax():
    """A padded batch at tau 0.3 with random flow `post` weights."""
    params = jax_params(TINY, seed=21)
    model = torch_model(TINY, params)
    rng = np.random.default_rng(8)
    lengths, n = np.asarray([48, 37]), 48
    spec = np.abs(rng.standard_normal((2, n, TINY["spec_channels"]))).astype(np.float32)
    spec *= lengths_mask(lengths, n)
    g_s = rng.standard_normal((2, 1, TINY["gin_channels"])).astype(np.float32)
    g_t = rng.standard_normal((2, 1, TINY["gin_channels"])).astype(np.float32)
    noise = rng.standard_normal((2, n, TINY["inter_channels"])).astype(np.float32)
    ref, _ = JS.voice_conversion(params, jax_cfg(TINY), jnp.asarray(spec), jnp.asarray(lengths),
                                 jnp.asarray(g_s), jnp.asarray(g_t), 0.3, jnp.asarray(noise))
    out, _ = TS.voice_conversion(model, t(spec), t(lengths), t(g_s), t(g_t), 0.3, t(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4)


def _voice(seconds: float, f0: float, seed: int) -> np.ndarray:
    """Speech-like test signal: a vibrato harmonic tone with syllable-rate
    envelope, pauses and a little noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * SR)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * tt))) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 2.5 * tt), 0, None) ** 0.5
    return (0.3 * x * env + 0.005 * rng.standard_normal(len(tt))).astype(np.float32)


@pytest.fixture(scope="module")
def converters():
    params = jax_params(TINY_API, seed=31)
    jconv = JaxConverter(cfg=jax_cfg(TINY_API))
    jconv.params = params
    tconv = ToneColorConverter(cfg=torch_cfg(TINY_API), device="cpu")
    tconv.set_model(torch_model(TINY_API, params))
    return jconv, tconv


def test_converter_extract_se_and_convert_match_jax(converters, tmp_path):
    jconv, tconv = converters
    paths = []
    for i, (secs, f0) in enumerate([(1.5, 140.0), (2.3, 210.0)]):
        paths.append(str(tmp_path / f"ref{i}.wav"))
        write_wav(paths[-1], _voice(secs, f0, seed=i), SR)
    se_src = tconv.extract_se(paths[:1])
    se_tgt = tconv.extract_se(paths)
    assert se_tgt.shape == (1, TINY_API["gin_channels"], 1)
    np.testing.assert_allclose(se_src, jconv.extract_se(paths[:1]), atol=1e-4)
    np.testing.assert_allclose(se_tgt, jconv.extract_se(paths), atol=1e-4)

    src = _voice(2.2, 120.0, seed=9)
    out = tconv.convert(src, se_src, se_tgt, tau=0.3, seed=4, message="ovt-port")
    ref = jconv.convert(src, se_src, se_tgt, tau=0.3, seed=4, message="ovt-port")
    n_frames = (len(src) + 192 - 256) // 64 + 1
    assert out.shape == ref.shape == (n_frames * 64,)
    np.testing.assert_allclose(out, ref, atol=5e-4)
    assert tconv.detect_watermark(out, 2) == "ovt-port"

    path = tmp_path / "src.wav"
    write_wav(str(path), src, SR)
    tconv.convert(str(path), se_src, se_tgt, output_path=str(tmp_path / "out.wav"), message="")
    assert (tmp_path / "out.wav").stat().st_size > 2 * len(out)


def test_extract_se_from_file_vad_matches_jax(converters, tmp_path):
    jconv, tconv = converters
    audio = np.concatenate([_voice(1.2, 150.0, 1), np.zeros(SR * 2, np.float32), _voice(1.4, 160.0, 2)])
    path = str(tmp_path / "ref.wav")
    write_wav(path, audio, SR)
    np.testing.assert_allclose(tconv.extract_se_from_file(path), jconv.extract_se_from_file(path),
                               atol=1e-4)


def test_extract_se_from_file_whisper_mode_matches_jax(converters, tmp_path, monkeypatch):
    """vad=False with no cached ASR weights: both packages find no whisper
    segmenter and take the whole file as one segment."""
    from openvoice_tpu.pipeline import whisper_seg as jseg
    from openvoice_tpu_torch.pipeline import whisper_seg as tseg

    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))  # an empty cache: no weights to find
    monkeypatch.setattr(jseg, "_SEGMENTER_CACHE", {})
    monkeypatch.setattr(tseg, "_SEGMENTER_CACHE", {})
    jconv, tconv = converters
    audio = np.concatenate([_voice(1.3, 170.0, 3), np.zeros(SR, np.float32), _voice(0.9, 130.0, 4)])
    path = str(tmp_path / "ref.wav")
    write_wav(path, audio, SR)
    se = tconv.extract_se_from_file(path, vad=False)
    assert tseg.make_segmenter(prefer_whisper=True) is None
    assert se.shape == (1, TINY_API["gin_channels"], 1)
    np.testing.assert_allclose(se, jconv.extract_se_from_file(path, vad=False), atol=1e-4)
    whole = tconv._se_from_audio_batch([load_audio(path, sr=SR)[0]])
    np.testing.assert_array_equal(se[0, :, 0], whole.astype(np.float32))


def test_npz_checkpoint_from_jax_loads_and_converts(tmp_path):
    """An .npz written by the JAX package's `save_npz` loads in the port,
    which then converts as JAX does from the same file (f32, 5e-4)."""
    from openvoice_tpu.ckpt.native_io import save_npz

    path = str(tmp_path / "conv.npz")
    save_npz(path, jax_params(TINY_API, seed=41))
    jconv = JaxConverter(cfg=jax_cfg(TINY_API))
    tconv = ToneColorConverter(cfg=torch_cfg(TINY_API), device="cpu")
    assert tconv.load_ckpt(path) == jconv.load_ckpt(path) == {"missing": [], "unexpected": []}
    rng = np.random.default_rng(5)
    se_src, se_tgt = (rng.standard_normal((1, TINY_API["gin_channels"], 1)).astype(np.float32) for _ in range(2))
    src = _voice(1.7, 140.0, seed=6)
    out = tconv.convert(src, se_src, se_tgt, tau=0.3, seed=2, message="")
    ref = jconv.convert(src, se_src, se_tgt, tau=0.3, seed=2, message="")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=5e-4)


def test_add_watermark_bit_equal_to_jax():
    audio = (np.random.default_rng(12).standard_normal(70000) * 0.1).astype(np.float32)
    marked = twm.add_watermark(audio, "openvox8")
    np.testing.assert_array_equal(marked, jwm.add_watermark(audio, "openvox8"))
    assert twm.detect_watermark(marked, 2) == jwm.detect_watermark(marked, 2) == "openvox8"


@pytest.fixture(scope="module")
def converters_v1():
    params = jax_params(TINY_V1, seed=33)
    jconv = JaxConverter(cfg=jax_cfg(TINY_V1))
    jconv.params = params
    tconv = ToneColorConverter(cfg=torch_cfg(TINY_V1), device="cpu")
    tconv.set_model(torch_model(TINY_V1, params))
    return jconv, tconv


def test_v1_converter_extract_se_and_convert_match_jax(converters_v1, tmp_path):
    """zero_g=False: the posterior encoder sees the source embedding and the
    decoder the target one; f32 at the V2 converter's bars."""
    jconv, tconv = converters_v1
    assert tconv.version == jconv.version == "v1"
    paths = []
    for i, (secs, f0) in enumerate([(1.6, 120.0), (2.1, 230.0)]):
        paths.append(str(tmp_path / f"ref{i}.wav"))
        write_wav(paths[-1], _voice(secs, f0, seed=20 + i), SR)
    se_src, se_tgt = tconv.extract_se(paths[:1]), tconv.extract_se(paths[1:])
    np.testing.assert_allclose(se_src, jconv.extract_se(paths[:1]), atol=1e-4)
    np.testing.assert_allclose(se_tgt, jconv.extract_se(paths[1:]), atol=1e-4)
    src = _voice(1.9, 140.0, seed=22)
    out = tconv.convert(src, se_src, se_tgt, tau=0.3, seed=6, message="")
    ref = jconv.convert(src, se_src, se_tgt, tau=0.3, seed=6, message="")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=5e-4)
    # the embeddings reach the decoder: another target changes the audio
    other = tconv.convert(src, se_src, se_src, tau=0.3, seed=6, message="")
    assert np.abs(other - out).max() > 10 * np.abs(out - ref).max()


def test_get_se_writes_then_reads_its_cache(converters_v1, tmp_path, monkeypatch):
    from openvoice_tpu.pipeline.se_extractor import get_se as jget_se
    from openvoice_tpu.pipeline.se_extractor import hash_audio as jhash_audio
    from openvoice_tpu_torch import get_se
    from openvoice_tpu_torch.pipeline.se_extractor import hash_audio

    jconv, tconv = converters_v1
    path = str(tmp_path / "speaker.wav")
    write_wav(path, _voice(2.4, 175.0, seed=23), SR)
    assert hash_audio(path) == jhash_audio(path)
    cache = tmp_path / "processed"
    se, name = get_se(path, tconv, target_dir=str(cache))
    ref, jname = jget_se(path, jconv, target_dir=str(tmp_path / "jax"))
    assert name == jname and name.startswith("speaker_v1_")
    assert se.shape == (1, TINY_V1["gin_channels"], 1)
    np.testing.assert_allclose(se, ref, atol=1e-4)
    np.testing.assert_array_equal(np.load(cache / name / "se.npy"), se)

    def refuse(*args, **kwargs):
        raise AssertionError("a cached embedding must be read, not recomputed")

    monkeypatch.setattr(tconv, "extract_se_from_file", refuse)
    again, again_name = get_se(path, tconv, target_dir=str(cache))
    assert again_name == name
    np.testing.assert_array_equal(again, se)
