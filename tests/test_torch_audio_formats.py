"""The port's audio formats against the JAX package's (CPU): its own build of
the in-repo codec libraries (``audio/_native_build.py``) and the bindings
over it (``audio/{native,mp3,ogg,flac,ffdec,opus}.py``), `load_audio`'s
dispatch, the server's mp3 answer, and mp3 training data.

Every decode is bit-equal to JAX's: the same C++ sources under the same
flags, over the same system libraries (mpg123, libvorbisfile, ffmpeg), and
the same numpy resampler.  A test that needs a system library skips, naming
it, only where the JAX package's binding reports it absent too.
"""

import base64
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from openvoice_tpu.audio import ffdec as jffdec
from openvoice_tpu.audio import flac as jflac
from openvoice_tpu.audio import io as jio
from openvoice_tpu.audio import mp3 as jmp3
from openvoice_tpu.audio import native as jnative
from openvoice_tpu.audio import ogg as jogg
from openvoice_tpu.audio import opus as jopus
from openvoice_tpu.pipeline.se_extractor import energy_vad as py_vad
from openvoice_tpu.serve import server as jserver
from openvoice_tpu.training import data as jdata
from openvoice_tpu_torch import api as tapi
from openvoice_tpu_torch.audio import _native_build
from openvoice_tpu_torch.audio import ffdec as tffdec
from openvoice_tpu_torch.audio import flac as tflac
from openvoice_tpu_torch.audio import io as tio
from openvoice_tpu_torch.audio import mp3 as tmp3
from openvoice_tpu_torch.audio import native as tnative
from openvoice_tpu_torch.audio import ogg as togg
from openvoice_tpu_torch.audio import opus as topus
from openvoice_tpu_torch.serve import server as tserver
from openvoice_tpu_torch.training import data as tdata
from tests._torch_port import TINY_TAIL, jax_cfg, torch_cfg

SR = 44100

# format → (JAX writer, port writer, JAX availability, the system library it needs)
FORMATS = {
    "mp3": (jmp3.write_mp3, tmp3.write_mp3, jmp3.encoder_available, "libmp3lame / libmpg123"),
    "ogg": (jogg.write_ogg, togg.write_ogg, jogg.available, "libvorbis / libvorbisfile"),
    "flac": (jflac.write_flac, tflac.write_flac, jflac.available, "none (in-repo codec)"),
    "m4a": (jffdec.write_m4a, tffdec.write_m4a, jffdec.available, "ffmpeg (avformat, avcodec, avutil, swresample)"),
}


def _need(fmt: str) -> None:
    *_, jax_available, lib = FORMATS[fmt]
    if not jax_available():
        pytest.skip(f"{fmt}: {lib} absent (the JAX package's binding reports it too)")


def _stereo(seconds: float = 1.5, sr: int = SR) -> np.ndarray:
    t = np.arange(int(seconds * sr)) / sr
    return np.stack([0.3 * np.sin(2 * np.pi * 220 * t), 0.2 * np.sin(2 * np.pi * 330 * t + 0.5)], 1).astype(np.float32)


def test_native_libraries_build_into_the_port_tree():
    """Named by a digest of flags, sources, compiler and CPU, under the
    port's git-ignored build directory; never native/build."""
    path = _native_build.build("ovt_audio")
    assert path.parent == _native_build.BUILD_DIR and path.exists()
    assert path == _native_build.library_path("ovt_audio")
    assert "native/build" not in str(path)
    assert tnative.available() and tflac.available()
    assert tffdec.available() == jffdec.available() == _native_build.ffmpeg_found()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("sr", [None, 22050])
def test_load_audio_matches_jax_on_files_jax_wrote(fmt, sr, tmp_path):
    _need(fmt)
    path = str(tmp_path / f"clip.{fmt}")
    FORMATS[fmt][0](path, _stereo(), SR)
    theirs, their_sr = jio.load_audio(path, sr=sr)
    ours, our_sr = tio.load_audio(path, sr=sr)
    assert our_sr == their_sr == (sr or SR) and ours.dtype == np.float32 and ours.ndim == 1
    np.testing.assert_array_equal(ours, theirs)
    stereo_ours, _ = tio.load_audio(path, mono=False)
    np.testing.assert_array_equal(stereo_ours, jio.load_audio(path, mono=False)[0])
    assert stereo_ours.shape[1] == 2


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_port_writers_decode_in_jax_readers(fmt, tmp_path):
    _need(fmt)
    x = _stereo(1.0)
    ours_path, theirs_path = str(tmp_path / f"ours.{fmt}"), str(tmp_path / f"theirs.{fmt}")
    FORMATS[fmt][1](ours_path, x, SR)
    FORMATS[fmt][0](theirs_path, x, SR)
    theirs, sr = jio.load_audio(ours_path, mono=False)
    assert sr == SR and theirs.shape[1] == 2
    np.testing.assert_array_equal(theirs, tio.load_audio(ours_path, mono=False)[0])
    if fmt == "flac":  # lossless at PCM16
        np.testing.assert_allclose(theirs, x, atol=1.0 / 32767.0)
    if fmt != "m4a":  # the same encoder on the same input: the same bytes
        assert open(ours_path, "rb").read() == open(theirs_path, "rb").read()


def test_unknown_extensions_read_as_wav(tmp_path):
    path = str(tmp_path / "clip.xyz")
    jio.write_wav(path, _stereo(0.2)[:, 0], SR)
    np.testing.assert_array_equal(tio.load_audio(path)[0], jio.load_audio(path)[0])


def test_mp3_effective_kbps_and_bad_requests_match_jax(tmp_path):
    for sr in (16000, 22050, 44100, 48000):
        for kbps in (1, 8, 64, 96, 150, 192, 320, 999):
            assert tmp3.effective_kbps(sr, kbps) == jmp3.effective_kbps(sr, kbps)
    with pytest.raises(ValueError, match="positive"):
        tmp3.effective_kbps(22050, 0)
    assert tmp3.encoder_available() == jmp3.encoder_available()


def test_mp3_response_matches_jax_and_round_trips():
    """The payload's encoding and effective kbps equal JAX's; the mp3
    decodes within the JAX suite's round-trip bar (tests/test_native.py:
    133-175): length within the codec's delay and padding, RMS within 0.02,
    the tone's peak within 2 Hz."""
    if not jmp3.encoder_available():
        pytest.skip("libmp3lame absent (the JAX package's binding reports it too)")
    sr = 22050
    t = np.arange(3 * sr) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 880 * t)).astype(np.float32)
    for kbps in (64, 128, 192):
        ours = tserver.encode_response_audio(x, sr, "mp3", kbps=kbps)
        theirs = jserver.encode_response_audio(x, sr, "mp3", kbps=kbps)
        assert ours["encoding"] == theirs["encoding"] == "mp3"
        assert ours["kbps"] == theirs["kbps"] == jmp3.effective_kbps(sr, kbps)
        assert ours["audio_b64"] == theirs["audio_b64"]
    y = _decode_mp3_payload(ours)
    assert len(x) <= len(y) <= len(x) + 4608
    assert abs(float(np.sqrt((y**2).mean())) - float(np.sqrt((x**2).mean()))) < 0.02
    spec = np.abs(np.fft.rfft(y[: 2 * sr]))
    assert abs(np.fft.rfftfreq(2 * sr, 1.0 / sr)[int(np.argmax(spec))] - 220.0) < 2.0


def _decode_mp3_payload(payload: dict) -> np.ndarray:
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".mp3")
    with os.fdopen(fd, "wb") as f:
        f.write(base64.b64decode(payload["audio_b64"]))
    try:
        return jmp3.read_mp3(path)[0]
    finally:
        os.unlink(path)


def _post(port: int, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/convert", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_answers_mp3_with_the_effective_kbps(tmp_path):
    """/convert of an mp3 request file answers format mp3 at kbps 64 with a
    decodable mp3 and the effective rate; a kbps of JSON null, a list or a
    non-number is the client's error (400), as in the JAX server."""
    if not jmp3.encoder_available():
        pytest.skip("libmp3lame absent (the JAX package's binding reports it too)")
    conv = tapi.ToneColorConverter(cfg=torch_cfg(TINY_TAIL), device="cpu", enable_watermark=False)
    conv.init_random(1)
    svc = tserver.VoiceService(conv, max_batch=2, device="cpu")
    httpd = tserver.serve(svc, port=0)
    try:
        port = httpd.server_address[1]
        src = str(tmp_path / "in.mp3")
        jmp3.write_mp3(src, _stereo(0.5, 22050), 22050)
        body = {"audio_path": src, "tgt_se": [0.1] * TINY_TAIL["gin_channels"], "format": "mp3", "kbps": 64}
        code, resp = _post(port, body)
        assert code == 200, resp
        assert resp["encoding"] == "mp3" and resp["kbps"] == 64 and resp["sample_rate"] == 22050
        y = _decode_mp3_payload(resp)
        assert resp["num_samples"] <= len(y) <= resp["num_samples"] + 4608
        for bad in (None, [64], "fast"):
            code, resp = _post(port, dict(body, kbps=bad))
            assert code == 400 and resp["error"].startswith("[ERROR]"), (bad, resp)
    finally:
        httpd.shutdown()
        svc.close()


def test_opus_roundtrip_matches_jax():
    if not jopus.available():
        pytest.skip("libopus absent (the JAX package's binding reports it too)")
    assert topus.available()
    x = (np.random.default_rng(0).standard_normal(22050) * 0.1).astype(np.float32)
    for sr, kbps in ((22050, 32), (24000, 64)):
        np.testing.assert_array_equal(topus.opus_roundtrip(x, sr, kbps), jopus.opus_roundtrip(x, sr, kbps))


def test_native_wav_resample_and_vad_match_jax(tmp_path):
    """tests/test_native.py:14-62 for the port: the native WAV codec both
    ways with the numpy one, the resampler and the VAD, each equal to the
    JAX package's binding."""
    rng = np.random.default_rng(1)
    x = np.clip(rng.standard_normal(8000) * 0.5, -0.999, 0.999).astype(np.float32)
    p = str(tmp_path / "a.wav")
    tnative.wav_write(p, x, 16000)
    y, sr = tio.read_wav(p)
    assert sr == 16000
    np.testing.assert_allclose(x, y, atol=1.0 / 16000)
    np.testing.assert_array_equal(tnative.wav_read(p)[0], jnative.wav_read(p)[0])
    sine = np.sin(2 * np.pi * 440.0 * np.arange(44100) / 44100).astype(np.float32)
    np.testing.assert_array_equal(tnative.resample(sine, 44100, 22050), jnative.resample(sine, 44100, 22050))
    sr = 16000
    tone = (0.3 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)).astype(np.float32)
    audio = np.concatenate([np.zeros(2 * sr, np.float32), tone, np.zeros(2 * sr, np.float32)])
    assert tnative.energy_vad(audio, sr) == jnative.energy_vad(audio, sr) == py_vad(audio, sr)


def test_prefetch_loader_matches_jax_and_isolates_errors(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"clip{i}.wav")
        jio.write_wav(p, (rng.standard_normal(44100) * 0.2).astype(np.float32), 44100, subtype="float32")
        paths.append(p)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"garbage")
    paths.insert(2, bad)
    got = {}
    for name, module in (("port", tnative), ("jax", jnative)):
        loader = module.PrefetchLoader(n_threads=3, target_sr=22050)
        try:
            for p in paths:
                loader.submit(p)
            got[name] = [loader.next() for _ in paths]
        finally:
            loader.close()
    assert [tk for tk, _ in got["port"]] == sorted(tk for tk, _ in got["port"])  # submission order
    for (tk, ours), (tk_j, theirs) in zip(got["port"], got["jax"]):
        assert tk == tk_j
        if theirs is None:
            assert ours is None  # a decode error reported, not fatal
        else:
            np.testing.assert_array_equal(ours, theirs)
    assert sum(c is None for _, c in got["port"]) == 1


@pytest.mark.parametrize("rank", [0, 1])
def test_scan_dataset_indexes_mp3_as_jax_does(rank, tmp_path):
    """A speaker set of WAV and mp3 files: the same segments as JAX's
    (an mp3's length from its decode), and the same shard of the file list
    for each rank of two."""
    _need("mp3")
    cfg_fields = dict(TINY_TAIL, hop_length=256, filter_length=1024, win_length=1024, spec_channels=513)
    rng = np.random.default_rng(3)
    for s in range(2):
        for i, ext in enumerate(("wav", "mp3", "wav", "mp3", "wav")):  # 5 a speaker: both kinds in each shard
            clip = (rng.standard_normal(int(22050 * (0.6 + 0.2 * i))) * 0.1).astype(np.float32)
            path = str(tmp_path / f"spk{s}" / f"utt{i}.{ext}")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            (jio.write_wav if ext == "wav" else jmp3.write_mp3)(path, clip, 22050)
    ours = tdata.scan_dataset(str(tmp_path), torch_cfg(cfg_fields), 16, process_index=rank, process_count=2)
    theirs = jdata.scan_dataset(str(tmp_path), jax_cfg(cfg_fields), 16, process_index=rank, process_count=2)
    assert [tuple(vars(s).values()) for s in ours] == [tuple(vars(s).values()) for s in theirs]
    assert any(s.path.endswith(".mp3") for s in ours) and any(s.path.endswith(".wav") for s in ours)
