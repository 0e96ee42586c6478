"""The port's HTTP server and demo app: a round trip on port 0 of /convert,
/tts and /clone (fused and single) held against the port's direct API calls,
the 400 guards, 404s, /metrics, the response formats (f32, pcm16, wav, and
mp3 at its effective kbps, or the JAX server's 400 where the encoder is
absent), and the app's language
detection, guard ladder and predict.  The host-only pieces (wire encoding,
text guards, language detection, the guard ladder) are held against the JAX
package's own functions (CPU; seeded random weights)."""

import base64
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import openvoice_tpu.audio.mp3 as jmp3
import openvoice_tpu_torch.audio.mp3 as tmp3
from openvoice_tpu.serve import app as japp
from openvoice_tpu.serve import server as jserver
from openvoice_tpu_torch import api as tapi
from openvoice_tpu_torch.audio.io import load_audio, read_wav, write_wav
from openvoice_tpu_torch.runtime.profiler import METRICS
from openvoice_tpu_torch.serve import app as tapp
from openvoice_tpu_torch.serve import server as tserver
from tests._torch_port import TINY_TAIL, TINY_TTS_TAIL, torch_cfg

WIRE_TOL = 3e-4  # the JAX suite's bar across the batcher's int16 wire (tests/test_serve.py)
TEXT = "hello there my good friend"


@pytest.fixture(scope="module")
def models():
    """A TTS whose decoder upsamples by the converter's hop (16), so that
    /clone's fused chain runs; seeded random weights, the flow's `post`
    convs made non-zero, and the converter's conv_post scaled up so that its
    audio (peak ~3e-4 from the random init) stands well above the int16
    wire's step."""
    tts = tapi.BaseSpeakerTTS(cfg=torch_cfg(TINY_TTS_TAIL), device="cpu")
    tts.init_random(0)
    conv = tapi.ToneColorConverter(cfg=torch_cfg(TINY_TAIL), device="cpu", enable_watermark=False)
    conv.init_random(1)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for model in (tts.model, conv.model):
            for layer in model.flow.flows[::2]:
                layer.post.weight.uniform_(-0.1, 0.1, generator=gen)
        conv.model.dec.conv_post.weight.mul_(100.0)
    tts.set_model(tts.model)
    conv.set_model(conv.model)
    return tts, conv


@pytest.fixture(scope="module")
def server(models):
    tts, conv = models
    svc = tserver.VoiceService(conv, tts_model=tts, max_batch=4, device="cpu")
    httpd = tserver.serve(svc, port=0)
    yield httpd.server_address[1], svc
    httpd.shutdown()
    svc.close()


@pytest.fixture(scope="module")
def ses():
    rng = np.random.default_rng(1)
    return (rng.standard_normal(TINY_TAIL["gin_channels"]).astype(np.float32),
            rng.standard_normal(TINY_TAIL["gin_channels"]).astype(np.float32))


def _post(port: int, path: str, body, timeout: float = 300.0) -> tuple[int, dict]:
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port: int, path: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _audio_from(resp: dict) -> np.ndarray:
    out = np.frombuffer(base64.b64decode(resp["audio_b64"]), np.float32)
    assert len(out) == resp["num_samples"]
    return out


def test_tts_endpoint_equals_tts_batched(server, models):
    port, _ = server
    tts, _ = models
    code, resp = _post(port, "/tts", {"text": TEXT})
    assert code == 200, resp
    assert resp["sample_rate"] == tts.cfg.sampling_rate
    np.testing.assert_array_equal(_audio_from(resp), tts.tts_batched(TEXT, None, "default"))


def test_convert_endpoint_equals_convert_at_tau_0(server, models, ses, tmp_path):
    """/convert goes through the batcher's PCM mode; at tau 0 it equals
    `convert` up to the int16 wire, by path and by base64 WAV, and derives
    the source SE from the audio when none is given."""
    port, _ = server
    _, conv = models
    src, tgt = ses
    sr = conv.cfg.sampling_rate
    wav = str(tmp_path / "src.wav")
    write_wav(wav, (np.random.default_rng(0).standard_normal(sr // 2) * 0.1).astype(np.float32), sr)
    audio = load_audio(wav, sr=sr)[0]
    direct = conv.convert(audio, src, tgt, tau=0.0, message="")
    assert float(np.abs(direct).max()) > 50 * WIRE_TOL
    code, resp = _post(port, "/convert", {"audio_path": wav, "src_se": src.tolist(), "tgt_se": tgt.tolist(),
                                          "tau": 0.0})
    assert code == 200, resp
    np.testing.assert_allclose(_audio_from(resp), direct, atol=WIRE_TOL)
    b64 = base64.b64encode(open(wav, "rb").read()).decode()
    code, resp = _post(port, "/convert", {"audio_b64": b64, "src_se": src.tolist(), "tgt_se": tgt.tolist(),
                                          "tau": 0.0})
    assert code == 200, resp
    np.testing.assert_allclose(_audio_from(resp), direct, atol=WIRE_TOL)
    code, resp = _post(port, "/convert", {"audio_path": wav, "tgt_se": tgt.tolist(), "tau": 0.0})
    assert code == 200, resp
    derived = conv.convert(audio, conv._se_from_audio_batch([audio]), tgt, tau=0.0, message="")
    np.testing.assert_allclose(_audio_from(resp), derived, atol=WIRE_TOL)
    code, resp = _post(port, "/convert", {"audio_path": wav, "src_se": src.tolist()})
    assert code == 500 and "tgt_se" in resp["error"]


@pytest.mark.parametrize("mode", ["fused", "single"])
def test_clone_endpoint_equals_the_direct_chain(server, models, ses, mode):
    port, _ = server
    tts, conv = models
    src, tgt = ses
    before = METRICS.snapshot()["counters"].get("audio_seconds", 0)
    code, resp = _post(port, "/clone", {"text": TEXT, "src_se": src.tolist(), "tgt_se": tgt.tolist(),
                                        "tau": 0.3, "seed": 5, "mode": mode})
    assert code == 200, resp
    fn = tapi.tts_convert_single_dispatch if mode == "single" else tapi.tts_convert_batched
    direct = fn(tts, conv, TEXT, "default", src, tgt, tau=0.3, seed=5)
    assert direct.size > 0 and float(np.abs(direct).max()) > 0
    np.testing.assert_array_equal(_audio_from(resp), direct)
    assert METRICS.snapshot()["counters"]["audio_seconds"] > before


def test_clone_and_tts_guards(server, ses):
    """Malformed requests are 400s with the JAX server's messages."""
    port, _ = server
    src, tgt = ses
    code, resp = _post(port, "/clone", {"text": "x"})
    assert code == 400 and resp["error"] == jserver._guard_text("x")
    code, resp = _post(port, "/clone", {"text": "hello there friend"})
    assert code == 400 and "tgt_se" in resp["error"]
    code, resp = _post(port, "/clone", {"text": "hello there friend", "tgt_se": tgt.tolist()})
    assert code == 400 and "src_se" in resp["error"]
    code, resp = _post(port, "/clone", {"text": "hello there friend", "tgt_se": tgt.tolist(),
                                        "src_se": src.tolist(), "mode": "Single"})
    assert code == 400 and "unknown mode" in resp["error"]
    code, resp = _post(port, "/tts", {"text": "word " * 50})
    assert code == 400 and resp["error"] == jserver._guard_text("word " * 50)
    code, resp = _post(port, "/tts", b"{not json")
    assert code == 400 and resp["error"] == "[ERROR] invalid JSON body"


def test_unknown_paths_are_404(server):
    port, _ = server
    assert _post(port, "/nope", {})[0] == 404
    assert _get(port, "/nope")[0] == 404


def test_metrics_and_health_endpoints(server):
    port, _ = server
    _post(port, "/tts", {"text": TEXT})
    code, snap = _get(port, "/metrics")
    assert code == 200 and set(snap) >= {"counters", "latency"}
    assert _get(port, "/healthz") == (200, {"status": "ok"})


def test_tts_response_formats(server, tmp_path):
    """f32 (default), pcm16 and wav carry the same audio; an unknown format
    is a 400; mp3 carries the audio at its effective kbps where the encoder
    is present, and is the JAX server's encoder-absent 400 where it is
    not."""
    port, _ = server
    body = {"text": TEXT}
    code, f32 = _post(port, "/tts", body)
    assert code == 200 and f32["encoding"] == "f32"
    ref = _audio_from(f32)
    code, pcm = _post(port, "/tts", dict(body, format="pcm16"))
    assert code == 200 and pcm["encoding"] == "pcm16"
    pcm_arr = np.frombuffer(base64.b64decode(pcm["audio_b64"]), np.int16)
    np.testing.assert_allclose(pcm_arr / 32767.0, ref, atol=1.5 / 32767.0)
    code, wav = _post(port, "/tts", dict(body, format="wav"))
    assert code == 200 and wav["encoding"] == "wav"
    (tmp_path / "resp.wav").write_bytes(base64.b64decode(wav["audio_b64"]))
    wav_arr, sr = read_wav(str(tmp_path / "resp.wav"))
    assert sr == wav["sample_rate"] and wav_arr.shape == ref.shape
    code, resp = _post(port, "/tts", dict(body, format="flac"))
    assert code == 400 and "unknown format" in resp["error"]
    code, resp = _post(port, "/tts", dict(body, format="mp3"))
    if jmp3.encoder_available():
        assert code == 200 and resp["encoding"] == "mp3" and resp["kbps"] == 128, resp
        (tmp_path / "resp.mp3").write_bytes(base64.b64decode(resp["audio_b64"]))
        mp3_arr, sr = load_audio(str(tmp_path / "resp.mp3"))
        assert sr == resp["sample_rate"] and len(ref) <= len(mp3_arr) <= len(ref) + 4608
    else:
        assert code == 400 and resp["error"].startswith("[ERROR] [ERROR] mp3 output unavailable:")


def test_wire_encodings_match_jax(monkeypatch):
    rng = np.random.default_rng(3)
    out = np.clip(rng.standard_normal(5000) * 0.4, -1.2, 1.2).astype(np.float32)
    for fmt in ("f32", "pcm16", "wav"):
        assert tserver.encode_response_audio(out, 22050, fmt) == jserver.encode_response_audio(out, 22050, fmt)
    # where the encoder is absent both answer with the same message
    monkeypatch.setattr(jmp3, "encoder_available", lambda: False)
    monkeypatch.setattr(tmp3, "encoder_available", lambda: False)
    with pytest.raises(ValueError) as theirs:
        jserver.encode_response_audio(out, 22050, "mp3")
    with pytest.raises(ValueError) as ours:
        tserver.encode_response_audio(out, 22050, "mp3")
    prefix = "[ERROR] mp3 output unavailable:"
    assert str(theirs.value).startswith(prefix) and str(ours.value).startswith(prefix)
    for fmt in ("ogg", ""):
        with pytest.raises(ValueError) as theirs:
            jserver.encode_response_audio(out, 22050, fmt)
        with pytest.raises(ValueError) as ours:
            tserver.encode_response_audio(out, 22050, fmt)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.cuda
def test_service_on_cuda_with_no_index(ses):
    """Models made with device="cuda" behind a service made with the default
    device, as the README shows: the pair is accepted, the batcher's thread
    selects the card, and /convert's path and the fused chain both answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tts = tapi.BaseSpeakerTTS(cfg=torch_cfg(TINY_TTS_TAIL), device="cuda")
    tts.init_random(0)
    conv = tapi.ToneColorConverter(cfg=torch_cfg(TINY_TAIL), device="cuda", enable_watermark=False)
    conv.init_random(1)
    svc = tserver.VoiceService(conv, tts_model=tts, max_batch=4)
    try:
        assert svc.device == conv.device == tts.device == torch.device("cuda", torch.cuda.current_device())
        wave = np.random.default_rng(5).standard_normal(4000).astype(np.float32) * 0.1
        out = svc.convert_audio(wave, *ses, tau=0.0)
        assert out.ndim == 1 and out.size > 0 and np.isfinite(out).all()
        audio = tapi.tts_convert_batched(tts, conv, TEXT, "default", *ses, tau=0.3, seed=5)
        assert np.isfinite(np.asarray(audio)).all()
    finally:
        svc.close()


@pytest.mark.parametrize("text", ["", "x", "hi", "a" * 200, "a" * 201, "hello there"])
def test_guard_text_matches_jax(text):
    assert tserver._guard_text(text) == jserver._guard_text(text)


def test_service_and_app_refuse_models_on_another_device(models):
    tts, conv = models
    with pytest.raises(ValueError, match="runs on cpu"):
        tserver.VoiceService(conv, tts_model=tts, device="meta")
    with pytest.raises(ValueError, match="runs on cpu"):
        tapp.VoiceApp(conv, en_tts=tts, device="meta")


# -- the app ------------------------------------------------------------------------

LANG_CASES = [
    "hello world", "你好世界", "mixed 文本 here", "こんにちは元気ですか", "안녕하세요",
    "hola, ¿cómo estás? gracias por venir hoy", "bonjour, je suis très content de vous voir",
    "hallo, ich bin sehr froh dich zu sehen und danke", "the cafe was great and we had a nice day",
    "ciao, grazie mille per essere venuto oggi, sono molto felice",
    "olá, muito obrigado por ter vindo hoje, você é muito gentil",
    "hallo, dank je wel voor vandaag, wij zijn heel blij met jullie", "🎉🎉", "Привет мир", "", "٣١٤ مرحبا",
    "麒麟が街を歩く", "𝕳𝖊𝖑𝖑𝖔 𝖜𝖔𝖗𝖑𝖉",
]


@pytest.mark.parametrize("text", LANG_CASES)
def test_detect_language_matches_jax(text):
    assert tapp.detect_language(text) == japp.detect_language(text)


@pytest.fixture(scope="module")
def app(models):
    tts, conv = models
    return tapp.VoiceApp(conv, en_tts=tts, device="cpu")


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    sr = TINY_TAIL.get("sampling_rate", 22050)
    tt = np.arange(2 * sr) / sr
    path = str(tmp_path_factory.mktemp("app") / "ref.wav")
    write_wav(path, (0.3 * np.sin(2 * np.pi * 200 * tt)).astype(np.float32), sr)
    return path


@pytest.mark.parametrize("prompt,style,agree", [
    ("hello there", "default", False), ("hello there", "bogus-style", True), ("x", "default", True),
    ("word " * 60, "default", True), ("こんにちは、元気ですか？", "default", True),
    ("hola, ¿cómo estás? gracias por venir hoy", "default", True), ("你好世界", "whispering", True),
    ("你好世界", "default", True),
])
def test_predict_guards_match_jax(app, prompt, style, agree):
    """The guard ladder gives JAX's answer, word for word (the JAX app here
    needs no model: every case stops before synthesis)."""
    theirs = japp.VoiceApp(object(), en_tts=object()).predict(prompt, style, "x.wav", agree)
    ours = app.predict(prompt, style, "x.wav", agree)
    assert ours.info == theirs.info and ours.audio is None and theirs.audio is None


def test_predict_se_failure_and_end_to_end(app, models, ref_wav, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # predict caches SEs under ./processed, as the reference app does
    r = app.predict("hello there", "default", "/nonexistent/file.wav", agree=True)
    assert r.info.startswith("[ERROR] Get target tone color error") and r.audio is None
    r = app.predict("hello there friend", "default", ref_wav, agree=True)
    assert r.info == "Get response successfully \n", r.info
    assert r.audio is not None and r.audio.size > 0 and np.isfinite(r.audio).all()
    tts, conv = models
    assert r.sample_rate == tts.cfg.sampling_rate
    src = np.random.default_rng(4).standard_normal((1, TINY_TAIL["gin_channels"], 1)).astype(np.float32)
    fused = tapp.VoiceApp(conv, en_tts=tts, source_ses={"en_default": src}, fused=True, device="cpu")
    r = fused.predict("hello there friend", "default", ref_wav, agree=True)
    assert r.info == "Get response successfully \n", r.info
    assert r.audio is not None and r.audio.size > 0 and np.isfinite(r.audio).all()


def test_app_http_roundtrip(app, ref_wav, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    httpd = tapp.serve_app(app, port=0)
    port = httpd.server_address[1]
    try:
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read()
        assert b"Voice cloning demo" in page
        code, out = _post(port, "/predict", {"prompt": "hello there friend", "style": "default",
                                             "audio_file_pth": ref_wav, "agree": True})
        assert code == 200 and out["wav_b64"].startswith("UklGR"), out  # RIFF header in base64
        code, out = _post(port, "/predict", {"prompt": "hello there friend", "agree": False})
        assert code == 200 and "Terms & Condition" in out["info"] and "wav_b64" not in out
        assert _post(port, "/other", {})[0] == 404
        assert _get(port, "/other")[0] == 404
    finally:
        httpd.shutdown()
