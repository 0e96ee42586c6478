"""HTTP serving tier of the PyTorch port (the port of
``openvoice_tpu/serve/server.py``; the reference's Gradio app, openvoice_app.py,
as a small stdlib HTTP server with the same request semantics and guards).

Endpoints:
  POST /convert   {audio_b64 | audio_path, src_se?, tgt_se | tgt_ref_path, tau?, seed?}
                  — through the batcher's PCM mode
  POST /tts       {text, speaker, language, speed}   (V1 base TTS loaded)
  POST /clone     {text, src_se, tgt_se | tgt_ref_path, mode: fused|single}
                  — the text → cloned audio chain through the fused calls
  GET  /healthz   liveness
  GET  /metrics   JSON metrics snapshot: latency percentiles (``request_latency``,
                  ``convert_batch``) and the counters; the batcher's
                  ``batches``, ``busy_seconds``, ``audio_seconds``,
                  ``queue_seconds`` (its requests' waits from submit to the
                  dispatch of their group), ``dispatched_requests``,
                  ``true_frames`` (their frames) and ``dispatched_frames``
                  (bucket × padded rows): a rise of queue_seconds over one of
                  dispatched_requests is the mean queue wait, one minus
                  true_frames over dispatched_frames the padded share

A trace of the serving tier with the port's spans (``ov.batcher.plan``,
``ov.batcher.pack``, ``convert_batch``, ``ov.batcher.readback``,
``ov.batcher.answer``, ``ov.graph.*``; ``runtime/profiler.py``): wrap a
stretch of traffic in ``profile_to(dir)``, which records every thread (the
batcher's dispatch and reader threads too) and writes
``dir/trace.json`` for a Chrome trace viewer.  With no profiler running the
spans cost one flag read each.

Audio-bearing responses take an optional `format`: "f32" (default, exact),
"pcm16", "wav", or "mp3" (+ optional `kbps`, through the in-repo lame
encoder; the response reports the effective rate); an unknown format, a
`kbps` that is not an integer, or an absent encoder is a 400.  Request audio
is WAV.

Errors carry the app's ``[ERROR]`` strings (openvoice_app.py:42-120); every
request is isolated.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from openvoice_tpu_torch.api import (
    resolve_device, tts_convert_batched, tts_convert_single_dispatch,
)
from openvoice_tpu_torch.audio.io import encode_wav_bytes, load_audio
from openvoice_tpu_torch.runtime.profiler import METRICS
from openvoice_tpu_torch.serve.batcher import ConvertBatcher, ConvertRequest


class VoiceService:
    """A converter (and optionally a base-speaker TTS) behind the batcher,
    all on one device: the GPU unless the caller passes ``device="cpu"``."""

    def __init__(self, converter, tts_model=None, max_batch: int = 8, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        for model in (converter, tts_model):
            if model is not None and model.device != self.device:
                raise ValueError(f"{type(model).__name__} runs on {model.device}, the service on {self.device}")
        self.converter = converter
        self.tts_model = tts_model
        self.batcher = ConvertBatcher(converter._require_model(), converter.cfg, max_batch=max_batch,
                                      device=self.device)
        self.batcher.start()

    def close(self) -> None:
        self.batcher.stop()

    def convert_audio(self, audio: np.ndarray, src_se, tgt_se, tau: float = 0.3, seed: int = 0) -> np.ndarray:
        """One conversion through the batcher's PCM mode (the STFT runs in
        the batched call), watermarked when the converter watermarks."""
        req = ConvertRequest(
            audio=np.asarray(audio, np.float32),
            g_src=np.asarray(src_se, np.float32).reshape(-1),
            g_tgt=np.asarray(tgt_se, np.float32).reshape(-1),
            tau=tau,
            seed=seed,
        )
        out = self.batcher.submit(req).result(timeout=120)
        if self.converter.enable_watermark:
            out = self.converter.add_watermark(out, "default")
        return out


_FORMATS = ("f32", "pcm16", "wav", "mp3")


def encode_response_audio(out: np.ndarray, sr: int, fmt: str, kbps: int = 128) -> dict:
    """Audio payload for a JSON response in the requested wire format: f32
    (default, exact), pcm16 (2 bytes a sample), wav (a PCM16 container) or
    mp3 (lossy CBR at `kbps` through the in-repo lame encoder, reporting the
    effective rate; a ValueError, mapped to a 400, where the encoder is
    absent)."""
    out = np.asarray(out, np.float32)
    if fmt == "f32":
        return {"encoding": "f32", "audio_b64": base64.b64encode(out.tobytes()).decode()}
    if fmt == "pcm16":
        pcm = (np.clip(out, -1.0, 1.0) * 32767.0).astype(np.int16)
        return {"encoding": "pcm16", "audio_b64": base64.b64encode(pcm.tobytes()).decode()}
    if fmt == "wav":
        return {"encoding": "wav", "audio_b64": base64.b64encode(encode_wav_bytes(out, sr)).decode()}
    if fmt == "mp3":
        from openvoice_tpu_torch.audio.mp3 import encoder_available, write_mp3

        if not encoder_available():
            raise ValueError("[ERROR] mp3 output unavailable: libmp3lame missing")
        fd, path = tempfile.mkstemp(suffix=".mp3")
        os.close(fd)
        try:
            # the effective bitrate: lame clamps a request outside the MPEG
            # table for this sample rate (192 at 22.05 kHz encodes at 160)
            eff = write_mp3(path, out, sr, kbps=kbps)
            with open(path, "rb") as f:
                blob = f.read()
        finally:
            os.unlink(path)
        return {"encoding": "mp3", "kbps": eff, "audio_b64": base64.b64encode(blob).decode()}
    raise ValueError(f"[ERROR] unknown format {fmt!r}: expected one of {_FORMATS}")


def _guard_text(text: str) -> str | None:
    """Length guards matching the served demo (openvoice_app.py:97-114)."""
    if len(text) < 2:
        return "[ERROR] Please give a longer prompt text"
    if len(text) > 200:
        return (
            "[ERROR] Text length limited to 200 characters for this demo; "
            "please try shorter text"
        )
    return None


def make_handler(service: VoiceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/metrics":
                self._json(200, METRICS.snapshot())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._json(400, {"error": "[ERROR] invalid JSON body"})
                return
            try:
                if self.path == "/convert":
                    self._convert(req)
                elif self.path == "/tts":
                    self._tts(req)
                elif self.path == "/clone":
                    self._clone(req)
                else:
                    self._json(404, {"error": "not found"})
            except Exception as exc:  # noqa: BLE001 — per-request isolation
                METRICS.add("request_failures")
                self._json(500, {"error": f"[ERROR] {exc}"})

        def _send_audio(self, req, out: np.ndarray, sr: int) -> None:
            """200 with the audio in the requested wire format, or a 400 for
            an unknown format or an absent encoder."""
            try:
                # TypeError too: a JSON null or list `kbps` is the client's
                # error (400), not a server fault (500)
                payload = encode_response_audio(out, sr, req.get("format", "f32"), kbps=int(req.get("kbps", 128)))
            except (ValueError, TypeError) as exc:
                self._json(400, {"error": f"[ERROR] {exc}"})
                return
            self._json(200, {"sample_rate": sr, "num_samples": int(out.shape[0]), **payload})

        def _load_request_audio(self, req) -> np.ndarray:
            sr = service.converter.cfg.sampling_rate
            if "audio_b64" in req:
                with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                    f.write(base64.b64decode(req["audio_b64"]))
                    path = f.name
                try:
                    return load_audio(path, sr=sr)[0]
                finally:
                    os.unlink(path)
            if "audio_path" in req:
                return load_audio(req["audio_path"], sr=sr)[0]
            raise ValueError("missing audio_b64 or audio_path")

        def _tgt_se(self, req) -> np.ndarray | None:
            if "tgt_se" in req:
                return np.asarray(req["tgt_se"], np.float32)
            if "tgt_ref_path" in req:
                return np.asarray(service.converter.extract_se_from_file(req["tgt_ref_path"])).reshape(-1)
            return None

        def _convert(self, req) -> None:
            audio = self._load_request_audio(req)
            if "src_se" in req:
                src_se = np.asarray(req["src_se"], np.float32)
            else:
                src_se = service.converter._se_from_audio_batch([audio])
            tgt_se = self._tgt_se(req)
            if tgt_se is None:
                raise ValueError("missing tgt_se or tgt_ref_path")
            out = service.convert_audio(audio, src_se, tgt_se, tau=float(req.get("tau", 0.3)),
                                        seed=int(req.get("seed", 0)))
            self._send_audio(req, np.asarray(out, np.float32), service.converter.cfg.sampling_rate)

        def _clone(self, req) -> None:
            """The text → cloned audio chain through the fused calls
            (`tts_convert_batched` / `tts_convert_single_dispatch`).
            Malformed requests are 400s; only genuine faults reach the 500
            handler."""
            if service.tts_model is None:
                raise ValueError("no base TTS model loaded")
            text = req.get("text", "")
            err = _guard_text(text)
            if err:
                self._json(400, {"error": err})
                return
            mode = req.get("mode", "fused")
            if mode not in ("fused", "single"):
                self._json(400, {"error": (
                    f"[ERROR] unknown mode {mode!r}: expected 'fused' or "
                    "'single' (the two paths draw noise differently — a "
                    "silent fallback would change the audio)"
                )})
                return
            tgt_se = self._tgt_se(req)
            if tgt_se is None:
                self._json(400, {"error": "[ERROR] missing tgt_se or tgt_ref_path"})
                return
            if "src_se" not in req:
                self._json(400, {"error": (
                    "[ERROR] missing src_se (the fused chain needs the base "
                    "speaker's SE; use /tts + /convert to derive it)"
                )})
                return
            src_se = np.asarray(req["src_se"], np.float32)
            fn = tts_convert_single_dispatch if mode == "single" else tts_convert_batched
            t0 = time.perf_counter()
            out = fn(
                service.tts_model, service.converter, text, req.get("speaker", "default"), src_se, tgt_se,
                language=req.get("language", "English"), speed=float(req.get("speed", 1.0)),
                tau=float(req.get("tau", 0.3)), seed=int(req.get("seed", 0)),
            )
            sr = service.converter.cfg.sampling_rate
            METRICS.add("audio_seconds", len(out) / sr)
            METRICS.observe("request_latency", time.perf_counter() - t0)
            self._send_audio(req, np.asarray(out, np.float32), sr)

        def _tts(self, req) -> None:
            if service.tts_model is None:
                raise ValueError("no base TTS model loaded")
            text = req.get("text", "")
            err = _guard_text(text)
            if err:
                self._json(400, {"error": err})
                return
            # sentences batch per token and frame bucket (the same audio as
            # .tts() for the same seed)
            audio = service.tts_model.tts_batched(
                text, None, req.get("speaker", "default"), language=req.get("language", "English"),
                speed=float(req.get("speed", 1.0)),
            )
            self._send_audio(req, np.asarray(audio, np.float32), service.tts_model.cfg.sampling_rate)

    return Handler


def serve(service: VoiceService, host: str = "127.0.0.1", port: int = 7860) -> ThreadingHTTPServer:
    """Start the HTTP server in a background thread; returns the server
    (``shutdown()`` stops it)."""
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
