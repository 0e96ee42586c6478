"""Demo web app of the PyTorch port (the port of ``openvoice_tpu/serve/app.py``;
the reference's Gradio app, openvoice_app.py, behind a stdlib HTTP UI).

* `VoiceApp.predict(prompt, style, audio_file_pth, agree)` keeps the
  reference's guard ladder and ``[ERROR]`` strings (openvoice_app.py:37-141):
  terms check, language detection and routing (EN/ZH models and source SEs),
  per-language style validation (EN: 9 styles; ZH: default only), a 2-200
  character limit, then get_se → tts → convert with the watermark message
  '@MyShell'.
* `detect_language` stands in for the reference's langid
  (openvoice_app.py:51): scripts for CJK, small stopword and diacritic
  profiles for Latin-script languages, so that what the app does not route
  is rejected as the reference rejects it.
* GET / serves a minimal HTML form; POST /predict takes JSON.
"""

from __future__ import annotations

import base64
import json
import re
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from openvoice_tpu_torch.api import resolve_device, tts_convert_batched
from openvoice_tpu_torch.audio.io import encode_wav_bytes
from openvoice_tpu_torch.pipeline.se_extractor import get_se

EN_STYLES = (
    "default", "whispering", "shouting", "excited", "cheerful",
    "terrified", "angry", "sad", "friendly",
)
ZH_STYLES = ("default",)
SUPPORTED_LANGUAGES = ("zh", "en")


# Distinctive stopwords/diacritics for the Latin-script languages the
# reference's langid most commonly sees (openvoice_app.py:51).  Words are
# chosen to be UNcommon in English so a single hit is strong signal.
_LATIN_PROFILES: dict[str, tuple[frozenset, str]] = {
    "es": (frozenset(
        "el los las es que una está como más pero por para con este esta "
        "hola gracias buenos días muy también donde cuando hacer tiene "
        "nosotros usted año señor".split()), "ñ¿¡áéíóúü"),
    "fr": (frozenset(
        "le les est et une ne pas pour avec mais comme je vous nous c'est "
        "des du au aux bonjour merci très aussi où quand faire être avoir "
        "monsieur oui".split()), "àâçèéêëîïôùûœ"),
    "de": (frozenset(
        "der die das ist und nicht ein eine mit aber wie mehr ich sie wir "
        "ihr hallo danke guten für von zu auf im den dem des sind haben "
        "werden auch sehr wenn oder".split()), "äöüß"),
    "it": (frozenset(
        "il lo gli della delle degli è che una non per sono questo questa "
        "anche come più ma ciao grazie buongiorno molto dove quando fare "
        "essere avere perché già così ecco nel sul con tutto".split()),
        "àèìòù"),
    "pt": (frozenset(
        "os das dos é não uma para com como mais mas também são este esta "
        "olá obrigado muito onde quando fazer ser ter você senhor sim "
        "coisa então já depois porque pelo pela uns umas".split()),
        "ãõçáâêô"),
    "nl": (frozenset(
        "het een niet maar ik jij wij zij hallo dank voor van naar zijn "
        "hebben worden ook heel als geen deze dit wat hoe waarom vandaag "
        "goede alstublieft nog wel bij uit ons jullie".split()), ""),
    "en": (frozenset(
        "the is and of to in that it you this for with was are be have "
        "not hello what when how there their would could about".split()), ""),
}


def detect_language(text: str) -> str:
    """Langid-equivalent detection for the app's routing set (reference:
    openvoice_app.py:51).  Script-based for CJK (Han → 'zh', kana → 'ja',
    hangul → 'ko'); Latin-script text is scored against small
    stopword/diacritic profiles so Spanish/French/German/Italian/
    Portuguese/Dutch is REJECTED by the unsupported-language gate instead
    of being fed to the EN G2P.
    Default remains 'en'."""
    has_han = False
    for ch in text:
        if "぀" <= ch <= "ヿ":  # hiragana/katakana
            return "ja"
        if "가" <= ch <= "힯" or "ᄀ" <= ch <= "ᇿ":  # hangul
            return "ko"
        if "一" <= ch <= "鿿" or "㐀" <= ch <= "䶿":
            has_han = True
    if has_han:
        return "zh"
    words = re.findall(r"[a-zà-ÿœß']+", text.lower())
    scores = {}
    for lang, (stopwords, diacritics) in _LATIN_PROFILES.items():
        scores[lang] = sum(1 for w in words if w in stopwords) + sum(
            2 for ch in text.lower() if ch in diacritics
        )
    best = max(scores, key=lambda k: scores[k])
    if best != "en" and scores[best] > scores["en"]:
        return best
    return "en"


@dataclass
class PredictResult:
    info: str
    audio: np.ndarray | None
    sample_rate: int | None


class VoiceApp:
    """The reference's predict() pipeline over loaded models, on one device:
    the GPU unless the caller passes ``device="cpu"``.

    en_tts/zh_tts: BaseSpeakerTTS or None; converter: ToneColorConverter;
    source_ses: {"en_default": se, "en_style": se, "zh_default": se}.
    """

    def __init__(self, converter, en_tts=None, zh_tts=None, source_ses=None,
                 watermark_message: str = "@MyShell", fused: bool = False, *,
                 device: str | torch.device | None = None):
        """fused=True serves the tts→convert chain with the base audio kept
        on the device (`api.tts_convert_batched`) where a source SE exists.
        It differs from the staged reference flow only in that the silence
        gaps between sentences pass through unconverted."""
        self.device = resolve_device(device)
        for model in (converter, en_tts, zh_tts):
            if model is not None and model.device != self.device:
                raise ValueError(f"{type(model).__name__} runs on {model.device}, the app on {self.device}")
        self.converter = converter
        self.en_tts = en_tts
        self.zh_tts = zh_tts
        self.source_ses = source_ses or {}
        self.watermark_message = watermark_message
        self.fused = fused

    def predict(self, prompt: str, style: str, audio_file_pth: str, agree: bool) -> PredictResult:
        if not agree:
            return PredictResult("[ERROR] Please accept the Terms & Condition!\n", None, None)

        lang = detect_language(prompt)
        if lang not in SUPPORTED_LANGUAGES:
            return PredictResult(
                f"[ERROR] The detected language {lang} for your input text is not in "
                f"our Supported Languages: {list(SUPPORTED_LANGUAGES)}\n", None, None,
            )

        if lang == "zh":
            tts_model, language = self.zh_tts, "Chinese"
            source_se = self.source_ses.get("zh_default")
            if style not in ZH_STYLES:
                return PredictResult(
                    f"[ERROR] The style {style} is not supported for Chinese, "
                    f"which should be in {list(ZH_STYLES)}\n", None, None,
                )
        else:
            tts_model, language = self.en_tts, "English"
            source_se = self.source_ses.get("en_default" if style == "default" else "en_style")
            if style not in EN_STYLES:
                return PredictResult(
                    f"[ERROR] The style {style} is not supported for English, "
                    f"which should be in {list(EN_STYLES)}\n", None, None,
                )

        if tts_model is None:
            return PredictResult(f"[ERROR] no base TTS model loaded for {language}\n", None, None)
        if len(prompt) < 2:
            return PredictResult("[ERROR] Please give a longer prompt text \n", None, None)
        if len(prompt) > 200:
            return PredictResult(
                "[ERROR] Text length limited to 200 characters for this demo, "
                "please try shorter text. You can clone our open-source repo "
                "and try for your usage \n", None, None,
            )

        try:
            target_se, _ = get_se(audio_file_pth, self.converter, target_dir="processed", vad=True)
        except Exception as e:  # noqa: BLE001 — the reference catches broadly here
            return PredictResult(f"[ERROR] Get target tone color error {e} \n", None, None)

        try:
            sr = tts_model.cfg.sampling_rate
            if self.fused and source_se is not None:
                # fast=False: the staged flow's f32 precision, so that fused
                # mode differs only in the gaps
                out = tts_convert_batched(
                    tts_model, self.converter, prompt, style, source_se, target_se, language=language,
                    tau=0.3, message=self.watermark_message, fast=False,
                )
            else:
                audio = tts_model.tts_batched(prompt, None, style, language=language)
                if source_se is None:
                    source_se = self.converter._se_from_audio_batch([audio])[None, :, None]
                out = self.converter.convert(audio, source_se, target_se, tau=0.3, message=self.watermark_message)
        except Exception as e:  # noqa: BLE001 — predict never throws: the ladder
            # is its only error channel (the reference rejects cleanly,
            # openvoice_app.py:41-114)
            return PredictResult(f"[ERROR] Synthesis error {e} \n", None, None)
        return PredictResult("Get response successfully \n", out, sr)


_PAGE = """<!doctype html><html><head><title>openvoice-tpu demo</title></head>
<body><h2>Voice cloning demo</h2>
<form onsubmit="go(event)">
<p><textarea id=prompt rows=3 cols=60>Hello, this is a voice cloning demo.</textarea></p>
<p>Style: <input id=style value=default> Reference audio path: <input id=ref size=40></p>
<p><label><input type=checkbox id=agree> I accept the terms</label>
<button>Synthesize</button></p></form>
<p id=info></p><audio id=player controls></audio>
<script>
async function go(e){e.preventDefault();
const r=await fetch('/predict',{method:'POST',headers:{'Content-Type':'application/json'},
body:JSON.stringify({prompt:prompt.value,style:style.value,audio_file_pth:ref.value,agree:agree.checked})});
const j=await r.json();info.textContent=j.info;
if(j.wav_b64){player.src='data:audio/wav;base64,'+j.wav_b64;player.play();}}
</script></body></html>"""


def make_app_handler(app: VoiceApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code, body, ctype="application/json"):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _PAGE, "text/html")
            else:
                self._send(404, json.dumps({"error": "not found"}))

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, json.dumps({"error": "not found"}))
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                result = app.predict(
                    req.get("prompt", ""), req.get("style", "default"),
                    req.get("audio_file_pth", ""), bool(req.get("agree", False)),
                )
                payload = {"info": result.info}
                if result.audio is not None:
                    payload["wav_b64"] = base64.b64encode(
                        encode_wav_bytes(result.audio, result.sample_rate)).decode()
                    payload["sample_rate"] = result.sample_rate
                self._send(200, json.dumps(payload))
            except Exception as exc:  # noqa: BLE001 — per-request isolation
                self._send(500, json.dumps({"info": f"[ERROR] {exc}"}))

    return Handler


def serve_app(app: VoiceApp, host: str = "127.0.0.1", port: int = 7860) -> ThreadingHTTPServer:
    """Start the app's HTTP server in a background thread; returns it
    (``shutdown()`` stops it)."""
    httpd = ThreadingHTTPServer((host, port), make_app_handler(app))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
