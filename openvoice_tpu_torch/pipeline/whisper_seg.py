"""ASR-based segmentation for SE extraction (the port's copy of
``openvoice_tpu/pipeline/whisper_seg.py``; reference: the whisper mode of
se_extractor.py:19-74 — faster-whisper word timestamps, keep segments of
1.5-20 s whose text is 2-200 chars).

The ASR backend is pluggable (host-side, off the hot path — SURVEY.md §7.3
item 6).  `HFWhisperSegmenter` adapts a locally cached HuggingFace Whisper;
with no weights on disk it raises at construction, and
`ToneColorConverter.extract_se_from_file(vad=False)` then takes the whole
file as one segment.  The VAD segmenter (`pipeline/se_extractor.py`) is the
served default, as in the reference (openvoice_app.py:118 passes vad=True).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence

import numpy as np


@dataclass(frozen=True)
class AsrSegment:
    start: float  # seconds
    end: float
    text: str


class Segmenter(Protocol):
    def transcribe(self, audio: np.ndarray, sr: int) -> Sequence[AsrSegment]: ...


# segment filters (se_extractor.py:61-64)
MIN_SEGMENT_S = 1.5
MAX_SEGMENT_S = 20.0
MIN_TEXT_CHARS = 2
MAX_TEXT_CHARS = 200


def split_audio_whisper(
    audio: np.ndarray,
    sr: int,
    segmenter: Segmenter,
    *,
    min_s: float = MIN_SEGMENT_S,
    max_s: float = MAX_SEGMENT_S,
    min_chars: int = MIN_TEXT_CHARS,
    max_chars: int = MAX_TEXT_CHARS,
) -> list[np.ndarray]:
    """ASR segments → filtered audio chunks, reference filter semantics:
    duration in [min_s, max_s] AND stripped text length in [min_chars,
    max_chars].  Segment boundaries are clamped and non-overlapping
    (start of segment i+1 ≥ end of segment i, se_extractor.py:50-57)."""
    chunks: list[np.ndarray] = []
    prev_end = 0.0
    for seg in segmenter.transcribe(audio, sr):
        start = max(seg.start, prev_end)
        end = min(seg.end, len(audio) / sr)
        if end <= start:
            continue
        dur = end - start
        text = seg.text.strip()
        if not (min_s <= dur <= max_s):
            continue
        if not (min_chars <= len(text) <= max_chars):
            continue
        chunks.append(audio[int(start * sr) : int(end * sr)])
        prev_end = end
    return chunks


class HFWhisperSegmenter:
    """HuggingFace Whisper adapter (CPU, local weights only — this image has
    no network egress, so construction fails cleanly when the model isn't in
    the local cache and callers use the VAD path instead)."""

    def __init__(self, model_name: str = "openai/whisper-tiny"):
        import os

        os.environ.setdefault("HF_HUB_OFFLINE", "1")  # never hit the network
        from transformers import pipeline  # local import: torch-cpu backend

        self._pipe = pipeline(
            "automatic-speech-recognition",
            model=model_name,
            device=-1,
            model_kwargs={"local_files_only": True},
        )

    def transcribe(self, audio: np.ndarray, sr: int) -> list[AsrSegment]:
        out = self._pipe(
            {"array": np.asarray(audio, np.float32), "sampling_rate": sr},
            return_timestamps=True,
        )
        segments = []
        for c in out.get("chunks", []):
            t0, t1 = c.get("timestamp", (None, None))
            if t0 is None:
                continue
            if t1 is None:
                t1 = len(audio) / sr
            segments.append(AsrSegment(float(t0), float(t1), c.get("text", "")))
        return segments


_SEGMENTER_CACHE: dict[str, object] = {}


def make_segmenter(prefer_whisper: bool = False):
    """Best-available segmenter: whisper when cached weights exist and
    requested, else None (callers use the VAD splitter).  The constructed
    segmenter (or the None verdict) is cached module-wide — a Whisper
    pipeline load costs seconds and must not recur per request."""
    if not prefer_whisper:
        return None
    if "whisper" not in _SEGMENTER_CACHE:
        try:
            _SEGMENTER_CACHE["whisper"] = HFWhisperSegmenter()
        except Exception:  # noqa: BLE001 — no weights / no backend
            _SEGMENTER_CACHE["whisper"] = None
    return _SEGMENTER_CACHE["whisper"]
