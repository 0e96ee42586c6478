"""Speaker-embedding extraction pipeline (the port of
``openvoice_tpu/pipeline/se_extractor.py``; reference se_extractor.py).

Reference audio → energy VAD → concatenated speech → ~10 s uniform segments,
which `ToneColorConverter.extract_se_from_file` batches through the
reference encoder.  Whisper-mode segmentation is `pipeline/whisper_seg.py`.
`get_se` is the reference's entry point, with its content-hash SE cache,
which here is read as well as written (the reference computes the key but
has the read commented out, se_extractor.py:137-141).
"""

from __future__ import annotations

import base64
import hashlib
import os

import numpy as np


def energy_vad(
    audio: np.ndarray,
    sr: int,
    frame_ms: float = 30.0,
    min_speech_s: float = 0.1,
    min_silence_s: float = 1.0,
    threshold_db: float = -40.0,
) -> list[tuple[int, int]]:
    """Speech segments as (start, end) sample indices.

    Adaptive threshold: max(noise floor + 10 dB, threshold_db relative to
    peak).  Matches the reference's silero settings in spirit
    (min_speech 0.1 s, min_silence 1 s — se_extractor.py:80-86).
    """
    frame = max(1, int(sr * frame_ms / 1000))
    n_frames = len(audio) // frame
    if n_frames == 0:
        return []
    x = audio[: n_frames * frame].reshape(n_frames, frame)
    rms = np.sqrt(np.mean(x * x, axis=1) + 1e-12)
    db = 20 * np.log10(rms + 1e-12)
    peak = db.max()
    floor = np.percentile(db, 10)
    thresh = max(floor + 10.0, peak + threshold_db)
    speech = db > thresh

    # merge: close gaps shorter than min_silence, drop islands < min_speech
    min_speech_f = max(1, int(min_speech_s * 1000 / frame_ms))
    min_sil_f = max(1, int(min_silence_s * 1000 / frame_ms))
    segments: list[tuple[int, int]] = []
    start = None
    gap = 0
    for i, s in enumerate(speech):
        if s:
            if start is None:
                start = i
            gap = 0
        elif start is not None:
            gap += 1
            if gap >= min_sil_f:
                end = i - gap + 1
                if end - start >= min_speech_f:
                    segments.append((start * frame, end * frame))
                start, gap = None, 0
    if start is not None:
        end = len(speech)
        if end - start >= min_speech_f:
            segments.append((start * frame, min(end * frame, len(audio))))
    return segments


def split_audio_vad(
    audio: np.ndarray, sr: int, split_seconds: float = 10.0
) -> list[np.ndarray]:
    """VAD → concatenate active speech → uniform ~split_seconds chunks
    (se_extractor.py:77-116 semantics, arrays instead of wav files)."""
    segs = energy_vad(audio, sr)
    if not segs:
        active = audio
    else:
        active = np.concatenate([audio[s:e] for s, e in segs])
    dur = len(active) / sr
    num_splits = int(round(dur / split_seconds))
    if num_splits < 1:
        if dur < 1.0:
            raise ValueError("input audio is too short")
        num_splits = 1
    bounds = np.linspace(0, len(active), num_splits + 1).astype(int)
    return [active[bounds[i] : bounds[i + 1]] for i in range(num_splits)]



def hash_audio(audio_path: str) -> str:
    """Content-addressed cache key (se_extractor.py:118-127 semantics): the
    decoded samples' SHA-256, base64, 16 characters."""
    from openvoice_tpu_torch.audio.io import load_audio

    arr, _ = load_audio(audio_path, sr=None)
    digest = hashlib.sha256(arr.tobytes()).digest()
    return base64.b64encode(digest).decode()[:16].replace("/", "_^")


def get_se(audio_path: str, converter, target_dir: str = "processed",
           vad: bool = True) -> tuple[np.ndarray, str]:
    """Reference-compatible entry (se_extractor.py:129-152) → (se
    [1, gin, 1], cache name).  The embedding is cached under
    ``target_dir/<name>_<version>_<hash>/se.npy`` and read from there when
    present."""
    version = getattr(converter, "version", "v2")
    base = os.path.basename(audio_path).rsplit(".", 1)[0]
    audio_name = f"{base}_{version}_{hash_audio(audio_path)}"
    se_path = os.path.join(target_dir, audio_name, "se.npy")
    if os.path.isfile(se_path):
        return np.load(se_path), audio_name
    se = np.asarray(converter.extract_se_from_file(audio_path, vad=vad))
    os.makedirs(os.path.dirname(se_path), exist_ok=True)
    np.save(se_path, se)
    return se, audio_name
