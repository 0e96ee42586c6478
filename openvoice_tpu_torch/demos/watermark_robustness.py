"""Demo: watermark abuse-chain robustness, measured live with REAL codecs
(the port's ``demos/demo_watermark_robustness.py``).

Embeds an 8-char message (reference framing, api.py:162-201), runs each
documented abuse (docs/QA.md) — PCM16, resample round-trip, re-gain, pads,
head trims, real mp3 (in-repo lame encoder), real Opus (system libopus),
and combination chains — and prints whether the detector recovers the
message.  The reference's wavmark robustness bar is api.py:105-109.  The
watermark is the port's bit-equal copy, the codecs its own build of the
repository's codec sources; a codec whose system library is absent is
printed as skipped.

Usage:
  python -m openvoice_tpu_torch.demos.watermark_robustness [--audio path.wav|.mp3]

Default input is the reference demo clip (``resources/demo_speaker0.mp3``,
relative to an OpenVoice checkout) when present, else a synthetic
speech-shaped host.  No model runs: ``--device`` only holds the port's
device rule (the card unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

MESSAGE = "@MyShell"
SR = 22050
DEFAULT_CLIP = "resources/demo_speaker0.mp3"


def speechlike(n: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    spec *= 1.0 / (1.0 + (freqs / 500.0) ** 1.5)
    x = np.fft.irfft(spec, n)
    env = 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * np.arange(n) / SR * 3.1))
    x = x * env
    return (0.15 * x / np.sqrt(np.mean(x**2))).astype(np.float32)


def _through_file(write, read, suffix: str, audio: np.ndarray, **kw) -> np.ndarray:
    """`audio` written by a codec to a temporary file and decoded again."""
    fd, path = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    try:
        write(path, audio, SR, **kw)
        y, _ = read(path)
    finally:
        os.unlink(path)
    return np.asarray(y, np.float32)


def abuses(marked: np.ndarray) -> list[tuple[str, np.ndarray | None]]:
    """(name, abused audio) for every abuse; None where the codec is absent."""
    from openvoice_tpu_torch.audio import ffdec, native, ogg, opus
    from openvoice_tpu_torch.audio.io import resample
    from openvoice_tpu_torch.audio.mp3 import encoder_available, read_mp3, write_mp3

    rows: list[tuple[str, np.ndarray | None]] = [
        ("untouched", marked),
        ("PCM16 round-trip", (np.round(np.clip(marked, -1, 1) * 32767) / 32767).astype(np.float32)),
        ("22.05→16→22.05 kHz resample", np.ascontiguousarray(
            resample(resample(marked, SR, 16000), 16000, SR), np.float32)[: len(marked)]),
        ("0.6× re-gain", (marked * 0.6).astype(np.float32)),
        ("1.7× re-gain", (marked * 1.7).astype(np.float32)),
        ("8000-sample leading pad", np.concatenate([np.zeros(8000, np.float32), marked])),
        ("1 s head trim", marked[SR:]),
        ("3 s head trim", marked[3 * SR :]),
    ]
    mp3_ok = native.available() and encoder_available()
    if mp3_ok:
        for kbps in (128, 64):
            rows.append((f"REAL mp3 {kbps} kbps", _through_file(write_mp3, read_mp3, ".mp3", marked, kbps=kbps)))
    else:
        rows.append(("REAL mp3 (encoder not built)", None))
    if opus.available():
        for kbps in (128, 64):
            rows.append((f"REAL Opus {kbps} kbps (incl. 24 kHz pair)", opus.opus_roundtrip(marked, SR, kbps=kbps)))
    else:
        rows.append(("REAL Opus (libopus missing)", None))
    if ogg.available():
        for q in (0.4, 0.0):
            rows.append((f"REAL Ogg/Vorbis q{q}", _through_file(ogg.write_ogg, ogg.read_ogg, ".ogg", marked,
                                                                quality=q)))
    else:
        rows.append(("REAL Ogg/Vorbis (libs missing)", None))
    if ffdec.available():
        for kbps in (96, 32):
            rows.append((f"REAL AAC/m4a {kbps} kbps", _through_file(ffdec.write_m4a, ffdec.read_any, ".m4a", marked,
                                                                    kbps=kbps)))
    else:
        rows.append(("REAL AAC/m4a (ffmpeg libs missing)", None))
    # combination chain: mp3 + re-gain + PCM16 + pad
    if mp3_ok:
        y = _through_file(write_mp3, read_mp3, ".mp3", marked, kbps=128) * 0.85
        y = (np.round(np.clip(y, -1, 1) * 32767) / 32767).astype(np.float32)
        rows.append(("mp3-128 + 0.85× + PCM16 + 300-pad", np.concatenate([np.zeros(300, np.float32), y])))
    else:
        rows.append(("mp3 combination chain (encoder not built)", None))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m openvoice_tpu_torch.demos.watermark_robustness")
    ap.add_argument("--audio", default=DEFAULT_CLIP)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)

    from openvoice_tpu_torch.api import resolve_device
    from openvoice_tpu_torch.pipeline import watermark as wm

    resolve_device(args.device)  # the device rule holds here too, though the demo runs on the host
    if os.path.exists(args.audio):
        from openvoice_tpu_torch.audio.io import load_audio

        host, _ = load_audio(args.audio, sr=SR)
        host = np.asarray(host, np.float32)
        src = args.audio
    else:
        host = speechlike(16 * 16000)
        src = "synthetic speech-shaped noise"
    marked = wm.add_watermark(host, MESSAGE)
    dist = marked - host
    print(f"host: {src} ({len(host)/SR:.1f} s)")
    print(f"embedding distortion: {20*np.log10(np.sqrt(np.mean(dist**2))):.1f} dBFS rms")

    print(f"{'abuse':42s} decoded")
    for name, audio in abuses(marked):
        if audio is None:
            print(f"{name:42s} (skipped)")
            continue
        got = wm.detect_watermark(audio, 2)
        ok = "OK " if got == MESSAGE else "FAIL"
        print(f"{name:42s} {ok} {got!r}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
