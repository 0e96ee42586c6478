"""Demo: V1 base-speaker TTS + style control + tone conversion (the port's
``demos/demo_v1_tts.py``; parallels demo_part1.ipynb / demo_part2.ipynb).

Usage:
  python -m openvoice_tpu_torch.demos.v1_tts \\
      --tts-ckpt checkpoints/base_speakers/EN/checkpoint.pth \\
      --tts-config checkpoints/base_speakers/EN/config.json \\
      --converter-ckpt checkpoints/converter/checkpoint.pth \\
      --converter-config checkpoints/converter/config.json \\
      --text "Did you ever hear a folk tale about a giant turtle?" \\
      --speaker default --reference resources/example_reference.mp3 \\
      --output outputs/demo_v1.wav

The TTS decodes in the bf16 serving mode (``fast=True``, through the flow
and decoder kernels) unless ``--parity`` asks for f32; the tone conversion
runs in f32.
"""

from __future__ import annotations

import argparse
import os
import shutil

from openvoice_tpu_torch.demos import clock


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m openvoice_tpu_torch.demos.v1_tts")
    ap.add_argument("--tts-ckpt", default=None)
    ap.add_argument("--tts-config", default=None)
    ap.add_argument("--converter-ckpt", default=None)
    ap.add_argument("--converter-config", default=None)
    ap.add_argument("--text", default="Hello from the TPU native voice cloning framework.")
    ap.add_argument("--speaker", default="default")
    ap.add_argument("--language", default="English")
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--reference", default=None, help="target speaker recording")
    ap.add_argument("--output", default="outputs/demo_v1.wav")
    ap.add_argument("--parity", action="store_true",
                    help="full-f32 decode (checkpoint-parity mode; the bf16 serving mode is the default, as in "
                         "the served app)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)

    from openvoice_tpu_torch.api import resolve_device

    device = resolve_device(args.device)
    t0 = last = clock(device)

    def mark(stage: str) -> None:
        nonlocal last
        now = clock(device)
        print(f"[{now - t0:7.1f}s] {stage} (+{now - last:.1f}s)")
        last = now

    from openvoice_tpu_torch.api import BaseSpeakerTTS, ToneColorConverter
    from openvoice_tpu_torch.config import V1_CONVERTER_CONFIG, v1_base_tts_config
    from openvoice_tpu_torch.pipeline.se_extractor import get_se
    from openvoice_tpu_torch.text import default_symbols

    if args.tts_config:
        tts = BaseSpeakerTTS(config_path=args.tts_config, device=device)
    else:
        tts = BaseSpeakerTTS(cfg=v1_base_tts_config(len(default_symbols)), device=device)
    if args.tts_ckpt:
        tts.load_ckpt(args.tts_ckpt)
    else:
        print("NOTE: no TTS checkpoint — random weights (smoke test)")
        tts.init_random(0)

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    tmp_path = os.path.join(os.path.dirname(args.output) or ".", "tmp_tts.wav")
    mark("models constructed")
    print("synthesizing...")
    tts.tts_batched(args.text, tmp_path, args.speaker, language=args.language,
                    speed=args.speed, fast=not args.parity)
    mark("TTS synthesis done")
    print(f"wrote base audio to {tmp_path}")

    if args.reference:
        if args.converter_config:
            conv = ToneColorConverter(config_path=args.converter_config, device=device)
        else:
            conv = ToneColorConverter(cfg=V1_CONVERTER_CONFIG, device=device)
        if args.converter_ckpt:
            conv.load_ckpt(args.converter_ckpt)
        else:
            conv.init_random(0)
        mark("converter constructed")
        src_se, _ = get_se(tmp_path, conv, target_dir="processed")
        tgt_se, _ = get_se(args.reference, conv, target_dir="processed")
        mark("speaker embeddings extracted")
        conv.convert(tmp_path, src_se, tgt_se, output_path=args.output, message="@MyShell")
        mark("tone conversion done")
        print(f"wrote converted audio to {args.output}")
    else:
        shutil.copyfile(tmp_path, args.output)
        print(f"no --reference: wrote base TTS audio to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
