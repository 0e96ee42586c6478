"""Demo: converter over EXTERNAL base-TTS audio in any language (the port's
``demos/demo_external_tts.py``; parallels demo_part2.ipynb — the reference
runs OpenAI-TTS audio through the V1 converter across 11 languages, cells
5-10).

Conversion is text-free, so any speech in any language works as the base:
point --sources at one or more wav/mp3 files produced by any TTS (or real
recordings) and every one is re-rendered in the reference speaker's timbre.

Usage:
  python -m openvoice_tpu_torch.demos.external_tts \\
      --ckpt checkpoints/converter/checkpoint.pth \\
      --config checkpoints/converter/config.json \\
      --sources base_en.wav base_es.wav base_jp.wav \\
      --reference target_speaker.mp3 \\
      --outdir outputs/

Without --ckpt it runs with random weights (pipeline smoke test).  Each
conversion runs in f32.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m openvoice_tpu_torch.demos.external_tts")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--sources", nargs="+", required=True)
    ap.add_argument("--reference", required=True)
    ap.add_argument("--outdir", default="outputs")
    ap.add_argument("--tau", type=float, default=0.3)
    ap.add_argument("--message", default="@MyShell")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)

    from openvoice_tpu_torch.api import ToneColorConverter
    from openvoice_tpu_torch.config import V1_CONVERTER_CONFIG
    from openvoice_tpu_torch.pipeline.se_extractor import get_se

    if args.config:
        conv = ToneColorConverter(config_path=args.config, device=args.device)
    else:
        conv = ToneColorConverter(cfg=V1_CONVERTER_CONFIG, device=args.device)
    if args.ckpt:
        conv.load_ckpt(args.ckpt)
    else:
        print("[demo] no checkpoint given — random weights (smoke test)")
        conv.init_random()

    tgt_se, name = get_se(args.reference, conv, target_dir="processed", vad=True)
    print(f"[demo] target SE extracted ({name})")

    os.makedirs(args.outdir, exist_ok=True)
    for src in args.sources:
        src_se = conv.extract_se_from_file(src, vad=True)
        base = os.path.basename(src).rsplit(".", 1)[0]
        out_path = os.path.join(args.outdir, f"{base}_converted.wav")
        conv.convert(
            audio_src_path=src,
            src_se=src_se,
            tgt_se=tgt_se,
            output_path=out_path,
            tau=args.tau,
            message=args.message,
        )
        print(f"[demo] {src} → {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
