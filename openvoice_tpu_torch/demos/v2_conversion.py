"""Demo: V2 tone-color conversion (the port's ``demos/demo_v2_conversion.py``;
parallels demo_part3.ipynb).

Reference flow (demo_part3.ipynb cells 3-7): load converter checkpoint,
extract target SE from a reference recording, take base-TTS audio (here: any
wav/mp3 you provide) + its source SE, convert.

Usage:
  python -m openvoice_tpu_torch.demos.v2_conversion \\
      --ckpt checkpoints_v2/converter/checkpoint.pth \\
      --config checkpoints_v2/converter/config.json \\
      --source path/to/base_tts_output.wav \\
      --reference path/to/target_speaker.mp3 \\
      --output outputs/converted.wav

Without --ckpt it runs with random weights (pipeline smoke test).  The
conversion runs in f32 (``convert(fast=False)``, the parity mode).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m openvoice_tpu_torch.demos.v2_conversion")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--source", required=True)
    ap.add_argument("--reference", required=True)
    ap.add_argument("--output", default="outputs/converted.wav")
    ap.add_argument("--tau", type=float, default=0.3)
    ap.add_argument("--message", default="@MyShell")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)

    from openvoice_tpu_torch.api import ToneColorConverter
    from openvoice_tpu_torch.config import V2_CONVERTER_CONFIG
    from openvoice_tpu_torch.pipeline.se_extractor import get_se

    if args.config:
        conv = ToneColorConverter(config_path=args.config, device=args.device)
    else:
        conv = ToneColorConverter(cfg=V2_CONVERTER_CONFIG, device=args.device)
    if args.ckpt:
        conv.load_ckpt(args.ckpt)
    else:
        print("NOTE: no checkpoint given — using random weights (smoke test)")
        conv.init_random(0)

    print("extracting source tone color...")
    src_se, _ = get_se(args.source, conv, target_dir="processed")
    print("extracting target tone color...")
    tgt_se, _ = get_se(args.reference, conv, target_dir="processed")

    print("converting...")
    conv.convert(args.source, src_se, tgt_se, output_path=args.output,
                 tau=args.tau, message=args.message)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
