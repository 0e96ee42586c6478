"""Command-line tools of the port (the counterpart of ``openvoice_tpu/tools.py``).

  python -m openvoice_tpu_torch.tools convert-ckpt <ckpt.pth> <out_dir> [--config c.json | --preset v2]
  python -m openvoice_tpu_torch.tools serve        [--config c.json --ckpt x] [--port 7860]
  python -m openvoice_tpu_torch.tools train        <data_root> [--steps N --ckpt-dir d ...]
  python -m openvoice_tpu_torch.tools extract-se   <audio> [--out se.npy]

Every subcommand takes ``--device`` (default: the card, ``cuda``); without
CUDA it fails unless given ``--device cpu``.  `main(argv)` returns the exit
code, so that it can be called in process.
"""

from __future__ import annotations

import argparse
import sys


def _load_cfg(args):
    from openvoice_tpu_torch.config import (
        V1_CONVERTER_CONFIG, V2_CONVERTER_CONFIG, SynthesizerConfig, load_hparams, v1_base_tts_config,
    )
    from openvoice_tpu_torch.text import default_symbols

    if getattr(args, "config", None):
        return SynthesizerConfig.from_hparams(load_hparams(args.config))
    presets = {"v1-tts": lambda: v1_base_tts_config(len(default_symbols)),
               "v1": lambda: V1_CONVERTER_CONFIG, "v2": lambda: V2_CONVERTER_CONFIG}
    return presets[getattr(args, "preset", "v2")]()


def _converter(args):
    """A converter on ``--device`` from ``--config`` or ``--preset``."""
    from openvoice_tpu_torch.api import ToneColorConverter

    if args.config:
        return ToneColorConverter(config_path=args.config, device=args.device)
    return ToneColorConverter(cfg=_load_cfg(args), device=args.device)


def cmd_convert_ckpt(args) -> int:
    from openvoice_tpu_torch.api import resolve_device
    from openvoice_tpu_torch.ckpt.native_io import convert_torch_checkpoint

    resolve_device(args.device)  # the device rule holds here too, though conversion runs on the host
    path = convert_torch_checkpoint(args.ckpt, args.out_dir, _load_cfg(args))
    print(f"converted → {path}")
    return 0


def cmd_serve(args) -> int:
    from openvoice_tpu_torch.serve.server import VoiceService, serve

    conv = _converter(args)
    if args.ckpt:
        if args.ckpt.endswith(".pth"):
            conv.load_ckpt(args.ckpt)
        else:
            from openvoice_tpu_torch.ckpt.native_io import load_checkpoint

            conv.init_random()
            conv.set_model(load_checkpoint(args.ckpt, template=conv.model))
    else:
        print("[serve] no checkpoint — random weights", file=sys.stderr)
        conv.init_random()
    svc = VoiceService(conv, max_batch=args.batch, device=conv.device)
    httpd = serve(svc, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        _serve_until_interrupted()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        svc.close()
    return 0


def _serve_until_interrupted() -> None:
    """Block until Ctrl-C (a KeyboardInterrupt) or SIGTERM."""
    import signal
    import threading

    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()


def cmd_train(args) -> int:
    from openvoice_tpu_torch.runtime.multihost import initialize
    from openvoice_tpu_torch.training.loop import train

    topo = initialize(device=args.device)
    print(f"[train] process {topo.process_id}/{topo.num_processes}, {topo.global_device_count} devices")
    train(args.data_root, _load_cfg(args), steps=args.steps, batch_size=args.batch,
          segment_frames=args.segment_frames, adversarial=not args.no_gan, ckpt_dir=args.ckpt_dir,
          device=args.device)
    return 0


def cmd_extract_se(args) -> int:
    import numpy as np

    conv = _converter(args)
    if args.ckpt:
        conv.load_ckpt(args.ckpt)
    else:
        conv.init_random()
    se = conv.extract_se_from_file(args.audio, vad=not args.no_vad)
    out = args.out or "se.npy"
    np.save(out, se)
    print(f"SE {se.shape} → {out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="openvoice_tpu_torch.tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name: str, help_: str, fn, presets: list[str]):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--config")
        p.add_argument("--preset", default="v2", choices=presets)
        p.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card; 'cpu' must be asked for)")
        p.set_defaults(fn=fn)
        return p

    p = add("convert-ckpt", "torch .pth → native checkpoint directory", cmd_convert_ckpt, ["v1", "v2", "v1-tts"])
    p.add_argument("ckpt")
    p.add_argument("out_dir")

    p = add("serve", "start the HTTP serving tier", cmd_serve, ["v1", "v2"])
    p.add_argument("--ckpt")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--batch", type=int, default=8)

    p = add("train", "train the converter stack", cmd_train, ["v1", "v2"])
    p.add_argument("data_root")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--segment-frames", type=int, default=128)
    p.add_argument("--no-gan", action="store_true")
    p.add_argument("--ckpt-dir")

    p = add("extract-se", "speaker embedding from reference audio", cmd_extract_se, ["v1", "v2"])
    p.add_argument("audio")
    p.add_argument("--ckpt")
    p.add_argument("--out")
    p.add_argument("--no-vad", action="store_true")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
