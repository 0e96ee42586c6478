"""Demo: the fused text→cloned-audio chains — staged vs fused vs
single-dispatch vs streaming (the port's ``demos/demo_fused_chain.py``; no
reference counterpart; the reference runs the staged flow only,
openvoice_app.py:131-141).

Usage (random weights by default; pass checkpoints like v1_tts):
  python -m openvoice_tpu_torch.demos.fused_chain --text "..." --output-dir outputs/

Every chain runs in the bf16 serving mode (``fast=True``): the converter's
STFT, WaveNet, flow and decoder kernels and the TTS decode's.  Each time is
read after the card has finished.  With ``--tts-config`` the chains speak
in the config's first speaker (the JAX demo passes speaker id 0, which only
a TTS without a config takes).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from openvoice_tpu_torch.demos import clock


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m openvoice_tpu_torch.demos.fused_chain")
    ap.add_argument("--tts-ckpt", default=None)
    ap.add_argument("--tts-config", default=None)
    ap.add_argument("--converter-ckpt", default=None)
    ap.add_argument("--converter-config", default=None)
    ap.add_argument("--text", default=(
        "This sentence was synthesized and converted on a tensor processing "
        "unit in a single compiled graph. A second sentence streams in "
        "right behind the first one without waiting for the whole text."
    ))
    ap.add_argument("--output-dir", default="outputs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)

    from openvoice_tpu_torch.api import (
        BaseSpeakerTTS,
        ToneColorConverter,
        tts_convert_batched,
        tts_convert_single_dispatch,
        tts_convert_stream,
    )
    from openvoice_tpu_torch.audio.io import write_wav
    from openvoice_tpu_torch.config import V2_CONVERTER_CONFIG, v1_base_tts_config
    from openvoice_tpu_torch.text import default_symbols

    if args.tts_config:
        tts = BaseSpeakerTTS(config_path=args.tts_config, device=args.device)
        tts.load_ckpt(args.tts_ckpt)
        speaker = next(iter(tts.hps.speakers.keys()))
    else:
        tts = BaseSpeakerTTS(cfg=v1_base_tts_config(len(default_symbols)), device=args.device)
        tts.init_random(0)
        speaker = 0
        print("(random TTS weights — pass --tts-ckpt for real speech)")
    if args.converter_config:
        conv = ToneColorConverter(config_path=args.converter_config, device=tts.device)
        conv.load_ckpt(args.converter_ckpt)
    else:
        conv = ToneColorConverter(cfg=V2_CONVERTER_CONFIG, device=tts.device)
        conv.init_random(1)

    rng = np.random.default_rng(0)
    src_se = rng.standard_normal((1, conv.cfg.gin_channels, 1)).astype(np.float32)
    tgt_se = rng.standard_normal((1, conv.cfg.gin_channels, 1)).astype(np.float32)
    os.makedirs(args.output_dir, exist_ok=True)
    sr = conv.cfg.sampling_rate

    # two-stage fused: decode+STFT+convert per frame bucket
    t0 = clock(conv.device)
    fused = tts_convert_batched(tts, conv, args.text, speaker, src_se, tgt_se, fast=True)
    print(f"fused:           {len(fused)/sr:.2f}s audio "
          f"in {clock(conv.device)-t0:.2f}s wall (warm-up incl. packing the serving weights)")

    # single dispatch: the whole chain in one call per token bucket
    t0 = clock(conv.device)
    single = tts_convert_single_dispatch(tts, conv, args.text, speaker, src_se, tgt_se, fast=True)
    print(f"single-dispatch: {len(single)/sr:.2f}s audio "
          f"in {clock(conv.device)-t0:.2f}s wall")

    # streaming: audio arrives sentence by sentence
    t0 = clock(conv.device)
    chunks = []
    for k, chunk in enumerate(tts_convert_stream(tts, conv, args.text, speaker, src_se, tgt_se, fast=True)):
        print(f"stream chunk {k}: {len(chunk)/sr:.2f}s "
              f"at +{clock(conv.device)-t0:.2f}s")
        chunks.append(chunk)

    write_wav(os.path.join(args.output_dir, "demo_chain_single.wav"), single, sr)
    write_wav(os.path.join(args.output_dir, "demo_chain_stream.wav"), np.concatenate(chunks), sr)
    print(f"wrote {args.output_dir}/demo_chain_single.wav and _stream.wav")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
