"""The JAX package's demos (``demos/demo_*.py``) on the port, one module each:

  python -m openvoice_tpu_torch.demos.v2_conversion --source a.wav --reference b.mp3
  python -m openvoice_tpu_torch.demos.v1_tts [--reference b.mp3]
  python -m openvoice_tpu_torch.demos.external_tts --sources a.wav b.wav --reference c.mp3
  python -m openvoice_tpu_torch.demos.fused_chain
  python -m openvoice_tpu_torch.demos.watermark_robustness [--audio x.wav]

Each takes its JAX demo's flags and defaults, plus ``--device`` (default: the
CUDA card; the CPU must be asked for with ``--device cpu``), and makes the
same API calls.  Without a checkpoint it runs on random weights
(``init_random``), as a smoke test of the pipeline.  `main(argv)` returns the
exit code, so that it can be called in process.
"""

from __future__ import annotations

import time

import torch


def clock(device: torch.device) -> float:
    """``time.perf_counter()`` once the card has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
