"""Tiny cells for the CPU tests: the benchmark's own cells with the widths,
clip lengths and pool cut down until a run takes seconds on the CPU."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from ovbench import harness

ROOT = Path(__file__).resolve().parent.parent

# every serving-mode route of the port at a tiny size: stage 0 a stock
# transposed conv and K3's plain version, stages 1-2 K4's (hop = upsample)
CONVERTER = dict(
    n_speakers=0, zero_g=True, spec_channels=65, filter_length=128, hop_length=16, win_length=128,
    inter_channels=32, hidden_channels=32, upsample_initial_channel=256, upsample_rates=[4, 2, 2],
    upsample_kernel_sizes=[8, 4, 4], resblock_kernel_sizes=[3, 7], resblock_dilation_sizes=[[1, 3], [1, 3]],
    gin_channels=32, enc_q_layers=4, flow_wn_layers=2, sampling_rate=22050)
TTS = dict(CONVERTER, n_vocab=87, n_speakers=4, zero_g=False, filter_channels=64, n_heads=2, n_layers=2,
           enc_q_layers=2, add_blank=True)


def tiny_cell(name: str, clients: int | None = None) -> harness.Cell:
    """The cell `name` of BENCHMARK.json at a tiny size."""
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cell = harness.load_cell(name, bench)
    cell = copy.deepcopy(cell)
    config = cell.config
    if "tts" in config:
        config["tts"], config["converter"] = dict(TTS), dict(CONVERTER, zero_g=False)
        cell.mix.update(pool=4, words_per_second=0.5, max_chars=60, styles=4, speakers=3)
    else:
        config["model"] = dict(CONVERTER)
        cell.mix.update(pool=6, seconds_min=0.05, seconds_mean=0.15, seconds_max=0.4, speakers=3)
    config["weights"] = {"conv_post_gain": {"model": 30.0, "tts": 30.0, "converter": 30.0}}
    if clients is not None:
        cell.mix["clients"] = clients
    return cell
