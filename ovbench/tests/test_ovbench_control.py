"""The control of each cell's comparison fails it: the reference in the
precision below the configuration's (fp8 products for a bf16 cell, TF32 for
an f32 one, and for the chain's f32 text side), put in the program's place
and judged as a run judges the program.

On the CPU at a tiny size against the tiny runs' limit; on the card
(marked ``cuda``) at the cell's own size against the cell's limit, on three
seeds."""

import json
from pathlib import Path

import pytest
import torch

from ovbench import harness
from ovbench.tests.test_ovbench_run import CELLS, tiny_limits
from ovbench.tests.tiny import tiny_cell
from ovbench.traffic import Traffic

ROOT = Path(__file__).resolve().parent.parent.parent


def control_reading(cell, seed, device):
    fields = cell.config.get("model") or cell.config["converter"]
    traffic = Traffic(cell.mix, seed, int(fields["gin_channels"]), int(fields["sampling_rate"]))
    driver = harness.driver_class(cell.spec["driver"])(cell.spec, cell.config, traffic, seed, device)
    sample = harness.draw_sample(traffic, set(range(len(traffic.pool))), seed)
    items = [traffic.pool[i] for i in sample]
    return harness.judge(driver, items, harness.control_outputs(driver, items))


def fails(numbers, limits):
    return any(limits[k] is not None and numbers[k] > limits[k] for k in numbers if k in limits)


@pytest.mark.parametrize("name", [c for c in CELLS if c != "v2-convert-f32"])
def test_control_fails_tiny_bf16(name):
    """At a tiny size TF32 is no lower precision on the CPU (it has none), so
    only the bf16 cells' fp8 control is checked here."""
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    assert fails(control_reading(cell, 11, torch.device("cpu")), tiny_limits(cell))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_full_size(name, cuda_device):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(name, bench)
    for seed in (101, 2 ** 32 + 5, 987654321):
        assert fails(control_reading(cell, seed, cuda_device), cell.spec["limits"]), seed
