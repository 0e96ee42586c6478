"""A whole run of each cell at a tiny size on the CPU, past the harness's
look for a card: the result line's keys, the check passing on the program
as it is, and failing with the timed path broken underneath (a group's
rows left out; an answer altered where it is produced)."""

import json
import time

import numpy as np
import pytest
import torch

from ovbench import run as RUN
from ovbench.tests.tiny import tiny_cell

CELLS = ["v2-batcher-backlog", "v1-chain-interactive", "v2-convert-interactive", "v2-convert-f32"]
# the tiny cells' limits (the cells' own are set from full-width readings
# on the card): a bf16 answer within 4 times its reference twin's distance
# from float32, an f32 one within 1e-5 of it
TINY_LIMITS = {"audio_err_ratio": 4.0, "audio_err_ratio_pooled": 4.0, "audio_rel_err": 1e-5}


def tiny_limits(cell) -> dict:
    return {k: TINY_LIMITS.get(k, v) for k, v in cell.spec["limits"].items()}


def tiny_run(name, seconds=1.0, trace=False):
    torch.set_num_threads(2)
    cell = tiny_cell(name, clients=2 if "batcher" in name else None)
    cell.spec["limits"] = tiny_limits(cell)
    return RUN.run_cell(cell, 2 ** 40 + 3, seconds, trace, torch.device("cpu"), t_start=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = tiny_run(name)
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(res)[-1] == "checks"
    assert res["failed"] == 0 and res["attempted"] > 0
    reported = {m["name"] for m in tiny_cell(name).end_to_end}
    assert set(res["metrics"]) == reported and {m.split(".")[0] for m in reported} == {
        "audio_s_per_s", "p50_ms", "p95_ms", "setup_s"}
    json.dumps(res)


def test_traced_run_reads_per_layer_metrics():
    res = tiny_run("v2-batcher-backlog", trace=True)
    assert res["correct"]
    assert {"batch_rows", "dispatch_share", "graph_captures", "mfu"} - {"mfu"} <= set(res["metrics"])
    assert "audio_s_per_s" not in res["metrics"] and "breakdown" in res


def test_half_of_a_group_left_out_fails(monkeypatch):
    from openvoice_tpu_torch.serve import batcher as B

    wire = B._wire_int16

    def half(audio):
        out = wire(audio)
        out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(B, "_wire_int16", half)
    res = tiny_run("v2-batcher-backlog")
    assert not res["correct"]


@pytest.mark.parametrize("name,site", [("v2-batcher-backlog", "batcher"), ("v2-convert-interactive", "convert"),
                                       ("v2-convert-f32", "convert"), ("v1-chain-interactive", "chain")])
def test_altered_answer_fails(monkeypatch, name, site):
    """Each answer altered by 10 % where the program produces it."""
    from openvoice_tpu_torch import api
    from openvoice_tpu_torch.serve import batcher as B

    if site == "batcher":
        body = B.group_body
        monkeypatch.setattr(B, "group_body", lambda *a, **k: (body(*a, **k).float() * 0.9).to(torch.int16))
    elif site == "convert":
        body = api.convert_body
        monkeypatch.setattr(api, "convert_body", lambda *a, **k: body(*a, **k) * 0.9)
    else:
        body = api.tts_decode_convert_body

        def altered(*a, **k):
            audio, frames = body(*a, **k)
            return audio * 0.9, frames

        monkeypatch.setattr(api, "tts_decode_convert_body", altered)
    res = tiny_run(name)
    assert not res["correct"]
    assert any(c["limit"] is not None and c["value"] > c["limit"] for c in res["checks"].values())


def test_a_checkout_without_the_program_exits_nonzero(tmp_path):
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    root = Path(RUN.__file__).resolve().parent.parent
    shutil.copytree(root / "ovbench", tmp_path / "ovbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "ovbench/run.py", "--workload", "v2-convert-f32", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip().endswith("}")
