"""The harness takes up a new cell, traffic mix and per-layer metric as
added files alone: a copy of the benchmark gets them, no file that was
there changes but BENCHMARK.json (which lists them), and a run of the new
cell reports the new metric."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from ovbench import harness

ROOT = Path(__file__).resolve().parent.parent.parent

NEW_METRIC = '''"""Requests answered in the window (a test's metric)."""


def read(ctx):
    return float(len(ctx.completed))
'''

PROBE = '''
import json, sys, time
sys.path.insert(0, ".")
import torch
from ovbench import harness
from ovbench import run as RUN
from ovbench.tests import tiny
bench = json.load(open("BENCHMARK.json"))
cell = harness.load_cell("v2-convert-short", bench)
small = tiny.tiny_cell("v2-convert-f32")
cell.config = small.config
cell.mix.update(pool=3, seconds_min=0.05, seconds_mean=0.1, seconds_max=0.2, speakers=2)
cell.spec["limits"]["audio_rel_err"] = 1e-5
res = RUN.run_cell(cell, 7, 0.5, True, torch.device("cpu"), t_start=time.perf_counter())
print(json.dumps({"file": harness.__file__, "metrics": res["metrics"], "correct": res["correct"]}))
'''


def digest(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_are_added_files(tmp_path):
    shutil.copytree(ROOT / "ovbench", tmp_path / "ovbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    (tmp_path / "openvoice_tpu_torch").symlink_to(ROOT / "openvoice_tpu_torch")   # the program, as in a checkout
    before = digest(tmp_path / "ovbench")

    (tmp_path / "ovbench" / "traffic" / "short_clips.json").write_text(json.dumps(
        dict(json.loads((tmp_path / "ovbench" / "traffic" / "interactive.json").read_text()),
             seconds_mean=2.0, why="short clips")))
    (tmp_path / "ovbench" / "workloads" / "v2-convert-short.json").write_text(
        (tmp_path / "ovbench" / "workloads" / "v2-convert-f32.json").read_text())
    (tmp_path / "ovbench" / "metrics" / "answered.py").write_text(NEW_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "v2-convert-short", "config": "v2_converter_f32", "traffic": "short_clips",
                               "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "answered", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "serve", "moves": "audio_s_per_s",
                               "workloads": ["v2-convert-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digest(tmp_path / "ovbench")
    assert {k: v for k, v in after.items() if k in before} == before   # nothing that was there changed
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["file"].startswith(str(tmp_path))
    assert out["correct"] and out["metrics"]["answered"]["value"] > 0
    assert "graph_captures" not in out["metrics"]   # the existing metrics list the cells they read


def test_each_cell_reports_each_quantity_once_with_a_reader():
    """A metric split by cell (``p95_ms.<cell>``) reads as its base does,
    and no cell reports a quantity twice or moves a metric it lacks."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert harness.metric_reader(m["name"]) is harness.metric_reader(m["name"].split(".")[0])
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"] if harness.reports(m, w["name"])]
        layer = [m for m in bench["per_layer"] if harness.reports(m, w["name"])]
        assert len({n.split(".")[0] for n in e2e}) == len(e2e) and "setup_s" in e2e and len(e2e) >= 2
        assert len({m["name"].split(".")[0] for m in layer}) == len(layer) >= 1
        assert all(m["moves"] in e2e for m in layer)
