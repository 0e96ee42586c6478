"""The PyTorch port's package rules: it imports neither JAX nor the JAX
package, it never hides the device (no silent CPU path), and it refuses the
serving mode whose kernels are not ported yet."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from openvoice_tpu_torch.api import ToneColorConverter
from tests._torch_port import TINY, torch_cfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "openvoice_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists()
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "openvoice_tpu"), f"{path.name} imports {name}"


def test_converter_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ToneColorConverter(cfg=torch_cfg(TINY))


def test_serving_mode_is_refused_until_its_kernels_exist():
    tc = ToneColorConverter(cfg=torch_cfg(TINY), device="cpu")
    tc.init_random(0)
    with pytest.raises(NotImplementedError, match="slice 2"):
        tc.convert(np.zeros(4000, np.float32), np.zeros(64), np.zeros(64), fast=True)
