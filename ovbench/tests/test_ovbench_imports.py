"""The benchmark measures only the PyTorch port: no module of it imports JAX
or the JAX package, and its reference imports nothing of the port."""

import ast
from pathlib import Path

OVBENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "openvoice_tpu"}


def top_level_imports(path: Path) -> set[str]:
    """The top-level name (before the first dot) of every absolute import."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(OVBENCH)): top_level_imports(p) & FORBIDDEN for p in OVBENCH.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}
    # the port's name begins with the JAX package's: compared whole, it passes
    assert "openvoice_tpu_torch" in set().union(*(top_level_imports(p) for p in OVBENCH.rglob("*.py")))


def test_reference_imports_nothing_of_the_port():
    for p in (OVBENCH / "reference").rglob("*.py"):
        assert not top_level_imports(p) & (FORBIDDEN | {"openvoice_tpu_torch"}), p


def test_names_compare_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import openvoice_tpu_torch.api\nfrom openvoice_tpu.api import x\nimport jaxlib\n")
    assert top_level_imports(probe) == {"openvoice_tpu_torch", "openvoice_tpu", "jaxlib"}
