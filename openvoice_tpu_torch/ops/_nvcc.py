"""Build and load the port's hand-written CUDA kernels.

Each source ``openvoice_tpu_torch/csrc/<name>.cu`` is compiled by nvcc for
``sm_90a`` into a shared library with a plain C interface and loaded with
ctypes; no PyTorch header is included, so a build takes seconds.  Libraries
are built at first use into ``openvoice_tpu_torch/csrc/build/`` (listed in
``.gitignore``) under a name that hashes the flags and every source and
header under ``csrc/``: the kernels share device code in headers
(``csrc/*.cuh``), so a change to any of them builds every library anew, and an
unchanged tree loads at once.  A stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def kernel_names() -> list[str]:
    """Every kernel source in the package, by name (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _sources() -> list[Path]:
    """Every source and header under ``csrc/``, outside ``build/``."""
    return sorted(p for p in CSRC.rglob("*")
                  if p.is_file() and BUILD_DIR not in p.parents and p.suffix in (".cu", ".cuh", ".h"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        digest.update(str(path.relative_to(CSRC)).encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns nvcc's
    report (registers, shared memory, spills per kernel), '' when cached."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
