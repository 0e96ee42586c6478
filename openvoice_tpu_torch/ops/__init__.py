"""Hand-written CUDA kernels of the PyTorch port and their wrappers.

Each kernel's source is ``openvoice_tpu_torch/csrc/<name>.cu``; `_nvcc`
builds it for sm_90a at first use and loads it with ctypes.  A module here
wraps one kernel: it checks its inputs, launches the kernel for CUDA tensors,
runs the plain PyTorch version for CPU tensors, and counts its launches
(`count_launch`).
"""

import sys
import threading
from contextlib import contextmanager

# held while a module's ``launches`` count is raised: the serving tier
# launches kernels from several threads, and ``+=`` on a module global is a
# read-modify-write the interpreter lock does not make atomic
LAUNCH_LOCK = threading.Lock()

# the tally of the CUDA graph this thread is capturing (`recording_launches`)
_CAPTURE = threading.local()


def count_launch(module: str) -> None:
    """One launch of the kernel that wrapper module `module` (its
    ``__name__``) wraps: its ``launches`` count goes up by one.  While this
    thread captures a CUDA graph, the kernel is recorded into the graph and
    not launched: the launch goes to the capture's tally instead, which every
    replay of the graph adds (`add_launches`)."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:
        tally[module] = tally.get(module, 0) + 1
        return
    add_launches({module: 1})


def add_launches(tally: dict[str, int]) -> None:
    """Raise each wrapper module's ``launches`` count by its entry."""
    with LAUNCH_LOCK:
        for module, n in tally.items():
            sys.modules[module].launches += n


@contextmanager
def recording_launches():
    """Within: this thread's kernel launches are recorded into the yielded
    tally (module name → launches) and counted nowhere else."""
    if getattr(_CAPTURE, "tally", None) is not None:
        raise RuntimeError("a graph capture is already recording this thread's launches")
    tally: dict[str, int] = {}
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = None
