"""Hand-written CUDA kernels of the PyTorch port and their wrappers.

Each kernel's source is ``openvoice_tpu_torch/csrc/<name>.cu``; `_nvcc`
builds it for sm_90a at first use and loads it with ctypes.  A module here
wraps one kernel: it checks its inputs, launches the kernel for CUDA tensors,
runs the plain PyTorch version for CPU tensors, and counts its launches.
"""

import threading

# held while a wrapper raises its module's ``launches`` count: the serving
# tier launches kernels from several threads, and ``+=`` on a module global
# is a read-modify-write the interpreter lock does not make atomic
LAUNCH_LOCK = threading.Lock()
