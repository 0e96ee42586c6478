"""Hand-written CUDA kernels of the PyTorch port and their wrappers.

Each kernel's source is ``openvoice_tpu_torch/csrc/<name>.cu``; `_nvcc`
builds it for sm_90a at first use and loads it with ctypes.  A module here
wraps one kernel: it checks its inputs, launches the kernel for CUDA tensors,
runs the plain PyTorch version for CPU tensors, and counts its launches.
"""
