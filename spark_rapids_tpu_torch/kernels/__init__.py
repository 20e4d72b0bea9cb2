"""Builder of the CUDA kernels in csrc/ (nvcc at first use, ctypes)."""
