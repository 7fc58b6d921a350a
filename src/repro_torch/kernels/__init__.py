"""Hand-written CUDA kernels for Hopper (``../csrc``), their ctypes bindings
and their plain PyTorch versions.  Nothing here builds or loads a kernel at
import."""
