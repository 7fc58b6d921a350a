"""HEAT on PyTorch and CUDA: the port of the JAX/Pallas package ``repro``
to one NVIDIA H100.

The layout mirrors ``src/repro/``; every Pallas kernel on a ported path is a
hand-written CUDA kernel for ``sm_90a`` under ``csrc/``, with a plain
PyTorch version beside it that CPU tensors run.  This package imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.
"""
