"""heatbench: the benchmark of the PyTorch and CUDA port of HEAT.

One command runs one cell once (``python heatbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``).  Cells, configurations, traffic
mixes, per-layer metrics and configuration kinds (``kinds/``: what a cell
runs, checks and counts) are found by name in ``BENCHMARK.json`` and in
files of their own under this folder, so a new one is a new file.  Nothing
here imports ``jax`` or the JAX package: the port (``repro_torch``) is the
system under test, and ``heatbench/reference/`` is the plain PyTorch model
that decides whether a run is correct.
"""
