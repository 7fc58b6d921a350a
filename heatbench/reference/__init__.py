"""The plain reference of the benchmark's MF cells: plain PyTorch in fp32
(TF32 off), importing nothing of the port, the JAX package or JAX.

``rng`` holds the stated key mix and the draws of a HEAT MF step (the
batch, the tile, the negatives, the rounding noise) as the port makes them,
so both sides see the same ids and noise from one seed; ``mf`` works the
first steps of a run out again from the seed and the benchmark's dataset.
"""
