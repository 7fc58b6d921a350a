"""minitron-4b [dense] — 32L d=3072 24H (GQA kv=8) d_ff=9216, vocab=256000
(pruned nemotron).  [arXiv:2407.14679; hf]

A copy of ``src/repro/configs/minitron_4b.py``, field for field.
"""
from repro_torch.models.config import ArchConfig, HeatConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216,
    vocab=256000,
    heat=HeatConfig(num_negatives=128, tile_size=8192),
)
