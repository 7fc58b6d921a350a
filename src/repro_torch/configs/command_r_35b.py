"""command-r-35b [dense] — 40L d=8192 64H (GQA kv=8) d_ff=22528, vocab=256000
(GQA, no-bias).  [hf:CohereForAI/c4ai-command-r-v01; unverified]

A copy of ``src/repro/configs/command_r_35b.py``, field for field.
"""
from repro_torch.models.config import ArchConfig, HeatConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528,
    vocab=256000, use_bias=False,
    heat=HeatConfig(num_negatives=128, tile_size=8192),
)
