"""zamba2-2.7b [hybrid] — 54L d=2560 32H (GQA kv=32) d_ff=10240, vocab=32000,
ssm_state=64; Mamba2 blocks + one shared attention block applied every 6
layers (weight sharing).  [arXiv:2411.15242; hf]

A copy of ``src/repro/configs/zamba2_2p7b.py``, field for field.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, ssm_state=64, ssm_head_dim=64, shared_attn_every=6,
)
