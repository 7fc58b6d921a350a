"""mamba2-370m [ssm] — 48L d=1024 (attn-free) vocab=50280, ssm_state=128.
SSD / state-space duality.  [arXiv:2405.21060; unverified]

A copy of ``src/repro/configs/mamba2_370m.py``, field for field.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)
