"""qwen2-vl-2b [vlm] — 28L d=1536 12H (GQA kv=2) d_ff=8960, vocab=151936,
M-RoPE; the vision frontend is a stub (the batch carries precomputed patch
embeddings; dynamic resolution fixed to 256 patches).  [arXiv:2409.12191; hf]

A copy of ``src/repro/configs/qwen2_vl_2b.py``, field for field.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, rope_mode="mrope", num_patches=256,
)
