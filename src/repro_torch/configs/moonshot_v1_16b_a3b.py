"""moonshot-v1-16b-a3b [moe] — 48L d=2048 16H (GQA kv=16) d_ff=1408,
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]

A copy of ``src/repro/configs/moonshot_v1_16b_a3b.py``, field for field.
"""
from repro_torch.models.config import ArchConfig, HeatConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, moe_experts=64, moe_top_k=6,
    heat=HeatConfig(num_negatives=128, tile_size=4096),
)
