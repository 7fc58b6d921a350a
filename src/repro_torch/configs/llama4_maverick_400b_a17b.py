"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) d_ff=8192,
vocab=202048, MoE 128 experts top-1.  [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]

moe_every=2 (llama4-style interleaved dense/MoE blocks): with every layer MoE
the listed dims give ~775B params, inconsistent with the 400B name; with
interleave the total is ~400B and the active path ~11B + attention — the
closest consistent reading of the assigned numbers.
fsdp=True: 400B bf16 params exceed one chip even at 1/16 model sharding.

A copy of ``src/repro/configs/llama4_maverick_400b_a17b.py``, field for field.
"""
from repro_torch.models.config import ArchConfig, HeatConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, moe_experts=128, moe_top_k=1, moe_every=2, fsdp=True,
    heat=HeatConfig(num_negatives=128, tile_size=4096),
)
