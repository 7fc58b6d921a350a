"""smollm-360m [dense] — 32L d=960 15H (GQA kv=5) d_ff=2560, vocab=49152
(llama-arch small): a copy of ``src/repro/configs/smollm_360m.py``."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab=49152,
)
