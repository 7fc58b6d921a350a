"""whisper-medium [audio] — enc-dec, 24L each side, d=1024 16H d_ff=4096,
vocab=51865; the conv frontend is a stub (the batch carries precomputed
frame embeddings, 1500 frames).  [arXiv:2212.04356; unverified]

A copy of ``src/repro/configs/whisper_medium.py``, field for field.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, encoder_layers=24, encoder_seq=1500, mlp_kind="gelu",
)
