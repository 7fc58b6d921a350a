"""The paper's own model family: MF-based CF with CCL (SimpleX/HEAT) — copies
of the reference's configs (``src/repro/configs/heat_mf.py``), so a config
name means the same model in both packages.
"""
import dataclasses

from repro_torch.core.mf import MFConfig

# Paper-scale (Amazon Product Reviews, Table 3), with behavior aggregation
# (history_len=100; the synthetic dataset's 16 train columns cap the history
# at 16).  Runs in the port; with table_format="int8" its training carry is
# about 8 GB, so it fits one H100.
AMAZON = MFConfig(num_users=20_980_000, num_items=9_350_000, emb_dim=128,
                  num_negatives=64, history_len=100, tile_size=1024,
                  refresh_interval=4096,
                  backend="fused", update_impl="scatter_add", sampler="auto")

# ~100M-parameter end-to-end config: (400k + 400k) * 128 ≈ 102M.
MF_100M = MFConfig(num_users=400_000, num_items=400_000, emb_dim=128,
                   num_negatives=64, history_len=0, tile_size=1024,
                   refresh_interval=2048,
                   backend="fused", update_impl="scatter_add")

# Kernel-path variant: the fused CCL forward/backward kernels and the
# gather-FMA row update (in the port: the CUDA kernels under csrc/).
MF_100M_PALLAS = dataclasses.replace(MF_100M, backend="pallas",
                                     update_impl="pallas")
