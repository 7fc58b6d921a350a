"""Architecture and run-shape configuration dataclasses: a copy of
``src/repro/models/config.py`` (the port imports nothing of ``repro``), so a
config means the same model in both packages.

One :class:`ArchConfig` per architecture lives in ``configs/<id>.py`` with
the published numbers; ``reduced()`` gives the tiny same-family config the
CPU tests run.  :class:`ShapeConfig` names the four run shapes.  The port
runs the dense, MoE, SSM, hybrid and VLM families so far; the audio
family's fields are kept so the two packages' configs stay field for field
the same.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HeatConfig:
    """HEAT technique knobs for the LM head (DESIGN.md §4)."""

    enabled: bool = True
    num_negatives: int = 64
    mu: float = 1.0
    theta: float = 0.0
    tile_size: int = 2048
    refresh_interval: int = 1024
    # Unified engine selection (core/engine.py): loss implementation and
    # negative-sampling strategy, shared with the MF core's registries.
    backend: str = "fused"
    sampler: str = "auto"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One model architecture: family, depth/width, head and HEAT knobs."""
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # MoE.  moe_every=2 -> llama4-style interleave (dense, moe, dense, ...):
    # structured as scan groups of (moe_every-1) dense blocks + 1 MoE block so
    # compiled FLOPs reflect exactly the active path (no masked dual compute).
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    # ZeRO-3/FSDP weight sharding over the data axis (params too big for one
    # chip's HBM after model-axis sharding alone).
    fsdp: bool = False
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    # Hybrid (zamba2): one shared attention block applied every k mamba blocks
    shared_attn_every: int = 0
    # Enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0           # precomputed frame embeddings (stub frontend)
    # VLM (qwen2-vl)
    num_patches: int = 0           # precomputed patch embeddings (stub frontend)
    rope_mode: str = "standard"    # standard | mrope
    # Sharding strategy knobs (hillclimb surface, EXPERIMENTS.md §Perf)
    attn_tp: bool = True           # False: replicate attention weights (tiny
                                   # models where TP collectives dominate)
    opt_bf16_step: bool = False    # bf16 optimizer-step gather (ZeRO-1)
    # Misc
    mlp_kind: str = "swiglu"       # swiglu | gelu
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # HEAT head
    heat: HeatConfig = HeatConfig()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch hold a 500k-token context? SSM: constant state.
        Hybrid: state + KV only in the (few) shared attention blocks."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are (or contain) decoders

    def supports_shape(self, shape_name: str) -> bool:
        if shape_name == "long_500k":
            return self.sub_quadratic
        return True

    def skip_reason(self, shape_name: str) -> Optional[str]:
        if shape_name == "long_500k" and not self.sub_quadratic:
            return ("full attention: 500k-token decode needs sub-quadratic "
                    "sequence mixing (DESIGN.md §4)")
        return None

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            moe_experts=min(self.moe_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=8,
            shared_attn_every=2 if self.shared_attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=16 if self.encoder_seq else 0,
            num_patches=8 if self.num_patches else 0,
            heat=dataclasses.replace(self.heat, num_negatives=8, tile_size=64,
                                     refresh_interval=4),
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One training shape: sequence length, global batch, parallelism."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
