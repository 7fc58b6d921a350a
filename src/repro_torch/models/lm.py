"""The dense language model in train mode — the port of the train path of
``src/repro/models/lm.py``.

Parameters are the reference's tree: nested dicts with the layers stacked on
a leading (L, ...) axis (``blocks/attn/wq`` is (L, d, Hq, hd)), so
checkpoints and ``convert.py`` use the reference's names.  The stack is a
Python loop over the layers: each stacked leaf is split once with
``unbind`` (whose backward stacks the layers' gradients in one op), and with
``remat="full"`` each block runs under ``torch.utils.checkpoint``, keeping
only the block inputs, as the reference's ``jax.checkpoint`` with
``nothing_saveable`` does.  ``forward_train`` is the next-token objective
with the HEAT sampled-CCL head (``core/heat_head.py``) or the full-softmax
baseline.  ``prefill``/``decode_step`` and the other families (MoE, SSM,
hybrid, audio, VLM) wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import samplers
from repro_torch.core.heat_head import (
    HeatHeadConfig,
    full_softmax_loss,
    sampled_ccl_loss,
)
from repro_torch.core.tiling import gather_rows
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    attn_apply,
    attn_defs,
    mlp_apply,
    mlp_defs,
    rms_norm,
    rope_cos_sin,
)
from repro_torch.models.params import (
    ParamDef,
    materialize,
    tree_from_items,
    tree_items,
)

FAMILIES = ("dense",)


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """Runtime knobs of the train path (the reference's ``TrainOptions``;
    the attention probabilities and accumulation stay fp32)."""

    loss: str = "heat"             # heat | softmax
    remat: str = "full"            # full | none
    attn_chunk: int = 1024


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"family {cfg.family!r} waits for a later slice of the port "
            f"(ROADMAP.md, queue A); the port trains {FAMILIES}")


def _norm_def(n_layers: int, d: int) -> ParamDef:
    lead = (n_layers,) if n_layers else ()
    return ParamDef(lead + (d,), "ones")


def model_defs(cfg: ArchConfig) -> dict:
    """The dense architecture's ParamDef tree."""
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab
    defs = {"embed": ParamDef((v, d), "normal", 0.02),
            "final_norm": _norm_def(0, d),
            "blocks": {"ln1": _norm_def(cfg.n_layers, d),
                       "ln2": _norm_def(cfg.n_layers, d),
                       "attn": attn_defs(cfg, cfg.n_layers),
                       "mlp": mlp_defs(cfg, cfg.n_layers)}}
    if not cfg.tie_embeddings:
        defs["out_embed"] = ParamDef((v, d), "normal", 0.02)
    return defs


def init_params(key: int, cfg: ArchConfig, dtype=torch.float32,
                device="cpu") -> dict:
    """Materialize :func:`model_defs` on ``device`` from the integer key."""
    return materialize(key, model_defs(cfg), dtype, device)


def _positions(batch: int, seq: int, device):
    """(B, S) positions ``0 .. S - 1`` (standard RoPE, train mode)."""
    return torch.arange(seq, device=device)[None].expand(batch, seq)


def _attn_block(lp: dict, h, cos, sin, cfg: ArchConfig, opts: TrainOptions):
    """Pre-norm attention + MLP with residuals."""
    a = attn_apply(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps), cos, sin,
                   cfg, causal=True, attn_chunk=opts.attn_chunk)
    h = h + a
    return h + mlp_apply(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)


def _maybe_remat(fn, opts: TrainOptions):
    """``remat="full"``: recompute the block in the backward and keep only
    its inputs; ``"none"``: keep every activation."""
    if opts.remat == "full":
        def remat(*args):
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return remat
    if opts.remat != "none":
        raise ValueError(f"unknown remat {opts.remat!r}; available: full, none")
    return fn


def _layers(blocks: dict, n_layers: int) -> list[dict]:
    """The stacked (L, ...) block tree as L per-layer trees (one ``unbind``
    per leaf)."""
    items = [(path, leaf.unbind(0)) for path, leaf in tree_items(blocks)]
    return [tree_from_items([(path, parts[i]) for path, parts in items])
            for i in range(n_layers)]


def _run_stack(params: dict, h, cfg: ArchConfig, opts: TrainOptions):
    """The dense stack in train mode, then the final norm."""
    _check_family(cfg)
    b, s = h.shape[0], h.shape[1]
    cos, sin = rope_cos_sin(_positions(b, s, h.device), cfg.head_dim,
                            cfg.rope_theta)

    def block(lp, x):
        return _attn_block(lp, x, cos, sin, cfg, opts)

    body = _maybe_remat(block, opts)
    for lp in _layers(params["blocks"], cfg.n_layers):
        h = body(lp, h)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def embed_inputs(params: dict, batch: dict, cfg: ArchConfig):
    """Token embedding lookup (deterministic backward)."""
    return gather_rows(params["embed"], batch["tokens"])


def _out_table(params: dict, cfg: ArchConfig):
    return params["embed"] if cfg.tie_embeddings else params["out_embed"]


def head_loss(params: dict, h, labels, cfg: ArchConfig, opts: TrainOptions,
              rng: int, tile: Optional[samplers.TileState], mask=None):
    """Output-head loss: the CCL sampled head when enabled, else full-softmax
    cross entropy; returns ``(loss, new_tile)``."""
    table = _out_table(params, cfg)
    if opts.loss == "heat" and cfg.heat.enabled:
        hcfg = HeatHeadConfig(num_negatives=cfg.heat.num_negatives,
                              mu=cfg.heat.mu, theta=cfg.heat.theta,
                              tile_size=cfg.heat.tile_size,
                              refresh_interval=cfg.heat.refresh_interval,
                              backend=cfg.heat.backend, sampler=cfg.heat.sampler)
        return sampled_ccl_loss(h, labels, table, rng, hcfg, tile, mask)
    if opts.loss not in ("heat", "softmax"):
        raise ValueError(f"unknown loss {opts.loss!r}; available: heat, softmax")
    return full_softmax_loss(h, labels, table, mask), tile


def forward_train(params: dict, batch: dict, cfg: ArchConfig,
                  opts: TrainOptions, rng: int,
                  tile: Optional[samplers.TileState] = None):
    """batch: ``tokens`` (B, S).  Next-token objective; returns
    ``(loss, new_tile)``."""
    labels = batch["tokens"][:, 1:]
    h = embed_inputs(params, batch, cfg)
    h = _run_stack(params, h, cfg, opts)
    return head_loss(params, h[:, :-1], labels, cfg, opts, rng, tile)
