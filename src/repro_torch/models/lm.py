"""The language model — the port of ``src/repro/models/lm.py`` for the
dense and MoE families: training, and serving by ``prefill`` then
``decode_step`` against a KV cache.

Parameters are the reference's tree: nested dicts with the layers stacked on
a leading (L, ...) axis (``blocks/attn/wq`` is (L, d, Hq, hd)), so
checkpoints and ``convert.py`` use the reference's names.  The stack is a
Python loop over the layers: each stacked leaf is split once with
``unbind`` (whose backward stacks the layers' gradients in one op), and with
``remat="full"`` each block runs under ``torch.utils.checkpoint``, keeping
only the block inputs, as the reference's ``jax.checkpoint`` with
``nothing_saveable`` does.  An interleaved MoE stack (``moe_every > 1``,
llama4) runs in groups of ``moe_every - 1`` dense blocks and one MoE block,
with the reference's two stacks ``blocks/dense`` (G * (moe_every - 1), ...)
and ``blocks/moe_blk`` (G, ...).

Entry points:

- ``forward_train``: the next-token objective with the HEAT sampled-CCL
  head (``core/heat_head.py``) or the full-softmax baseline;
- ``prefill``: tokens -> (last-position logits, the cache of every layer's
  K/V in ``cache_dtype``);
- ``pad_cache``: grow the cache's sequence dimension for decoding;
- ``decode_step``: one token per sequence at a host-int position; the new
  K/V rows are written into the cache in place and the query attends in
  fp32.

``prefill`` and ``decode_step`` run without autograd, on the card unless
given ``device="cpu"``.  The SSM, hybrid, audio and VLM families wait for
later slices (:data:`WAITING_FAMILIES`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import mf, samplers
from repro_torch.core.heat_head import (
    HeatHeadConfig,
    full_softmax_loss,
    sampled_ccl_loss,
)
from repro_torch.core.tiling import gather_rows
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    KVCache,
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

FAMILIES = ("dense", "moe")

#: the reference's other families and the slice of the port that brings each.
WAITING_FAMILIES = {
    "ssm": "the SSM and hybrid slice (models/ssm.py and its MambaCache "
           "decode; ROADMAP.md A.6)",
    "hybrid": "the SSM and hybrid slice (models/ssm.py and its MambaCache "
              "decode; ROADMAP.md A.6)",
    "vlm": "the VLM slice (M-RoPE and patch inputs; ROADMAP.md A.6)",
    "audio": "the audio slice (cross-attention and the audio encoder; "
             "ROADMAP.md A.6)",
}


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """Runtime knobs (the reference's ``TrainOptions``).

    ``probs_dtype`` is the dtype of the attention probabilities times V,
    ``attn_acc_dtype`` that of the logits and the softmax (fp32 both by
    default; bf16 halves the attention intermediates' bytes).
    ``cache_dtype`` is the dtype ``prefill`` stores the K/V cache in.
    ``scan_unroll`` unrolls the reference's layer scans for its roofline
    harness; the port's stack is a Python loop over the layers, so it has
    no effect here and is kept so the two packages' options match."""

    loss: str = "heat"             # heat | softmax
    remat: str = "full"            # full | none
    attn_chunk: int = 1024
    probs_dtype: Any = torch.float32
    attn_acc_dtype: Any = torch.float32
    cache_dtype: Any = torch.bfloat16
    scan_unroll: bool = False


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family in FAMILIES:
        return
    if cfg.family in WAITING_FAMILIES:
        raise ValueError(f"family {cfg.family!r} waits for "
                         f"{WAITING_FAMILIES[cfg.family]}; the port runs "
                         f"{FAMILIES}")
    raise ValueError(f"unknown family {cfg.family!r}")


def _norm_def(n_layers: int, d: int) -> ParamDef:
    lead = (n_layers,) if n_layers else ()
    return ParamDef(lead + (d,), "ones")


def _dense_block_defs(cfg: ArchConfig, L: int) -> dict:
    return {"ln1": _norm_def(L, cfg.d_model), "ln2": _norm_def(L, cfg.d_model),
            "attn": attn_defs(cfg, L), "mlp": mlp_defs(cfg, L)}


def _moe_block_defs(cfg: ArchConfig, L: int) -> dict:
    return {"ln1": _norm_def(L, cfg.d_model), "ln2": _norm_def(L, cfg.d_model),
            "attn": attn_defs(cfg, L), "moe": moe_mod.moe_defs(cfg, L)}


def num_groups(cfg: ArchConfig) -> int:
    """The reference's scan length: the layers, or the groups of an
    interleaved MoE stack (hybrid groups wait for their family)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "moe" and cfg.moe_every > 1:
        return cfg.n_layers // cfg.moe_every
    return cfg.n_layers


def layers_per_group(cfg: ArchConfig) -> int:
    """Layers per group (``n_layers / num_groups``)."""
    return cfg.n_layers // num_groups(cfg)


def _interleaved(cfg: ArchConfig) -> bool:
    return cfg.family == "moe" and cfg.moe_every > 1


def model_defs(cfg: ArchConfig) -> dict:
    """The architecture's ParamDef tree."""
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab
    defs = {"embed": ParamDef((v, d), "normal", 0.02),
            "final_norm": _norm_def(0, d)}
    if not cfg.tie_embeddings:
        defs["out_embed"] = ParamDef((v, d), "normal", 0.02)
    if _interleaved(cfg):
        g = num_groups(cfg)
        defs["blocks"] = {"dense": _dense_block_defs(cfg, g * (cfg.moe_every - 1)),
                          "moe_blk": _moe_block_defs(cfg, g)}
    elif cfg.family == "moe":
        defs["blocks"] = _moe_block_defs(cfg, cfg.n_layers)
    else:
        defs["blocks"] = _dense_block_defs(cfg, cfg.n_layers)
    return defs


def init_params(key: int, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> dict:
    """Materialize :func:`model_defs` from the integer key on ``device``
    (the card unless the caller names another)."""
    return materialize(key, model_defs(cfg), dtype, mf.resolve_device(device))


def _positions(batch: int, seq: int, device, start: int = 0):
    """(B, S) positions ``start .. start + S - 1`` (standard RoPE; M-RoPE
    waits for the VLM family)."""
    return (torch.arange(seq, device=device) + start)[None].expand(batch, seq)


def _attn_block(lp: dict, h, cos, sin, cfg: ArchConfig, opts: TrainOptions,
                *, moe: bool, cache: Optional[KVCache] = None,
                pos: Optional[int] = None):
    """Pre-norm attention + (MLP | MoE) with residuals; returns ``(h, kv)``
    (:func:`~repro_torch.models.layers.attn_apply`'s ``kv``)."""
    a, kv = attn_apply(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps), cos,
                       sin, cfg, causal=True, cache=cache, pos=pos,
                       attn_chunk=opts.attn_chunk,
                       probs_dtype=opts.probs_dtype,
                       acc_dtype=opts.attn_acc_dtype)
    h = h + a
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    out = moe_mod.moe_apply(lp["moe"], hn, cfg) if moe else mlp_apply(
        lp["mlp"], hn, cfg)
    return h + out, kv


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


def _stack_plan(params: dict, cfg: ArchConfig) -> list:
    """The layers in order as ``(layer params, is MoE, cache member, row)``:
    the row of the layer's K/V in member ``0`` (the only one, or the dense
    layers' of an interleaved stack) or ``1`` (its MoE layers')."""
    blocks = params["blocks"]
    if not _interleaved(cfg):
        moe = cfg.family == "moe"
        return [(lp, moe, 0, i)
                for i, lp in enumerate(_layers(blocks, cfg.n_layers))]
    g, nd = num_groups(cfg), cfg.moe_every - 1
    dense = _layers(blocks["dense"], g * nd)
    moe_blk = _layers(blocks["moe_blk"], g)
    plan = []
    for gi in range(g):
        plan += [(dense[gi * nd + i], False, 0, gi * nd + i) for i in range(nd)]
        plan.append((moe_blk[gi], True, 1, gi))
    return plan


def _kv_rows(cfg: ArchConfig) -> list[int]:
    """Layers in each cache member: ``[L]``, or ``[G * (moe_every - 1), G]``
    for an interleaved MoE stack."""
    if _interleaved(cfg):
        g = num_groups(cfg)
        return [g * (cfg.moe_every - 1), g]
    return [cfg.n_layers]


def _run_stack(params: dict, h, cfg: ArchConfig, opts: TrainOptions,
               mode: str = "train", cache=None, pos: Optional[int] = None):
    """The layer stack, then the final norm; returns ``(h, cache)``.

    ``mode``: ``train`` (no cache; the cache is None), ``prefill`` (every
    layer's fresh K/V collected into a new :class:`DecodeCache` in
    ``opts.cache_dtype``) or ``decode`` (h is (B, 1, d) at the host int
    ``pos``; each layer writes its K/V row into ``cache`` in place, which
    is returned)."""
    _check_family(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}; available: train, prefill, "
                         "decode")
    b, s = h.shape[0], h.shape[1]
    decode = mode == "decode"
    cos, sin = rope_cos_sin(_positions(b, s, h.device, pos if decode else 0),
                            cfg.head_dim, cfg.rope_theta)
    plan = _stack_plan(params, cfg)

    if mode == "train":
        bodies = {moe: _maybe_remat(
            lambda lp, x, moe=moe: _attn_block(lp, x, cos, sin, cfg, opts,
                                               moe=moe)[0], opts)
            for moe in (False, True)}
        for lp, moe, _, _ in plan:
            h = bodies[moe](lp, h)
        return rms_norm(h, params["final_norm"], cfg.norm_eps), None

    if decode:
        members = list(cache.kv) if _interleaved(cfg) else [cache.kv]
    else:
        shape = (b, s, cfg.n_kv_heads, cfg.head_dim)
        members = [KVCache(*(torch.empty((n,) + shape, dtype=opts.cache_dtype,
                                         device=h.device) for _ in range(2)))
                   for n in _kv_rows(cfg)]
    for lp, moe, m, row in plan:
        layer_kv = KVCache(members[m].k[row], members[m].v[row])
        h, kv = _attn_block(lp, h, cos, sin, cfg, opts, moe=moe,
                            cache=layer_kv if decode else None, pos=pos)
        if not decode:                 # prefill: collect, cast to cache_dtype
            layer_kv.k.copy_(kv.k)
            layer_kv.v.copy_(kv.v)
    kv = tuple(members) if _interleaved(cfg) else members[0]
    new_cache = cache._replace(kv=kv) if decode else DecodeCache(kv=kv)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), new_cache


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
    h, _ = _run_stack(params, h, cfg, opts)
    return head_loss(params, h[:, :-1], labels, cfg, opts, rng, tile)


class DecodeCache(NamedTuple):
    """The decode cache (the reference's, with ``None`` where it keeps
    ``()`` placeholders).  ``kv``: a :class:`KVCache` of (L, B, S, Hkv, hd)
    tensors, or for an interleaved MoE stack the pair (dense layers'
    (G * (moe_every - 1), B, S, Hkv, hd), MoE layers' (G, B, S, Hkv, hd)).
    ``mamba``, ``shared_kv`` and ``cross_kv`` wait for the SSM, hybrid and
    audio families."""

    kv: Any = None
    mamba: Any = None
    shared_kv: Any = None
    cross_kv: Any = None


def cache_defs(cfg: ArchConfig, batch: int, seq: int) -> DecodeCache:
    """The decode cache's ParamDefs (zeros) for ``batch`` sequences of
    ``seq`` positions, in the layout :func:`prefill` returns."""
    if cfg.family in ("ssm", "hybrid", "audio"):
        raise ValueError(f"the {cfg.family!r} decode cache waits for "
                         f"{WAITING_FAMILIES[cfg.family]}")
    _check_family(cfg)
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    kv = [KVCache(ParamDef((n,) + shape, "zeros"), ParamDef((n,) + shape, "zeros"))
          for n in _kv_rows(cfg)]
    return DecodeCache(kv=tuple(kv) if _interleaved(cfg) else kv[0])


def pad_cache(cache: DecodeCache, cfg: ArchConfig, max_len: int) -> DecodeCache:
    """Grow the K/V caches' sequence dimension (dim 2 of (L, B, S, Hkv, hd))
    to ``max_len`` with zero rows: the prefill -> decode handoff.  A cache
    already that long is returned as it is."""
    def pad(a):
        extra = max_len - a.shape[2]
        return a if extra <= 0 else F.pad(a, (0, 0, 0, 0, 0, extra))

    def pad_kv(kvc):
        return None if kvc is None else KVCache(pad(kvc.k), pad(kvc.v))

    kv = cache.kv
    if isinstance(kv, tuple) and len(kv) == 2 and isinstance(kv[0], KVCache):
        kv = (pad_kv(kv[0]), pad_kv(kv[1]))          # interleaved-MoE layout
    else:
        kv = pad_kv(kv)
    return cache._replace(kv=kv, shared_kv=pad_kv(cache.shared_kv))


def _entry_device(params: dict, device) -> torch.device:
    """The device a serving call runs on (the card unless ``device`` names
    another; raises where there is none), which must hold the parameters."""
    dev = mf.resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"the parameters are on {params['embed'].device}, "
                         f"the call runs on {dev}: pass device= to match")
    return dev


def prefill(params: dict, batch: dict, cfg: ArchConfig,
            opts: TrainOptions = TrainOptions(), *, device=None):
    """Full-prompt pass: ``batch["tokens"]`` (B, S) -> (last-position
    logits (B, V), the primed :class:`DecodeCache` (S positions, in
    ``opts.cache_dtype``)).  Runs without autograd on ``device``."""
    dev = _entry_device(params, device)
    with torch.no_grad():
        h = embed_inputs(params, {"tokens": batch["tokens"].to(dev)}, cfg)
        h, cache = _run_stack(params, h, cfg, opts, "prefill")
        logits = h[:, -1] @ _out_table(params, cfg).T
    return logits, cache


def decode_step(params: dict, cache: DecodeCache, token, pos: int,
                cfg: ArchConfig, opts: TrainOptions = TrainOptions(), *,
                device=None):
    """One decoding step: ``token`` (B, 1) at position ``pos`` (a host int;
    a 0-d tensor is read back once) -> (logits (B, 1, V), the cache with
    the new K/V rows written in place).  Runs without autograd on
    ``device``."""
    dev = _entry_device(params, device)
    pos = int(pos)
    kv = cache.kv[0] if _interleaved(cfg) else cache.kv
    if not 0 <= pos < kv.k.shape[2]:
        raise ValueError(f"position {pos} is outside the cache's "
                         f"{kv.k.shape[2]} rows (pad_cache grows it)")
    with torch.no_grad():
        h = params["embed"][token.to(dev)]
        h, cache = _run_stack(params, h, cfg, opts, "decode", cache=cache,
                              pos=pos)
        logits = h @ _out_table(params, cfg).T
    return logits, cache
