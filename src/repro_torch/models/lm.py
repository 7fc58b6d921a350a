"""The language model — the port of ``src/repro/models/lm.py`` for the
dense, MoE, SSM (Mamba2), hybrid (Zamba2), VLM (Qwen2-VL) and audio
(Whisper) families: training, and serving by ``prefill`` then
``decode_step`` against a KV cache, a Mamba state cache, or both.

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
and ``blocks/moe_blk`` (G, ...).  An SSM stack is L Mamba blocks
(``blocks/{ln, mamba}``); a hybrid stack runs in groups of
``shared_attn_every`` Mamba blocks followed by one application of the shared
attention block and the shared MLP (``shared/{ln1, ln2, attn, mlp}``, no
leading axis), whose gradient sums over its G applications; with
``remat="full"`` the whole group is the checkpointed unit, as in the
reference.  The VLM stack is the dense one with M-RoPE positions and the
batch's ``patches`` rows in place of the first token embeddings.  The audio
model is an encoder-decoder: :func:`encode_audio` runs the batch's
``frames`` (B, S_enc, d), precomputed frame embeddings, through a stack of
non-causal dense blocks (``encoder``, then ``enc_norm``); each decoder block
(``blocks``, with ``ln_x`` and ``cross``) runs its self-attention, then a
cross-attention on the encoder memory, then its MLP.  Training and prefill
project the memory per layer (``layers.encoder_kv``); prefill stores those
K/V in the cache's ``cross_kv``, which decoding reads without frames.

Entry points:

- ``forward_train``: the next-token objective with the HEAT sampled-CCL
  head (``core/heat_head.py``) or the full-softmax baseline;
- ``prefill``: tokens -> (last-position logits, the cache of every layer's
  K/V in ``cache_dtype``; Mamba caches in the dtype they are computed in,
  the state fp32, as the reference keeps them);
- ``pad_cache``: grow the K/V caches' sequence dimension for decoding (a
  Mamba cache does not depend on the length);
- ``decode_step``: one token per sequence at a host-int position; the new
  K/V rows and the new Mamba windows and states are written into the cache
  in place and the query attends in fp32.

``prefill`` and ``decode_step`` run without autograd, on the card unless
given ``device="cpu"``.

Under a mesh (``models/lm_distributed.py``) the parameters arrive as this
rank's slices (``params.Shard``): each block makes its layer's leaves
whole with one ``params.use_tree`` exchange (inside the remat unit, so the
recompute gathers again), the MoE experts stay split
(``moe.moe_apply``), and the vocab tables are read through owner-masked
lookups (:func:`vocab_table`).  Serving under a mesh takes the whole batch
on every rank and runs this rank's rows of it (split over the data group
where it divides the batch, as training splits them): the logits are
computed on each rank's vocab rows, gathered over the model group and
then over the data group in rank order (:func:`_logits`,
:func:`_all_rows`), and the decode cache is held as this rank's slices
under ``cache_defs``' fitted specs (``lm_distributed.place_cache``): its
batch rows are this rank's own, and each decode layer gathers the other
dimensions of its slices where attention reads them and writes the new
rows back into the slices it owns.
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
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    KVCache,
    attn_apply,
    attn_defs,
    cross_attn_apply,
    encoder_kv,
    mlp_apply,
    mlp_defs,
    rms_norm,
    rope_cos_sin,
)
from repro_torch.models.params import (
    ParamDef,
    Shard,
    abstract,
    fitted_defs,
    fsdpify,
    materialize,
    partition_specs,
    sharded_dims,
    slice_leaf,
    tree_from_items,
    tree_items,
    unbind_leaf,
    use,
    use_tree,
)
from repro_torch.optim import quantization as qz

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


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
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; available: "
                         f"{FAMILIES}")


def _norm_def(n_layers: int, d: int) -> ParamDef:
    lead = (n_layers,) if n_layers else ()
    return ParamDef(lead + (d,), "ones", spec=P(*(None,) * len(lead), None))


def _dense_block_defs(cfg: ArchConfig, L: int) -> dict:
    return {"ln1": _norm_def(L, cfg.d_model), "ln2": _norm_def(L, cfg.d_model),
            "attn": attn_defs(cfg, L), "mlp": mlp_defs(cfg, L)}


def _moe_block_defs(cfg: ArchConfig, L: int) -> dict:
    return {"ln1": _norm_def(L, cfg.d_model), "ln2": _norm_def(L, cfg.d_model),
            "attn": attn_defs(cfg, L), "moe": moe_mod.moe_defs(cfg, L)}


def _mamba_block_defs(cfg: ArchConfig, L: int) -> dict:
    return {"ln": _norm_def(L, cfg.d_model), "mamba": ssm_mod.mamba_defs(cfg, L)}


def num_groups(cfg: ArchConfig) -> int:
    """The reference's scan length: the layers, or the groups of a hybrid
    or an interleaved MoE stack."""
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
    rows = P("model", None)
    defs = {"embed": ParamDef((v, d), "normal", 0.02, rows),
            "final_norm": _norm_def(0, d)}
    if not cfg.tie_embeddings:
        defs["out_embed"] = ParamDef((v, d), "normal", 0.02, rows)
    if _interleaved(cfg):
        g = num_groups(cfg)
        defs["blocks"] = {"dense": _dense_block_defs(cfg, g * (cfg.moe_every - 1)),
                          "moe_blk": _moe_block_defs(cfg, g)}
    elif cfg.family == "moe":
        defs["blocks"] = _moe_block_defs(cfg, cfg.n_layers)
    elif cfg.family in ("ssm", "hybrid"):
        defs["blocks"] = _mamba_block_defs(cfg, cfg.n_layers)
        if cfg.family == "hybrid":
            defs["shared"] = {"ln1": _norm_def(0, d), "ln2": _norm_def(0, d),
                              "attn": attn_defs(cfg, 0), "mlp": mlp_defs(cfg, 0)}
    elif cfg.family == "audio":
        defs["encoder"] = _dense_block_defs(cfg, cfg.encoder_layers)
        defs["enc_norm"] = _norm_def(0, d)
        dec = _dense_block_defs(cfg, cfg.n_layers)
        dec["ln_x"] = _norm_def(cfg.n_layers, d)
        dec["cross"] = attn_defs(cfg, cfg.n_layers)
        defs["blocks"] = dec
    else:
        defs["blocks"] = _dense_block_defs(cfg, cfg.n_layers)
    if cfg.fsdp:
        defs = fsdpify(defs, sharding.data_shards())
    return defs


def init_params(key: int, cfg: ArchConfig, dtype=torch.float32,
                device=None, mesh=None) -> dict:
    """Materialize :func:`model_defs` from the integer key on ``device``
    (the card unless the caller names another).  Under ``mesh`` each leaf
    is this rank's slice of the unsharded init's leaf
    (``partition_specs(model_defs(cfg), mesh.shape)``), made one leaf at a
    time."""
    defs = model_defs(cfg)
    specs = None if mesh is None else partition_specs(defs, mesh.shape)
    return materialize(key, defs, dtype, mf.resolve_device(device),
                       specs=specs, mesh=mesh)


def abstract_params(cfg: ArchConfig, dtype=torch.float32, mesh=None) -> dict:
    """:func:`model_defs` as empty tensors on ``meta`` (nothing is
    allocated), for the dry run's builds and memory audits; with ``mesh``,
    this rank's slices under the fitted specs (``params.abstract``)."""
    defs = model_defs(cfg)
    if mesh is not None:
        defs = fitted_defs(defs, mesh.shape)
    return abstract(defs, dtype, mesh=mesh)


def _positions(cfg: ArchConfig, batch: int, seq: int, device,
               start: int = 0):
    """(B, S) positions ``start .. start + S - 1``, or for M-RoPE (B, S, 3)
    (t, h, w) components: with more tokens than ``num_patches``, patch i
    sits at (0, i // side, i % side) on a square grid and the text after it
    at (j, j, j) for its index j; a shorter call (a decode step) sits at
    (pos, pos, pos)."""
    base = torch.arange(seq, device=device) + start
    if cfg.rope_mode != "mrope":
        return base[None].expand(batch, seq)
    n = cfg.num_patches
    if n and seq > n:
        side = max(int(n ** 0.5), 1)
        pidx = torch.arange(n, device=device)
        patch3 = torch.stack([torch.zeros_like(pidx), pidx // side,
                              pidx % side], -1)
        text = torch.arange(n, seq, device=device) + start
        pos3 = torch.cat([patch3, torch.stack([text] * 3, -1)], dim=0)
    else:
        pos3 = torch.stack([base] * 3, -1)
    return pos3[None].expand(batch, seq, 3)


def _rope(cfg: ArchConfig, b: int, s: int, device, start: int):
    """cos, sin of the stack's attention: M-RoPE for the VLM family, the
    standard rotation for the others (a hybrid's shared block too)."""
    mode = cfg.rope_mode if cfg.family == "vlm" else "standard"
    return rope_cos_sin(_positions(cfg, b, s, device, start), cfg.head_dim,
                        cfg.rope_theta, mode)


def _attn_block(lp: dict, h, cos, sin, cfg: ArchConfig, opts: TrainOptions,
                *, moe: bool, cache: Optional[KVCache] = None,
                pos: Optional[int] = None, memory_kv=None, causal: bool = True):
    """Pre-norm attention [+ cross-attention on ``memory_kv``, the
    encoder's (k, v), after ``ln_x``] + (MLP | MoE) with residuals; returns
    ``(h, kv)`` (:func:`~repro_torch.models.layers.attn_apply`'s ``kv``).
    ``causal=False`` is the audio encoder's self-attention."""
    lp = use_tree(lp, skip=("moe",))
    a, kv = attn_apply(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps), cos,
                       sin, cfg, causal=causal, cache=cache, pos=pos,
                       attn_chunk=opts.attn_chunk,
                       probs_dtype=opts.probs_dtype,
                       acc_dtype=opts.attn_acc_dtype)
    h = h + a
    if memory_kv is not None:
        h = h + cross_attn_apply(lp["cross"], rms_norm(h, lp["ln_x"],
                                                       cfg.norm_eps),
                                 memory_kv, cfg)
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    out = moe_mod.moe_apply(lp["moe"], hn, cfg) if moe else mlp_apply(
        lp["mlp"], hn, cfg)
    return h + out, kv


def _mamba_block(lp: dict, h, cfg: ArchConfig, cache=None):
    """Pre-norm Mamba mixer with its residual; returns ``(h, cache)``: the
    layer's final :class:`~repro_torch.models.ssm.MambaCache` (train,
    prefill), or with ``cache`` given (decode, h (B, 1, d)) the advanced
    one."""
    lp = use_tree(lp)
    hn = rms_norm(h, lp["ln"], cfg.norm_eps)
    if cache is None:
        y, mc = ssm_mod.mamba_apply(lp["mamba"], hn, cfg)
    else:
        y, mc = ssm_mod.mamba_decode(lp["mamba"], hn, cache, cfg)
    return h + y, mc


def _shared_block(sp: dict, h, cos, sin, cfg: ArchConfig, opts: TrainOptions,
                  cache: Optional[KVCache] = None, pos: Optional[int] = None):
    """One application of a hybrid stack's shared attention block and
    shared MLP (pre-norm, residuals); returns ``(h, kv)``.  The attention
    takes ``probs_dtype`` but not ``attn_acc_dtype``, as the reference's
    hybrid group does."""
    sp = use_tree(sp)
    a, kv = attn_apply(sp["attn"], rms_norm(h, sp["ln1"], cfg.norm_eps), cos,
                       sin, cfg, causal=True, cache=cache, pos=pos,
                       attn_chunk=opts.attn_chunk, probs_dtype=opts.probs_dtype)
    h = h + a
    return h + mlp_apply(sp["mlp"], rms_norm(h, sp["ln2"], cfg.norm_eps),
                         cfg), kv


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
    per leaf; a :class:`~repro_torch.models.params.Shard` leaf unbinds its
    slice, which each block makes whole with ``use_tree`` when it runs)."""
    items = [(path, unbind_leaf(leaf)) for path, leaf in tree_items(blocks)]
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


def _layer_rows(leaf):
    """A stacked (L, ...) cache leaf indexable by layer: the tensor itself
    (its rows are views), or a ``Shard``'s per-layer slices."""
    return unbind_leaf(leaf) if isinstance(leaf, Shard) else leaf


def _rows_split(leaf, dim: int = 0) -> bool:
    """Whether a cache leaf splits its batch rows (``dim``: 0 in a layer's
    slot, 1 in the stacked leaf) over a data group: this rank then serves
    its own rows (:func:`_serve_rows`)."""
    return isinstance(leaf, Shard) and any(
        d == dim and g.over_data
        for d, g in sharded_dims(leaf.spec, sharding.get_mesh()))


def _whole_rows(rows: tuple) -> tuple:
    """One layer's cache leaves as this rank's rows read them: as they are,
    or, where they are a mesh's slices, all-gathered in one exchange per
    group in every dimension but the batch rows split over data."""
    if not any(isinstance(x, Shard) for x in rows):
        return tuple(rows)
    keep = (0,) if any(_rows_split(x) for x in rows) else ()
    got = use_tree({str(i): x for i, x in enumerate(rows)}, keep=keep)
    return tuple(got[str(i)] for i in range(len(rows)))


def _store(slot, value) -> None:
    """Write a layer's new cache value (this rank's rows, the rest whole)
    into its slot: the tensor, or the slice of it that a ``Shard`` owns."""
    if isinstance(slot, Shard):
        spec = P(None, *slot.spec[1:]) if _rows_split(slot) else slot.spec
        slot.local.copy_(slice_leaf(value, spec, sharding.get_mesh()))
    else:
        slot.copy_(value)


def _write_back(slot: KVCache, whole: KVCache) -> None:
    """After a decode layer wrote its new row into the K/V it read: the
    owned slices of sharded slots take it (plain slots were written in
    place)."""
    for s, w in zip(slot, whole):
        if isinstance(s, Shard):
            _store(s, w)


def _run_stack(params: dict, h, cfg: ArchConfig, opts: TrainOptions,
               mode: str = "train", cache=None, pos: Optional[int] = None,
               memory=None):
    """The layer stack, then the final norm; returns ``(h, cache)``.

    ``mode``: ``train`` (no cache; the cache is None), ``prefill`` (every
    layer's fresh K/V collected into a new :class:`DecodeCache` in
    ``opts.cache_dtype``) or ``decode`` (h is (B, 1, d) at the host int
    ``pos``; each layer writes its K/V row into ``cache`` in place, which
    is returned).  The audio family's train and prefill modes take the
    encoder's ``memory`` (B, S_enc, d) (:func:`encode_audio`), which each
    layer projects with its own ``cross`` weights; prefill stores those
    K/V in ``cache_dtype`` too, and decode reads them from
    ``cache.cross_kv``.  The SSM and hybrid stacks run in
    :func:`_run_mamba_stack`."""
    _check_family(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}; available: train, prefill, "
                         "decode")
    if cfg.family in ("ssm", "hybrid"):
        h, new_cache = _run_mamba_stack(params, h, cfg, opts, mode, cache, pos)
        return rms_norm(h, use(params["final_norm"]), cfg.norm_eps), new_cache
    b, s = h.shape[0], h.shape[1]
    decode = mode == "decode"
    audio = cfg.family == "audio"
    if audio and not decode and memory is None:
        raise ValueError("the audio family's train and prefill modes need "
                         "the encoder memory (encode_audio of the batch's "
                         "frames)")
    cos, sin = _rope(cfg, b, s, h.device, pos if decode else 0)
    plan = _stack_plan(params, cfg)

    if mode == "train":
        def block(lp, x, mem, moe):
            lp = use_tree(lp, skip=("moe",))
            mem_kv = None if mem is None else encoder_kv(lp["cross"], mem)
            return _attn_block(lp, x, cos, sin, cfg, opts, moe=moe,
                               memory_kv=mem_kv)[0]
        body = _maybe_remat(block, opts)
        for lp, moe, _, _ in plan:
            h = body(lp, h, memory, moe)
        return rms_norm(h, use(params["final_norm"]), cfg.norm_eps), None

    if decode:
        members = list(cache.kv) if _interleaved(cfg) else [cache.kv]
        members = [KVCache(_layer_rows(kvc.k), _layer_rows(kvc.v))
                   for kvc in members]
        cross = cache.cross_kv
        if cross is not None:
            cross = (_layer_rows(cross[0]), _layer_rows(cross[1]))
    else:
        shape = (b, s, cfg.n_kv_heads, cfg.head_dim)
        members = [KVCache(*(torch.empty((n,) + shape, dtype=opts.cache_dtype,
                                         device=h.device) for _ in range(2)))
                   for n in _kv_rows(cfg)]
        cross = None
        if audio:    # a plain (k, v) pair, as the reference's scan stacks it
            shape = (cfg.n_layers, b, memory.shape[1], cfg.n_kv_heads,
                     cfg.head_dim)
            cross = tuple(torch.empty(shape, dtype=opts.cache_dtype,
                                      device=h.device) for _ in range(2))
    for lp, moe, m, row in plan:
        lp = use_tree(lp, skip=("moe",))
        layer_kv = KVCache(members[m].k[row], members[m].v[row])
        mem_kv = None
        if audio:
            mem_kv = (_whole_rows((cross[0][row], cross[1][row])) if decode
                      else encoder_kv(lp["cross"], memory))
        whole_kv = KVCache(*_whole_rows(layer_kv)) if decode else None
        h, kv = _attn_block(lp, h, cos, sin, cfg, opts, moe=moe,
                            cache=whole_kv, pos=pos, memory_kv=mem_kv)
        if decode:
            _write_back(layer_kv, whole_kv)
        else:                          # prefill: collect, cast to cache_dtype
            layer_kv.k.copy_(kv.k)
            layer_kv.v.copy_(kv.v)
            if audio:
                cross[0][row].copy_(mem_kv[0])
                cross[1][row].copy_(mem_kv[1])
    if decode:
        new_cache = cache
    else:
        kv = tuple(members) if _interleaved(cfg) else members[0]
        new_cache = DecodeCache(kv=kv, cross_kv=cross)
    return rms_norm(h, use(params["final_norm"]), cfg.norm_eps), new_cache


def _run_mamba_stack(params: dict, h, cfg: ArchConfig, opts: TrainOptions,
                     mode: str, cache, pos: Optional[int]):
    """:func:`_run_stack` of the SSM and hybrid families, before the final
    norm.  Prefill collects every layer's Mamba cache, stacked over L in
    the dtype it was computed in (the reference casts none of it), and a
    hybrid's shared K/V, G rows in ``opts.cache_dtype``; decode writes the
    advanced windows, states and K/V rows into ``cache`` in place."""
    n_layers = cfg.n_layers
    hybrid = cfg.family == "hybrid"
    k = cfg.shared_attn_every if hybrid else 1
    g = n_layers // k
    b, s = h.shape[0], h.shape[1]
    decode = mode == "decode"
    layers = _layers(params["blocks"], n_layers)
    groups = [layers[i * k:(i + 1) * k] for i in range(g)]
    shared = params.get("shared")
    if hybrid:
        cos, sin = _rope(cfg, b, s, h.device, pos if decode else 0)

    if mode == "train":
        def group_fn(glayers, sp, x):
            for lp in glayers:
                x = _mamba_block(lp, x, cfg)[0]
            return _shared_block(sp, x, cos, sin, cfg, opts)[0] if hybrid else x
        body = _maybe_remat(group_fn, opts)
        for glayers in groups:
            h = body(glayers, shared, h)
        return h, None

    if decode:
        mamba = ssm_mod.MambaCache(_layer_rows(cache.mamba.conv),
                                   _layer_rows(cache.mamba.state))
        skv = cache.shared_kv
        if skv is not None:
            skv = KVCache(_layer_rows(skv.k), _layer_rows(skv.v))
    else:
        mamba, skv = [], None
        if hybrid:
            shape = (g, b, s, cfg.n_kv_heads, cfg.head_dim)
            skv = KVCache(*(torch.empty(shape, dtype=opts.cache_dtype,
                                        device=h.device) for _ in range(2)))
    for gi, glayers in enumerate(groups):
        for i, lp in enumerate(glayers):
            li = gi * k + i
            if decode:
                layer_mc = ssm_mod.MambaCache(mamba.conv[li], mamba.state[li])
                h, mc = _mamba_block(lp, h, cfg, cache=ssm_mod.MambaCache(
                    *_whole_rows(layer_mc)))
                _store(layer_mc.conv, mc.conv)
                _store(layer_mc.state, mc.state)
            else:
                h, mc = _mamba_block(lp, h, cfg)
                mamba.append(mc)
        if hybrid:
            layer_kv = KVCache(skv.k[gi], skv.v[gi])
            whole_kv = KVCache(*_whole_rows(layer_kv)) if decode else None
            h, kv = _shared_block(shared, h, cos, sin, cfg, opts,
                                  cache=whole_kv, pos=pos)
            if decode:
                _write_back(layer_kv, whole_kv)
            else:                      # prefill: collect, cast to cache_dtype
                layer_kv.k.copy_(kv.k)
                layer_kv.v.copy_(kv.v)
    if decode:
        return h, cache
    mamba = ssm_mod.MambaCache(torch.stack([m.conv for m in mamba]),
                               torch.stack([m.state for m in mamba]))
    return h, DecodeCache(mamba=mamba, shared_kv=skv)


def vocab_table(leaf):
    """An LM vocab table as the lookups see it: the tensor, or under a
    mesh whose model axis splits its rows a
    :class:`~repro_torch.distributed.sharding.ShardedRows` (its other
    sharded dimensions gathered), whose lookups are owner-masked and whose
    row count is the whole vocabulary's."""
    if not isinstance(leaf, Shard):
        return leaf
    if leaf.spec[0] != sharding.MODEL_AXIS:
        return use(leaf)
    group = sharding.get_mesh().group(sharding.MODEL_AXIS)
    local = use(leaf, keep=(0,))
    return sharding.ShardedRows(local, sharding.RowShard(
        group, local.shape[0] * group.size))


def embed_inputs(params: dict, batch: dict, cfg: ArchConfig):
    """Token embedding lookup (deterministic backward; owner-masked over
    the model group when the vocab rows are sharded); for the VLM family
    the batch's ``patches`` (B, P, d) rows take the place of the first P
    positions."""
    h = qz.gather_rows(vocab_table(params["embed"]), batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        patches = batch["patches"].to(h.dtype)
        h = torch.cat([patches, h[:, patches.shape[1]:]], dim=1)
    return h


def _out_table(params: dict, cfg: ArchConfig):
    return params["embed"] if cfg.tie_embeddings else params["out_embed"]


def head_loss(params: dict, h, labels, cfg: ArchConfig, opts: TrainOptions,
              rng: int, tile: Optional[samplers.TileState], mask=None):
    """Output-head loss: the CCL sampled head when enabled, else full-softmax
    cross entropy; returns ``(loss, new_tile)``.  Under a mesh the HEAT
    head reads the table through :func:`vocab_table`; the softmax head
    gathers it whole."""
    table = _out_table(params, cfg)
    if opts.loss == "heat" and cfg.heat.enabled:
        table = vocab_table(table)
        hcfg = HeatHeadConfig(num_negatives=cfg.heat.num_negatives,
                              mu=cfg.heat.mu, theta=cfg.heat.theta,
                              tile_size=cfg.heat.tile_size,
                              refresh_interval=cfg.heat.refresh_interval,
                              backend=cfg.heat.backend, sampler=cfg.heat.sampler)
        return sampled_ccl_loss(h, labels, table, rng, hcfg, tile, mask)
    if opts.loss not in ("heat", "softmax"):
        raise ValueError(f"unknown loss {opts.loss!r}; available: heat, softmax")
    return full_softmax_loss(h, labels, use(table), mask), tile


def _memory(params: dict, batch: dict, cfg: ArchConfig, opts: TrainOptions):
    """The audio family's encoder memory of ``batch["frames"]``; None for
    the other families."""
    if cfg.family != "audio":
        return None
    return encode_audio(params, batch["frames"], cfg, opts)


def forward_train(params: dict, batch: dict, cfg: ArchConfig,
                  opts: TrainOptions, rng: int,
                  tile: Optional[samplers.TileState] = None):
    """batch: ``tokens`` (B, S) [+ ``patches`` (B, P, d) for the VLM
    family, ``frames`` (B, S_enc, d) for the audio family].  Next-token
    objective; returns ``(loss, new_tile)``."""
    labels = batch["tokens"][:, 1:]
    memory = _memory(params, batch, cfg, opts)
    h = embed_inputs(params, batch, cfg)
    h, _ = _run_stack(params, h, cfg, opts, memory=memory)
    return head_loss(params, h[:, :-1], labels, cfg, opts, rng, tile)


def encode_audio(params: dict, frames, cfg: ArchConfig, opts: TrainOptions):
    """The audio encoder: frames (B, S_enc, d) through the ``encoder``
    blocks (non-causal self-attention at the standard RoPE positions
    ``0 .. S_enc - 1``, each block checkpointed under ``remat="full"``),
    then ``enc_norm``: the memory rows the decoder's cross-attention
    reads."""
    b, s = frames.shape[0], frames.shape[1]
    cos, sin = rope_cos_sin(_positions(cfg, b, s, frames.device),
                            cfg.head_dim, cfg.rope_theta)
    body = _maybe_remat(lambda lp, x: _attn_block(
        lp, x, cos, sin, cfg, opts, moe=False, causal=False)[0], opts)
    h = frames
    for lp in _layers(params["encoder"], cfg.encoder_layers):
        h = body(lp, h)
    return rms_norm(h, use(params["enc_norm"]), cfg.norm_eps)


class DecodeCache(NamedTuple):
    """The decode cache (the reference's, with ``None`` where it keeps
    ``()`` placeholders).  ``kv``: a :class:`KVCache` of (L, B, S, Hkv, hd)
    tensors, or for an interleaved MoE stack the pair (dense layers'
    (G * (moe_every - 1), B, S, Hkv, hd), MoE layers' (G, B, S, Hkv, hd)).
    ``mamba``: the SSM and hybrid families' :class:`~repro_torch.models.
    ssm.MambaCache` stacked over L (conv (L, B, cw - 1, d_in + 2 g s),
    state (L, B, h, s, p)); ``shared_kv``: a hybrid's :class:`KVCache` of
    (G, B, S, Hkv, hd), one row per application of its shared block.
    ``cross_kv``: the audio family's encoder K/V, (L, B, S_enc, Hkv, hd)
    each, which no decode step changes: a plain ``(k, v)`` pair from
    :func:`prefill` (the reference's scan stacks ``encoder_kv``'s tuple)
    and a :class:`KVCache` from :func:`cache_defs`, as in the
    reference."""

    kv: Any = None
    mamba: Any = None
    shared_kv: Any = None
    cross_kv: Any = None


#: the reference's logical specs of the decode cache's leaves: K/V rows
#: (L, B, S, Hkv, hd) with the batch over the data axes and the KV heads over
#: ``model``; a Mamba cache's windows (L, B, cw - 1, C) and states
#: (L, B, h, s, p) with the batch over the data axes (the states' heads over
#: ``model``).
KV_SPEC = P(None, sharding.DATA_AXES, "model", None, None)
CONV_SPEC = P(None, sharding.DATA_AXES, None, None)
STATE_SPEC = P(None, sharding.DATA_AXES, "model", None, None)


def cache_defs(cfg: ArchConfig, batch: int, seq: int) -> DecodeCache:
    """The decode cache's ParamDefs (zeros) for ``batch`` sequences of
    ``seq`` positions, in the layout :func:`prefill` returns."""
    _check_family(cfg)
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)

    def kv(n):
        return KVCache(ParamDef((n,) + shape, "zeros", spec=KV_SPEC),
                       ParamDef((n,) + shape, "zeros", spec=KV_SPEC))

    if cfg.family == "ssm":
        return DecodeCache(mamba=_mamba_cache_defs(cfg, cfg.n_layers, batch))
    if cfg.family == "hybrid":
        return DecodeCache(mamba=_mamba_cache_defs(cfg, cfg.n_layers, batch),
                           shared_kv=kv(num_groups(cfg)))
    if cfg.family == "audio":
        cross = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        return DecodeCache(kv=kv(cfg.n_layers),
                           cross_kv=KVCache(ParamDef(cross, "zeros",
                                                     spec=KV_SPEC),
                                            ParamDef(cross, "zeros",
                                                     spec=KV_SPEC)))
    members = [kv(n) for n in _kv_rows(cfg)]
    return DecodeCache(kv=tuple(members) if _interleaved(cfg) else members[0])


def _mamba_cache_defs(cfg: ArchConfig, L: int, batch: int):
    """ParamDefs (zeros) of L stacked Mamba caches for ``batch`` sequences:
    no dimension grows with the context."""
    d_in, h, p, g, s = ssm_mod._dims(cfg)
    return ssm_mod.MambaCache(
        conv=ParamDef((L, batch, cfg.conv_width - 1, d_in + 2 * g * s), "zeros",
                      spec=CONV_SPEC),
        state=ParamDef((L, batch, h, s, p), "zeros", spec=STATE_SPEC))


def pad_cache(cache: DecodeCache, cfg: ArchConfig, max_len: int) -> DecodeCache:
    """Grow the K/V caches' sequence dimension (dim 2 of (L, B, S, Hkv, hd))
    to ``max_len`` with zero rows: the prefill -> decode handoff.  A cache
    already that long is returned as it is; a Mamba cache and the audio
    family's ``cross_kv`` (its rows are the encoder's frames) are left
    alone."""
    def pad(a):
        if isinstance(a, Shard):
            raise ValueError("pad_cache takes a whole cache: gather a "
                             "sharded one first (lm_distributed.gather_cache)"
                             " and place the padded one again")
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
    another, ``meta`` for the dry run; raises where there is none), which
    must hold the parameters (this rank's slices under a mesh)."""
    dev = mf.resolve_device(device)
    embed = params["embed"]
    embed = embed.local if isinstance(embed, Shard) else embed
    if embed.device.type != dev.type:
        raise ValueError(f"the parameters are on {embed.device}, "
                         f"the call runs on {dev}: pass device= to match")
    return dev


def _logits(h, params: dict, cfg: ArchConfig):
    """``h @ table.T`` against the output table; under a mesh whose model
    axis splits the vocab rows, each rank's rows' logits gathered over the
    model group in rank order (other layouts gather the table whole)."""
    table = vocab_table(_out_table(params, cfg))
    if isinstance(table, sharding.ShardedRows):
        return sharding.all_gather_cat(h @ table.local.T, h.dim() - 1,
                                       table.shard.group)
    return h @ table.T


def _seq_rows(leaf) -> int:
    """Positions (dim 2) of a whole or sharded stacked K/V cache leaf."""
    if not isinstance(leaf, Shard):
        return leaf.shape[2]
    n = leaf.local.shape[2]
    for dim, group in sharded_dims(leaf.spec, sharding.get_mesh()):
        if dim == 2:
            n *= group.size
    return n


def _serve_rows(b: int) -> tuple:
    """``(start, stop)`` of this rank's rows of a served batch of ``b``:
    under a mesh whose data group divides ``b`` (so ``cache_defs``' fitted
    specs split the cache's batch rows over it), its share in group order;
    else every row."""
    mesh = sharding.active_mesh()
    group = mesh.group(sharding.DATA_AXES) if mesh is not None else None
    if group is None or group.size == 1 or b % group.size:
        return 0, b
    n = b // group.size
    return group.index * n, (group.index + 1) * n


def _all_rows(logits, b: int):
    """The logits of this rank's served rows gathered over the data group
    in rank order into the whole batch's (``logits`` itself when this rank
    served every row)."""
    if logits.shape[0] == b:
        return logits
    group = sharding.get_mesh().group(sharding.DATA_AXES)
    return sharding.all_gather_cat(logits, 0, group)


def prefill(params: dict, batch: dict, cfg: ArchConfig,
            opts: TrainOptions = TrainOptions(), *, device=None):
    """Full-prompt pass: ``batch["tokens"]`` (B, S) [+ ``patches`` for the
    VLM family, ``frames`` for the audio family] -> (last-position logits
    (B, V), the primed :class:`DecodeCache` (S positions of K/V in
    ``opts.cache_dtype``; for the audio family also the encoder's K/V)).
    Runs without autograd on ``device``.  Under a mesh (``params`` this
    rank's view, the whole batch on every rank) each rank runs its own rows
    (split over the data group where it divides B, as training splits
    them), the logits are gathered whole, and the cache is this rank's
    slices (``lm_distributed.place_cache``)."""
    dev = _entry_device(params, device)
    b = batch["tokens"].shape[0]
    lo, hi = _serve_rows(b)
    batch = {k: (v if hi - lo == b else v[lo:hi]).to(dev)
             for k, v in batch.items()}
    with torch.no_grad():
        memory = _memory(params, batch, cfg, opts)
        h = embed_inputs(params, batch, cfg)
        h, cache = _run_stack(params, h, cfg, opts, "prefill", memory=memory)
        logits = _all_rows(_logits(h[:, -1], params, cfg), b)
        mesh = sharding.active_mesh()
        if mesh is not None:
            from repro_torch.models.lm_distributed import place_cache
            cache = place_cache(cache, mesh, batch=b)
    return logits, cache


def decode_step(params: dict, cache: DecodeCache, token, pos: int,
                cfg: ArchConfig, opts: TrainOptions = TrainOptions(), *,
                device=None):
    """One decoding step: ``token`` (B, 1) at position ``pos`` (a host int;
    a 0-d tensor is read back once) -> (logits (B, 1, V), the cache with
    the new K/V rows and Mamba windows and states written in place).  Runs
    without autograd on ``device``; under a mesh it takes the placed cache
    that :func:`prefill` returns, runs this rank's rows, gathers the logits
    whole and writes each new row into the slices this rank owns."""
    dev = _entry_device(params, device)
    pos = int(pos)
    kv = (cache.shared_kv if cfg.family == "hybrid" else
          cache.kv[0] if _interleaved(cfg) else cache.kv)
    rows = _seq_rows(kv.k) if kv is not None else pos + 1
    if not 0 <= pos < rows:
        raise ValueError(f"position {pos} is outside the cache's "
                         f"{rows} rows (pad_cache grows it)")
    b = token.shape[0]
    lo, hi = _serve_rows(b)
    if hi - lo != b:
        first = kv.k if kv is not None else cache.mamba.conv
        if not _rows_split(first, 1):
            raise ValueError("under a mesh decode_step takes the cache that "
                             "prefill returns (lm_distributed.place_cache)")
        token = token[lo:hi]
    with torch.no_grad():
        h = qz.gather_rows(vocab_table(params["embed"]), token.to(dev))
        h, cache = _run_stack(params, h, cfg, opts, "decode", cache=cache,
                              pos=pos)
        logits = _all_rows(_logits(h, params, cfg), b)
    return logits, cache
