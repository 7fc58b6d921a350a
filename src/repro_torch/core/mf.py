"""Matrix-factorization CF model and the HEAT training step (paper §4.1).

One training step, as in Fig. 3 and in ``src/repro/core/mf.py``:
  (1) gather user + positive embeddings (sparse lookups; int8 tables are
      dequantized as they are gathered),
  (2) sample n negatives — uniform or from the resident tile (§4.2),
  (3) optional behavior aggregation of the user's history (§4.5),
  (4) fused similarity + CCL with residual reuse (§4.3, §4.4),
  (5) analytic gradients with respect to the gathered rows only,
  (6) sparse row updates: only touched rows are written (§3.1), duplicates
      pre-reduced in a fixed order; int8 tables requantize the touched rows
      with stochastic rounding (``optim/quantization.py``),
  (7) write-through of the updates to the tile, then its scheduled refresh,
  (8) aggregator gradients accumulate locally, flushing every m steps.

The tables are updated **in place** — the PyTorch form of the reference's
donated carry: the returned state shares the input state's table tensors, so
a caller that needs the old tables clones them first.  Step, tile and
accumulator counters are host ints, so the loop never waits on the device to
decide the refresh or flush schedule.

Randomness: every draw uses an explicit ``torch.Generator`` seeded from an
integer key.  Keys derive from ``(seed, step)`` by :func:`fold_in`, a stated
SplitMix64 mix, so every draw is pure in (seed, step).  The port cannot
reproduce JAX's threefry draws; cross-package tests replay the reference's
ids and rounding noise instead.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import samplers
from repro_torch.core.engine import SampleContext, StepEngine, resolve_engine
from repro_torch.core.metrics import stable_topk
from repro_torch.optim import quantization as qz

_M64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class MFConfig:
    """Model + execution config for the HEAT MF-CF trainer: the same fields
    and defaults as the reference's ``MFConfig``."""

    num_users: int
    num_items: int
    emb_dim: int = 128
    num_negatives: int = 64
    mu: float = 1.0
    theta: float = 0.0
    similarity: str = "cosine"
    lr: float = 0.05
    backend: str = "fused"
    update_impl: str = "scatter_add"
    sampler: str = "auto"
    history_len: int = 0
    aggregation_kind: str = "avg"
    gate: float = 0.5
    flush_every: int = 32
    tile_size: int = 0
    refresh_interval: int = 1024
    init: str = "normal"           # "normal" | "xavier"
    init_std: float = 0.1
    dtype: str = "float32"
    table_format: str = "fp32"


class MFParams(NamedTuple):
    """The trainable parameters: user and item tables (``(R, K)`` tensors
    under ``table_format='fp32'``, :class:`~repro_torch.optim.quantization.
    QuantizedTable` under ``'int8'``) and the aggregator (None when
    ``history_len == 0``)."""

    user_table: qz.Table
    item_table: qz.Table
    aggregator: Optional[agg.AggregatorParams]


class MFState(NamedTuple):
    """Training carry: params, the §4.2 resident tile (or None), the
    aggregator's gradient accumulator (or None), and the step (host int)."""

    params: MFParams
    tile: Optional[samplers.TileState]
    accum: Optional[agg.AccumulatorState]
    step: int


class Batch(NamedTuple):
    """One training mini-batch of implicit-feedback interactions (int64
    ids); ``hist_ids``/``hist_mask`` (B, H) when the model aggregates."""

    user_ids: torch.Tensor                     # (B,)
    pos_ids: torch.Tensor                      # (B,)
    hist_ids: Optional[torch.Tensor] = None    # (B, H) int64
    hist_mask: Optional[torch.Tensor] = None   # (B, H) fp32


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """Derive a key from ``key`` and ``data``:
    ``splitmix64(key ^ splitmix64(data))`` over 64-bit integers."""
    return _splitmix64((key & _M64) ^ _splitmix64(data & _M64))


def generator(key: int, device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with ``key``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key & _M64)
    return gen


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Raises when no CUDA device exists and none was named —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    return dev


#: salts of the step key: the negative draw, the tile refresh, and the two
#: stochastic-rounding draws of an int8 step (user table, then item table).
NEG_SALT, TILE_SALT, ROUND_USER_SALT, ROUND_ITEM_SALT = 0, 1, 2, 3


def _init_table(key: int, rows: int, cfg: MFConfig, std: float, dev):
    """One table drawn from ``key``, quantized at once for int8 (so the
    fp32 draw of one table is the only full-size temporary)."""
    t = torch.randn((rows, cfg.emb_dim), dtype=getattr(torch, cfg.dtype),
                    device=dev, generator=generator(key, dev)).mul_(std)
    return qz.quantize_table(t) if cfg.table_format == "int8" else t


def init_mf(seed: int, cfg: MFConfig, *, device=None) -> MFState:
    """Initialize an :class:`MFState` from the config on ``device`` (the
    card by default; see :func:`resolve_device`), quantizing each fresh
    table before the next is drawn when ``cfg.table_format == 'int8'``."""
    if cfg.table_format not in qz.TABLE_FORMATS:
        raise ValueError(f"unknown table_format {cfg.table_format!r}; "
                         f"available: {list(qz.TABLE_FORMATS)}")
    dev = resolve_device(device)
    if cfg.init == "xavier":
        su = (2.0 / (cfg.num_users + cfg.emb_dim)) ** 0.5
        si = (2.0 / (cfg.num_items + cfg.emb_dim)) ** 0.5
    else:
        su = si = cfg.init_std
    user_t = _init_table(fold_in(seed, 0), cfg.num_users, cfg, su, dev)
    item_t = _init_table(fold_in(seed, 1), cfg.num_items, cfg, si, dev)
    tile = (samplers.tile_init(generator(fold_in(seed, 2), dev), item_t,
                               cfg.tile_size)
            if cfg.tile_size > 0 else None)
    aggregator = accum = None
    if cfg.history_len > 0:
        aggregator = agg.init_aggregator(generator(fold_in(seed, 3), dev),
                                         cfg.emb_dim, cfg.aggregation_kind,
                                         getattr(torch, cfg.dtype))
        accum = agg.accumulator_init(aggregator)
    return MFState(MFParams(user_t, item_t, aggregator), tile, accum, 0)


def loss_and_grads(rows, aggregator, hist_mask, cfg: MFConfig,
                   engine: StepEngine, scale: Optional[float] = None):
    """The step's forward and backward on its gathered rows: ``rows`` is
    ``[user (B, K), pos (B, K), negs (B, n, K)]`` plus the history rows
    (B, H, K) when ``aggregator`` is set.  Returns ``(loss, grads,
    agg_grads)``: the detached loss, the gradients of ``rows`` in order and
    the aggregator's gradients (None without one).  ``scale`` multiplies
    the loss before the backward (a rank's share of a sharded batch)."""
    leaves = [t.detach().requires_grad_() for t in rows]
    agg_leaves = ([None if t is None else t.detach().requires_grad_()
                   for t in aggregator] if aggregator is not None else [])
    with torch.enable_grad():
        user_in = leaves[0]
        if aggregator is not None:
            user_in = agg.aggregate(
                agg.AggregatorParams(*agg_leaves), user_in, leaves[3],
                hist_mask.to(rows[0].dtype), gate=cfg.gate,
                kind=cfg.aggregation_kind)
        loss = engine.loss_fn(user_in, leaves[1], leaves[2], mu=cfg.mu,
                              theta=cfg.theta, similarity=cfg.similarity)
        if scale is not None:
            loss = loss * scale
        inputs = leaves + [t for t in agg_leaves if t is not None]
        # A loss that ignores an input (mse_dot, the negatives) gives it a
        # zero gradient, as jax.grad does.
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            inputs, torch.autograd.grad(loss, inputs, allow_unused=True))]
    agg_grads = None
    if aggregator is not None:
        g_agg = iter(grads[len(leaves):])
        agg_grads = agg.AggregatorParams(
            *(None if t is None else next(g_agg) for t in agg_leaves))
    return loss.detach(), grads[:len(leaves)], agg_grads


def heat_train_step(state: MFState, batch: Batch, rng: int, cfg: MFConfig,
                    *, engine: Optional[StepEngine] = None,
                    item_weights: Optional[torch.Tensor] = None, plan=None):
    """One HEAT iteration; returns ``(new_state, loss)`` with the loss a
    0-d tensor on the device.

    ``rng`` is the step's integer key.  The generators of its salts
    (:data:`NEG_SALT` ...) draw, in order: the negatives (0), the tile
    refresh (1), and for int8 tables the stochastic rounding of the user
    update (2) and of the item update (3) — the reference splits its key in
    two and folds in 1 and 2 for the roundings.  ``engine`` selects the
    loss, row-update and sampler implementations (``None`` resolves it from
    the config); int8 tables replace the engine's row update with the
    requantizing one, as in the reference.  Gathers from an int8 table go
    through the gather-dequant kernel when ``engine.backend == 'pallas'``.
    The sampler's context carries the batch's positives (``in_batch``) and
    ``item_weights`` ((I,) unnormalized, for ``popularity``).  The tables
    are updated in place.

    ``plan`` (a ``core/mf_distributed.py::MFShardingPlan``) runs the step
    sharded: ``state`` is this rank's part, ``batch`` the *global* batch
    (the same on every rank), and the loss the global batch's
    (:func:`~repro_torch.core.mf_distributed.sharded_train_step`)."""
    if engine is None:
        engine = resolve_engine(cfg)
    if plan is not None:
        return plan.train_step(state, batch, rng, cfg, engine=engine,
                               item_weights=item_weights)
    params, tile = state.params, state.tile
    dev = batch.user_ids.device
    quantized = isinstance(params.user_table, qz.QuantizedTable)
    in_kernel = quantized and engine.backend == "pallas"

    user_e = qz.gather_rows(params.user_table, batch.user_ids,
                            use_kernel=in_kernel)
    pos_e = qz.gather_rows(params.item_table, batch.pos_ids,
                           use_kernel=in_kernel)
    n_shape = (batch.user_ids.shape[0], cfg.num_negatives)
    drawn = engine.sampler.sample(
        SampleContext(table=params.item_table, tile=tile,
                      pos_ids=batch.pos_ids, weights=item_weights),
        generator(fold_in(rng, NEG_SALT), dev), n_shape)
    neg_ids, neg_e, neg_local = drawn.ids, drawn.embs, drawn.local_idx
    tile = drawn.state.tile

    aggregator = params.aggregator
    rows = [user_e, pos_e, neg_e]
    if aggregator is not None:
        rows.append(qz.gather_rows(params.item_table, batch.hist_ids,
                                   use_kernel=in_kernel))
    loss, grads, agg_grads = loss_and_grads(rows, aggregator, batch.hist_mask,
                                            cfg, engine)
    g_user, g_pos, g_neg = grads[:3]

    # §3.1: only touched rows are written.  All of the step's item gradient
    # groups go to ONE update (one kernel launch for the `pallas` update,
    # one requantization per touched row for int8).  Tile-sourced negatives
    # are slot-reduced first when the tile is no larger than the sample, so
    # the table takes N1 unique rows instead of B*n duplicate-heavy ones and
    # the tile write-through is a dense add; a tile larger than the sample
    # keeps per-sample rows.
    if quantized:
        new_user = qz.apply_updates(
            params.user_table, batch.user_ids, g_user, cfg.lr,
            generator(fold_in(rng, ROUND_USER_SALT), dev))
    else:
        new_user = engine.row_update(params.user_table, batch.user_ids,
                                     g_user, cfg.lr)
    neg_reduced = None
    item_groups = [(batch.pos_ids, g_pos)]
    if neg_local is not None and tile.tile_ids.shape[0] <= neg_local.numel():
        neg_reduced = samplers.reduce_local_grads(neg_local, g_neg,
                                                  tile.tile_ids.shape[0])
        item_groups.append((tile.tile_ids, neg_reduced))
    else:
        item_groups.append((neg_ids, g_neg))
    if aggregator is not None:
        item_groups.append((batch.hist_ids, grads[3]))
    if quantized:
        new_item = qz.apply_updates_many(
            params.item_table, item_groups, cfg.lr,
            generator(fold_in(rng, ROUND_ITEM_SALT), dev))
    else:
        new_item = engine.row_update_many(params.item_table, item_groups,
                                          cfg.lr)

    # Tile coherence: write the same updates through to the resident copy
    # (exact fp32 updates, also over an int8 table: the tile drifts from the
    # requantized rows by at most their rounding until it is refreshed),
    # then refresh on schedule (§4.2).
    if tile is not None:
        global_groups = [(batch.pos_ids, g_pos)]
        if neg_reduced is not None:
            tile = samplers.tile_apply_reduced(tile, neg_reduced, cfg.lr)
        elif neg_local is not None:
            tile = samplers.tile_apply_grads(tile, neg_local, g_neg, cfg.lr)
        else:
            global_groups.append((neg_ids, g_neg))
        if aggregator is not None:
            global_groups.append((batch.hist_ids, grads[3]))
        tile = samplers.tile_apply_global_grads_many(tile, global_groups,
                                                     cfg.lr)
        tile = samplers.tile_refresh(tile,
                                     generator(fold_in(rng, TILE_SALT), dev),
                                     new_item, cfg.refresh_interval)

    # Aggregator: local accumulation, deferred flush (§4.5 / Listing 1).
    accum = state.accum
    if aggregator is not None:
        accum = agg.accumulate(accum, agg_grads)
        aggregator, accum = agg.maybe_flush(accum, aggregator, cfg.lr,
                                            cfg.flush_every)

    new_state = MFState(MFParams(new_user, new_item, aggregator), tile, accum,
                        state.step + 1)
    return new_state, loss


def make_scan_body(cfg: MFConfig, batch_fn, seed: int, *,
                   engine: Optional[StepEngine] = None,
                   item_weights: Optional[torch.Tensor] = None, plan=None):
    """``body(state, step) -> (state, loss)``: the per-step body of the
    trainer's K-step windows.  ``batch_fn(step)`` builds the batch and the
    step key is ``fold_in(seed, step)``, so a window is pure in
    (state, seed, start).  ``item_weights`` (for example
    ``DeviceCFDataset.item_weights``) feeds the ``popularity`` sampler;
    ``plan`` runs each step sharded (``batch_fn`` then draws the global
    batch)."""
    if engine is None:
        engine = resolve_engine(cfg)

    def body(state: MFState, step: int):
        return heat_train_step(state, batch_fn(step), fold_in(seed, step),
                               cfg, engine=engine, item_weights=item_weights,
                               plan=plan)

    return body


def _score_item_block(u: torch.Tensor, block: torch.Tensor,
                      similarity: str) -> torch.Tensor:
    """(B, K) users x (C, K) item rows -> (B, C) scores; cosine divides by
    the user norms, then by the item norms, each clipped at 1e-12, in the
    reference's order."""
    s = u @ block.T
    if similarity == "cosine":
        un = torch.sqrt((u * u).sum(-1, keepdim=True)).clamp_min(1e-12)
        bn = torch.sqrt((block * block).sum(-1)).clamp_min(1e-12)
        s = s / un / bn[None, :]
    return s


@torch.no_grad()
def scores_all_items(params: MFParams, user_ids: torch.Tensor,
                     similarity: str = "cosine", *,
                     item_chunk: Optional[int] = None) -> torch.Tensor:
    """(B, I) scores for evaluation (Recall@K / NDCG@K).

    ``item_chunk`` computes the matrix block by block (bounded matmul
    temporaries; the last block may be shorter); the result is still
    (B, I) — use :func:`topk_all_items` when only a top-k is needed and
    (B, I) must never exist at once."""
    u = qz.gather_rows(params.user_table, user_ids)
    t = params.item_table
    n = qz.num_rows(t)
    if not item_chunk or item_chunk >= n:
        return _score_item_block(u, qz.dequantize_table(t), similarity)
    return torch.cat([_score_item_block(u, qz.slice_rows(t, s, s + item_chunk),
                                        similarity)
                      for s in range(0, n, item_chunk)], dim=1)


@torch.no_grad()
def topk_all_items(params: MFParams, user_ids: torch.Tensor, k: int, *,
                   similarity: str = "cosine",
                   item_chunk: Optional[int] = None,
                   exclude_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-k item ids (int64) per user over the full catalog, chunked.

    A running (B, k) top-k is merged with each (B, item_chunk) score block
    (an int8 table is dequantized one block at a time), so the full (B, I)
    score matrix is never materialized: at paper scale (9.35M items) it
    would take 38 GB for 1,024 users.  ``exclude_mask`` (B, I) bool masks
    training positives (sliced per block, never copied whole).
    ``k > num_items`` is clamped: the result is (B, min(k, I)).

    Ties go to the lower item id, as the reference's ``lax.top_k`` orders
    them: the running best sits before each block in the merge, and
    :func:`~repro_torch.core.metrics.stable_topk` prefers the earlier
    position.  Rows with fewer than k unmasked items come back as the
    reference returns them: padded with id 0 on the chunked path (its
    running best starts as k copies of id 0 at -inf), with the masked ids,
    lowest first, on the dense path (``item_chunk`` None or at least the
    catalog)."""
    u = qz.gather_rows(params.user_table, user_ids)
    t = params.item_table
    num_items = qz.num_rows(t)
    k = min(int(k), num_items)
    c = item_chunk or num_items
    if c >= num_items:
        sc = _score_item_block(u, qz.dequantize_table(t), similarity)
        if exclude_mask is not None:
            sc = torch.where(exclude_mask, float("-inf"), sc)
        return stable_topk(sc, k)

    b = u.shape[0]
    best_s = torch.full((b, k), float("-inf"), dtype=u.dtype, device=u.device)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=u.device)
    for s0 in range(0, num_items, c):
        sc = _score_item_block(u, qz.slice_rows(t, s0, s0 + c), similarity)
        if exclude_mask is not None:
            sc = torch.where(exclude_mask[:, s0:s0 + c], float("-inf"), sc)
        pos = stable_topk(torch.cat([best_s, sc], dim=1), k)
        from_best = pos < k
        best_s = torch.where(from_best, best_s.gather(1, pos.clamp_max(k - 1)),
                             sc.gather(1, (pos - k).clamp_min(0)))
        best_i = torch.where(from_best, best_i.gather(1, pos.clamp_max(k - 1)),
                             s0 + pos - k)
    return best_i
