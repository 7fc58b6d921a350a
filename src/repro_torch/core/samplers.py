"""Negative samplers: uniform random and HEAT's random tiling (paper §4.2).

Random tiling keeps ``N1`` item rows resident (the tile) and draws negatives
from it by local slot, redrawing the tile every ``N2`` steps.  Every update a
step makes to the item table is written through to the tile copy, so tile
reads stay coherent.

Every draw takes an explicit ``torch.Generator`` on the device it draws on.
The tile's refresh counter is a host ``int``: the refresh schedule is known
to the host, so deciding it costs no device sync.  The item table may be
fp32 or int8 (``optim/quantization.py``); the tile copy is always fp32.  The
id-only tile (``tile_emb=None``, :func:`id_tile_init`) is the LM vocab tile:
only the sampling space is tiled, and its rows are gathered through the live
table so gradients reach it.  :class:`ShardedTileState` keeps one tile per
data shard (the paper's per-thread tiles), vectorized.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import tiling
from repro_torch.optim import quantization as qz


def sample_uniform(gen: torch.Generator, num_items: int, shape) -> torch.Tensor:
    """The original random sampler: int64 ids uniform over the item space."""
    return torch.randint(0, num_items, tuple(shape), generator=gen,
                         device=gen.device)


def sample_unique(gen: torch.Generator, num_items: int, n: int) -> torch.Tensor:
    """``n`` distinct uniform ids, sorted ascending (a prefix of a random
    permutation).  Distinct ids keep the write-through exact; sorted ids
    let it binary-search the tile."""
    perm = torch.randperm(num_items, generator=gen, device=gen.device)
    return torch.sort(perm[:n]).values


class TileState(NamedTuple):
    """The resident tile: ``tile_ids`` (N1,) int64 distinct sorted ids,
    ``tile_emb`` (N1, K) their rows or None (id-only), ``step`` iterations
    since the last refresh (host int)."""

    tile_ids: torch.Tensor
    tile_emb: Optional[torch.Tensor]
    step: int


def tile_init(gen: torch.Generator, item_table, tile_size: int) -> TileState:
    """Draw the initial resident tile (distinct sorted ids + their rows,
    dequantized when the table is int8)."""
    ids = sample_unique(gen, qz.num_rows(item_table), tile_size)
    return TileState(ids, qz.gather_rows(item_table, ids), 0)


def id_tile_init(gen: torch.Generator, num_items: int,
                 tile_size: int) -> TileState:
    """Id-only tile (no embedding copy): the LM head's vocab tile."""
    return TileState(sample_unique(gen, num_items, tile_size), None, 0)


def refresh_due(state, refresh_interval: int) -> bool:
    """Whether :func:`tile_refresh` (or :func:`sharded_tile_refresh`)
    redraws at this step."""
    return state.step >= refresh_interval - 1


def tile_refresh(state: TileState, gen: torch.Generator, item_table,
                 refresh_interval: int) -> TileState:
    """Redraw the tile from the live table every ``refresh_interval`` steps,
    else count the step (``gen`` is read only on a redraw).  An id-only
    tile redraws its ids only (the table gives just the size of the
    sampling space)."""
    if refresh_due(state, refresh_interval):
        ids = sample_unique(gen, qz.num_rows(item_table),
                            state.tile_ids.shape[0])
        emb = (None if state.tile_emb is None
               else qz.gather_rows(item_table, ids))
        return TileState(ids, emb, 0)
    return TileState(state.tile_ids, state.tile_emb, state.step + 1)


def tile_sample(state: TileState, gen: torch.Generator, shape):
    """Negatives drawn *from the tile*: ``(global ids, their rows, the
    local slots)``, the slots uniform over the tile from ``gen``.  The rows
    come from the small resident copy, not the table."""
    local = torch.randint(0, state.tile_ids.shape[0], tuple(shape),
                          generator=gen, device=gen.device)
    return state.tile_ids[local], state.tile_emb[local], local


def tile_writeback(state: TileState, local_idx, new_rows) -> TileState:
    """Write updated rows back into the tile copy by local slot: values,
    not adds, and of several writes to one slot the last wins, as the
    reference's ``.at[].set`` resolves them (here deterministically: each
    slot takes the row of its highest position)."""
    idx = local_idx.reshape(-1)
    rows = new_rows.reshape(-1, new_rows.shape[-1])
    n1 = state.tile_ids.shape[0]
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n1,), -1, dtype=pos.dtype, device=idx.device)
    last = last.scatter_reduce(0, idx, pos, "amax")
    written = rows[last.clamp_min(0)].to(state.tile_emb.dtype)
    return state._replace(tile_emb=torch.where(
        (last >= 0)[:, None], written, state.tile_emb))


def tile_apply_grads(state: TileState, local_idx, grads, lr: float) -> TileState:
    """SGD write-through on the tile copy by local slot (duplicates add)."""
    g = grads.reshape(-1, grads.shape[-1])
    delta = tiling.segment_sum(local_idx.reshape(-1), -lr * g,
                               state.tile_ids.shape[0])
    return state._replace(tile_emb=state.tile_emb + delta)


def reduce_local_grads(local_idx, grads, tile_size: int):
    """Sum tile-sourced gradients by tile slot: (..., K) rows addressed by
    local index -> one dense (N1, K) gradient, in a fixed order (§4.5
    pre-reduction at the sampler boundary)."""
    return tiling.segment_sum(local_idx.reshape(-1),
                              grads.reshape(-1, grads.shape[-1]), tile_size)


def tile_apply_reduced(state: TileState, reduced, lr: float) -> TileState:
    """Write-through of an already slot-reduced (N1, K) gradient: a dense
    FMA on the tile copy."""
    return state._replace(tile_emb=state.tile_emb - lr * reduced)


def tile_apply_global_grads_many(state: TileState, groups, lr: float) -> TileState:
    """One write-through for all of a step's gradient groups addressed by
    global item id (pos / uniform-sourced neg)."""
    ids, grads = tiling.concat_groups(groups)
    return state._replace(tile_emb=tiling.tile_write_through(
        state.tile_ids, state.tile_emb, ids, grads, lr))


def tile_apply_global_grads(state: TileState, global_ids, grads,
                            lr: float) -> TileState:
    """Write-through of updates addressed by *global* item id (positives,
    history rows that live in the tile): the sorted-intersection
    write-through (``tiling.tile_write_through``), duplicates adding."""
    return state._replace(tile_emb=tiling.tile_write_through(
        state.tile_ids, state.tile_emb, global_ids, grads, lr))


def tile_apply_global_grads_mask(state: TileState, global_ids, grads,
                                 lr: float) -> TileState:
    """The O(N1 * B) membership-mask write-through that the sorted
    intersection replaced: an (N1, B) equality mask applied as one matmul.
    Kept as the baseline the backends benchmark contrasts, and as a second
    oracle."""
    ids = global_ids.reshape(-1)
    g = grads.reshape(-1, grads.shape[-1])
    match = (state.tile_ids[:, None] == ids[None, :]).to(g.dtype)
    return state._replace(tile_emb=state.tile_emb - lr * (match @ g))


class ShardedTileState(NamedTuple):
    """Vectorized tiles for S shards (the paper's per-thread tiles):
    ``tile_ids`` (S, N1) int64, each row distinct and sorted, ``tile_emb``
    (S, N1, K) their rows, ``step`` (host int) shared by every shard, which
    all refresh on one schedule."""

    tile_ids: torch.Tensor
    tile_emb: torch.Tensor
    step: int


def _sharded_unique_ids(gen: torch.Generator, num_items: int, num_shards: int,
                        tile_size: int) -> torch.Tensor:
    """Per-shard distinct sorted ids (the single tile's invariant: one tile
    row per id keeps the write-through exact, and the sorted-intersection
    write-through binary-searches), drawn shard after shard from ``gen``."""
    return torch.stack([sample_unique(gen, num_items, tile_size)
                        for _ in range(num_shards)])


def sharded_tile_init(gen: torch.Generator, item_table: torch.Tensor,
                      tile_size: int, num_shards: int) -> ShardedTileState:
    """Per-shard tile init from an fp32 item table: independent draws, so
    each shard caches its own rows."""
    ids = _sharded_unique_ids(gen, item_table.shape[0], num_shards, tile_size)
    return ShardedTileState(ids, item_table[ids], 0)


def sharded_tile_refresh(state: ShardedTileState, gen: torch.Generator,
                         item_table: torch.Tensor,
                         refresh_interval: int) -> ShardedTileState:
    """Interval-gated redraw of every shard's tile ids and rows (fp32
    tables), else count the step (:func:`refresh_due`'s schedule)."""
    if refresh_due(state, refresh_interval):
        ids = _sharded_unique_ids(gen, item_table.shape[0],
                                  state.tile_ids.shape[0],
                                  state.tile_ids.shape[1])
        return ShardedTileState(ids, item_table[ids], 0)
    return ShardedTileState(state.tile_ids, state.tile_emb, state.step + 1)
