"""Matrix-factorization CF model and the HEAT training step (paper §4.1).

One training step, as in Fig. 3 and in ``src/repro/core/mf.py``:
  (1) gather user + positive embeddings (sparse lookups),
  (2) sample n negatives — uniform or from the resident tile (§4.2),
  (3) fused similarity + CCL with residual reuse (§4.3, §4.4),
  (4) analytic gradients with respect to the gathered rows only,
  (5) sparse row updates: only touched rows are written (§3.1), duplicates
      pre-reduced in a fixed order,
  (6) write-through of the updates to the tile, then its scheduled refresh.

The tables are updated **in place** — the PyTorch form of the reference's
donated carry: the returned state shares the input state's table tensors, so
a caller that needs the old tables clones them first.  Step and tile
counters are host ints, so the loop never waits on the device to decide the
refresh schedule.  Behavior aggregation (``history_len > 0``) and int8 tables
wait for later slices of the port and raise ``NotImplementedError``.

Randomness: every draw uses an explicit ``torch.Generator`` seeded from an
integer key.  Keys derive from ``(seed, step)`` by :func:`fold_in`, a stated
SplitMix64 mix, so every draw is pure in (seed, step).  The port cannot
reproduce JAX's threefry draws; cross-package tests replay the reference's
ids instead.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import samplers
from repro_torch.core.engine import SampleContext, StepEngine, resolve_engine

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
    """The trainable parameters: user and item tables, ``(R, K)`` each."""

    user_table: torch.Tensor
    item_table: torch.Tensor


class MFState(NamedTuple):
    """Training carry: params, the §4.2 resident tile (or None), and the
    step (host int)."""

    params: MFParams
    tile: Optional[samplers.TileState]
    step: int


class Batch(NamedTuple):
    """One training mini-batch of implicit-feedback interactions (int64)."""

    user_ids: torch.Tensor     # (B,)
    pos_ids: torch.Tensor      # (B,)


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


def check_ported(cfg: MFConfig) -> None:
    """Raise ``NotImplementedError`` for config features the port does not
    have yet, naming the ROADMAP item that brings each."""
    if cfg.table_format != "fp32":
        raise NotImplementedError(
            f"table_format={cfg.table_format!r}: int8 tables come with the "
            "int8 slice of the port (ROADMAP.md, queue A, item 2)")
    if cfg.history_len > 0:
        raise NotImplementedError(
            "history_len > 0: behavior aggregation comes with the next MF "
            "slice of the port (ROADMAP.md, queue A, item 1)")


def init_mf(seed: int, cfg: MFConfig, *, device=None) -> MFState:
    """Initialize an :class:`MFState` from the config on ``device`` (the
    card by default; see :func:`resolve_device`)."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    if cfg.init == "xavier":
        su = (2.0 / (cfg.num_users + cfg.emb_dim)) ** 0.5
        si = (2.0 / (cfg.num_items + cfg.emb_dim)) ** 0.5
    else:
        su = si = cfg.init_std
    user_t = torch.randn((cfg.num_users, cfg.emb_dim), dtype=dtype, device=dev,
                         generator=generator(fold_in(seed, 0), dev)) * su
    item_t = torch.randn((cfg.num_items, cfg.emb_dim), dtype=dtype, device=dev,
                         generator=generator(fold_in(seed, 1), dev)) * si
    tile = (samplers.tile_init(generator(fold_in(seed, 2), dev), item_t,
                               cfg.tile_size)
            if cfg.tile_size > 0 else None)
    return MFState(MFParams(user_t, item_t), tile, 0)


def heat_train_step(state: MFState, batch: Batch, rng: int, cfg: MFConfig,
                    *, engine: Optional[StepEngine] = None):
    """One HEAT iteration; returns ``(new_state, loss)`` with the loss a
    0-d tensor on the device.

    ``rng`` is the step's integer key: the negative draw uses the generator
    of ``fold_in(rng, 0)`` and the tile refresh that of ``fold_in(rng, 1)``,
    as the reference splits its step key in two.  ``engine`` selects the
    loss, row-update and sampler implementations (``None`` resolves it from
    the config).  The tables are updated in place."""
    check_ported(cfg)
    if engine is None:
        engine = resolve_engine(cfg)
    params, tile = state.params, state.tile
    dev = params.user_table.device

    user_e = params.user_table[batch.user_ids]
    pos_e = params.item_table[batch.pos_ids]
    n_shape = (batch.user_ids.shape[0], cfg.num_negatives)
    drawn = engine.sampler.sample(
        SampleContext(table=params.item_table, tile=tile),
        generator(fold_in(rng, 0), dev), n_shape)
    neg_ids, neg_e, neg_local = drawn.ids, drawn.embs, drawn.local_idx
    tile = drawn.state.tile

    leaves = [t.detach().requires_grad_() for t in (user_e, pos_e, neg_e)]
    with torch.enable_grad():
        loss = engine.loss_fn(*leaves, mu=cfg.mu, theta=cfg.theta,
                              similarity=cfg.similarity)
        g_user, g_pos, g_neg = torch.autograd.grad(loss, leaves)

    # §3.1: only touched rows are written.  All of the step's item gradient
    # groups go to row_update_many in ONE call (one kernel launch for the
    # `pallas` update).  Tile-sourced negatives are slot-reduced first when
    # the tile is no larger than the sample, so the table takes N1 unique
    # rows instead of B*n duplicate-heavy ones and the tile write-through is
    # a dense add; a tile larger than the sample keeps per-sample rows.
    new_user = engine.row_update(params.user_table, batch.user_ids, g_user,
                                 cfg.lr)
    neg_reduced = None
    item_groups = [(batch.pos_ids, g_pos)]
    if neg_local is not None and tile.tile_ids.shape[0] <= neg_local.numel():
        neg_reduced = samplers.reduce_local_grads(neg_local, g_neg,
                                                  tile.tile_ids.shape[0])
        item_groups.append((tile.tile_ids, neg_reduced))
    else:
        item_groups.append((neg_ids, g_neg))
    new_item = engine.row_update_many(params.item_table, item_groups, cfg.lr)

    # Tile coherence: write the same updates through to the resident copy,
    # then refresh on schedule (§4.2).
    if tile is not None:
        global_groups = [(batch.pos_ids, g_pos)]
        if neg_reduced is not None:
            tile = samplers.tile_apply_reduced(tile, neg_reduced, cfg.lr)
        elif neg_local is not None:
            tile = samplers.tile_apply_grads(tile, neg_local, g_neg, cfg.lr)
        else:
            global_groups.append((neg_ids, g_neg))
        tile = samplers.tile_apply_global_grads_many(tile, global_groups,
                                                     cfg.lr)
        tile = samplers.tile_refresh(tile, generator(fold_in(rng, 1), dev),
                                     new_item, cfg.refresh_interval)

    new_state = MFState(MFParams(new_user, new_item), tile, state.step + 1)
    return new_state, loss.detach()


def make_scan_body(cfg: MFConfig, batch_fn, seed: int, *,
                   engine: Optional[StepEngine] = None):
    """``body(state, step) -> (state, loss)``: the per-step body of the
    trainer's K-step windows.  ``batch_fn(step)`` builds the batch and the
    step key is ``fold_in(seed, step)``, so a window is pure in
    (state, seed, start)."""
    if engine is None:
        engine = resolve_engine(cfg)

    def body(state: MFState, step: int):
        return heat_train_step(state, batch_fn(step), fold_in(seed, step),
                               cfg, engine=engine)

    return body
