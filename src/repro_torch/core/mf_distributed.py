"""Sharded HEAT MF training — the paper's §7 future work — over
``torch.distributed`` (the port of ``src/repro/core/mf_distributed.py``).

    "we plan to first extend our work to support distributed training with
     rating matrix partitioning and efficient communication"  (HEAT, §7)

Partitioning, as the reference's plan (:func:`state_specs`):
  - **user table** (U, K): rows over the data axes (``pod``, ``data``), the
    rating matrix's row partition;
  - **item table** (I, K): rows over ``model``, the column dimension;
  - the tile, the aggregator and its accumulator, and the step: replicated.

The reference runs the single-device step under pjit and lets GSPMD place
the collectives; its exchange point is ``shd.replicated`` on the touched
rows' ids and gradients, after which every shard applies the *whole* update
list to its own rows, in the global order.  :func:`sharded_train_step`
reproduces those semantics, the single-device trajectory, with explicit
collectives (``distributed/sharding.py``):

  1. every rank draws the *global* batch and the *global* negatives from
     (seed, step) with the single-device generators, so the ids agree on
     every rank;
  2. user rows come through the owner-masked lookup over the data axes,
     positive (and history, and uniform-negative) rows over ``model``;
     tile-sourced negatives need no lookup, because the tile is replicated:
     HEAT's cache as a communication schedule;
  3. forward and backward run on the rank's own batch rows, the loss
     scaled by ``rows / B`` so each row's gradient is the single-device
     row's;
  4. one all-gather along the data axes brings every rank the step's
     (ids, grads) in global batch order, the tile's slot-reduced negative
     gradients (partial sums, summed in rank order) and the loss parts;
  5. each rank runs the single-device step's update half
     (``mf.update_phase``) on the global update list: each table takes it
     kept to the rank's own rows, the tile the whole list, the refresh reads
     through the lookup, and the aggregator flushes over the batch group.

Every cross-rank float sum is an all-gather and a sum in rank order, so two
sharded runs agree bit for bit.  A run tracks the single-device run to
float rounding: the negative partial sums and the loss add in another order.
Int8 tables train single-device, as in the reference.

The dry run's pieces: :data:`MF_SHAPES` (the reference's global batches),
:func:`abstract_state` and :func:`abstract_batch` (empty stand-ins on
``meta``) and :func:`build_mf_cell`, one rank's sharded step on ``meta``
(``launch/dryrun.py::lower_mf_cell``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import mf, samplers
from repro_torch.core.engine import SampleContext, StepEngine, resolve_engine
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models.params import fit_spec


@dataclasses.dataclass(frozen=True)
class MFShapeConfig:
    """Input shape of an MF dry-run cell: the global batch of
    interactions."""

    name: str
    global_batch: int


MF_SHAPES = {
    "mf_train_64k": MFShapeConfig("mf_train_64k", 65536),
    "mf_train_1m": MFShapeConfig("mf_train_1m", 1048576),
}


def _has_attn_q(cfg: mf.MFConfig) -> bool:
    return cfg.aggregation_kind in ("self_attn", "user_attn")


def state_specs(cfg: mf.MFConfig, mesh) -> mf.MFState:
    """PartitionSpec tree mirroring :class:`~repro_torch.core.mf.MFState`,
    fitted to the mesh (int8 tables raise the reference's
    ``NotImplementedError``)."""
    if getattr(cfg, "table_format", "fp32") != "fp32":
        raise NotImplementedError(
            "sharded execution supports table_format='fp32' only; int8 "
            "tables (optim/quantization.py) train single-device — sharding "
            "the (q, scale, err) leaves is an open ROADMAP item")
    ms = mesh.shape
    dp = shd.DATA_AXES
    user = fit_spec((cfg.num_users, cfg.emb_dim), P(dp, None), ms)
    item = fit_spec((cfg.num_items, cfg.emb_dim), P(shd.MODEL_AXIS, None), ms)
    aggregator = (agg.AggregatorParams(w=P(),
                                       attn_q=P() if _has_attn_q(cfg) else None)
                  if cfg.history_len > 0 else None)
    tile = (samplers.TileState(tile_ids=P(), tile_emb=P(), step=P())
            if cfg.tile_size > 0 else None)
    accum = (agg.AccumulatorState(grad_sum=aggregator, count=P())
             if cfg.history_len > 0 else None)
    return mf.MFState(mf.MFParams(user, item, aggregator), tile, accum, P())


def abstract_state(cfg: mf.MFConfig, dtype=torch.float32,
                   plan=None) -> mf.MFState:
    """Empty stand-ins of an :class:`~repro_torch.core.mf.MFState` on
    ``meta`` (nothing is allocated): the tables, the tile
    (int64 ids), the aggregator and its accumulator, host-int counters.
    With ``plan`` (an :class:`MFShardingPlan`) the tables are this rank's
    rows, built at their size directly."""
    k = cfg.emb_dim

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    users, items = cfg.num_users, cfg.num_items
    if plan is not None:
        users = plan.users.own[1] - plan.users.own[0]
        items = plan.items.own[1] - plan.items.own[0]
    aggregator = accum = None
    if cfg.history_len > 0:
        aggregator = agg.AggregatorParams(
            empty(k, k), empty(k, k) if _has_attn_q(cfg) else None)
        accum = agg.AccumulatorState(agg.AggregatorParams(
            empty(k, k), empty(k, k) if _has_attn_q(cfg) else None), 0)
    tile = (samplers.TileState(empty(cfg.tile_size, dt=torch.int64),
                               empty(cfg.tile_size, k), 0)
            if cfg.tile_size > 0 else None)
    return mf.MFState(mf.MFParams(empty(users, k), empty(items, k), aggregator),
                      tile, accum, 0)


def abstract_batch(cfg: mf.MFConfig, global_batch: int) -> mf.Batch:
    """Empty stand-in of a global batch on ``meta`` (int64 ids, the fp32
    history mask)."""
    hist = cfg.history_len

    def empty(shape, dt=torch.int64):
        return torch.empty(shape, dtype=dt, device="meta")

    return mf.Batch(
        user_ids=empty((global_batch,)), pos_ids=empty((global_batch,)),
        hist_ids=empty((global_batch, hist)) if hist else None,
        hist_mask=empty((global_batch, hist), torch.float32) if hist else None)


def batch_specs(cfg: mf.MFConfig, mesh, global_batch: int) -> mf.Batch:
    """Batch tree of specs pinning a global batch's rows to the data axes."""
    ms = mesh.shape
    dp = shd.DATA_AXES
    vec = fit_spec((global_batch,), P(dp), ms)
    hist = (fit_spec((global_batch, cfg.history_len), P(dp, None), ms)
            if cfg.history_len else None)
    return mf.Batch(user_ids=vec, pos_ids=vec, hist_ids=hist, hist_mask=hist)


def partitioned_batch(ds_sampler, step: int, global_batch: int,
                      num_users: int, num_shards: int, seed: int = 0):
    """Rating-matrix row partition: shard s draws users from its own range
    ``[s*U/S, (s+1)*U/S)`` so user-table access is shard-local.  numpy's
    ``default_rng((seed, step))``, so the ids equal the reference's bit for
    bit (``ds_sampler`` is unused, as in the reference)."""
    r = np.random.default_rng((seed, step))
    per = global_batch // num_shards
    rows = num_users // num_shards
    users = np.concatenate([
        r.integers(s * rows, (s + 1) * rows, per) for s in range(num_shards)])
    return users.astype(np.int32)


def _map_tensors(tree, fn):
    """``tree`` (nested NamedTuples) with every tensor leaf replaced by
    ``fn(leaf)``; host ints and None stay."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(x, fn) for x in tree))
    return tree


@dataclasses.dataclass(frozen=True)
class MFShardingPlan:
    """This rank's placement in one sharded MF run.

    ``specs`` mirrors :class:`~repro_torch.core.mf.MFState`
    (:func:`state_specs`); ``users`` and ``items`` are the two tables' row
    shards (a spec that keeps an axis off the rows leaves the table whole
    on every rank); ``batch_group`` is the data-axes group that splits the
    batch rows and owns the step's exchange.  Built once per run by
    :func:`make_sharding_plan` and handed to ``trainer.train_mf`` and the
    step."""

    mesh: shd.Mesh
    specs: mf.MFState
    users: shd.RowShard
    items: shd.RowShard
    batch_group: shd.AxisGroup

    def batch_rows(self, global_batch: int) -> tuple:
        """``(start, stop)``: this rank's rows of a global batch
        (``shard_bounds``: the remainder on the lowest ranks)."""
        if global_batch < self.batch_group.size:
            raise ValueError(f"a batch of {global_batch} rows cannot be "
                             f"split over {self.batch_group.size} ranks")
        return shd.shard_bounds(global_batch,
                                self.batch_group.size)[self.batch_group.index]

    def constrain_batch(self, batch: mf.Batch) -> mf.Batch:
        """This rank's rows of a global batch."""
        lo, hi = self.batch_rows(batch.user_ids.shape[0])
        return mf.Batch(*(None if x is None else x[lo:hi] for x in batch))

    def _accum_share(self, accum, whole_sum):
        """The accumulator as the ranks hold it: the whole sum on the first
        member of the batch group, zeros on the others."""
        if self.batch_group.index == 0:
            return accum._replace(grad_sum=whole_sum)
        return accum._replace(grad_sum=_map_tensors(whole_sum,
                                                    torch.zeros_like))

    def _summed_accum(self, accum):
        leaves = [g for g in accum.grad_sum if g is not None]
        summed = iter(shd.sum_over(leaves, self.batch_group))
        return type(accum.grad_sum)(*(None if g is None else next(summed)
                                      for g in accum.grad_sum))

    def place_state(self, state: mf.MFState, device=None) -> mf.MFState:
        """This rank's part of a whole state, copied to ``device`` (the
        state's by default): its table rows, the replicated leaves, and the
        accumulator's sum on the batch group's first member only."""
        dev = torch.device(device) if device is not None else \
            state.params.user_table.device
        p = state.params
        local = state._replace(params=p._replace(
            user_table=self.users.local(p.user_table),
            item_table=self.items.local(p.item_table)))
        local = _map_tensors(local, lambda t: t.to(device=dev, copy=True))
        if local.accum is not None:
            local = local._replace(accum=self._accum_share(
                local.accum, local.accum.grad_sum))
        return local

    def gather_state(self, state: mf.MFState) -> mf.MFState:
        """The whole state on every rank (for checkpoints and comparisons):
        the tables' rows gathered, the accumulator's shares summed."""
        p = state.params
        whole = state._replace(params=p._replace(
            user_table=self.users.gather(p.user_table),
            item_table=self.items.gather(p.item_table)))
        if whole.accum is not None:
            whole = whole._replace(accum=whole.accum._replace(
                grad_sum=self._summed_accum(whole.accum)))
        return whole

    def settle(self, state: mf.MFState) -> mf.MFState:
        """The state as a restore of its checkpoint would place it: the
        accumulator's shares summed onto the batch group's first member.
        Training on from a save point then matches a run resumed there bit
        for bit."""
        if state.accum is None:
            return state
        return state._replace(accum=self._accum_share(
            state.accum, self._summed_accum(state.accum)))

    def train_step(self, state, batch, rng, cfg, *, engine=None,
                   item_weights=None):
        """:func:`sharded_train_step` under this plan."""
        return sharded_train_step(self, state, batch, rng, cfg, engine=engine,
                                  item_weights=item_weights)


def make_sharding_plan(cfg: mf.MFConfig, mesh) -> MFShardingPlan:
    """:func:`state_specs` fitted to ``mesh``, as this rank's row shards and
    batch group."""
    specs = state_specs(cfg, mesh)
    return MFShardingPlan(
        mesh=mesh, specs=specs,
        users=shd.RowShard(mesh.group(specs.params.user_table[0]),
                           cfg.num_users),
        items=shd.RowShard(mesh.group(specs.params.item_table[0]),
                           cfg.num_items),
        batch_group=mesh.group(shd.DATA_AXES))


def sharded_train_step(plan: MFShardingPlan, state: mf.MFState,
                       batch: mf.Batch, rng: int, cfg: mf.MFConfig, *,
                       engine: Optional[StepEngine] = None,
                       item_weights: Optional[torch.Tensor] = None):
    """One HEAT iteration on this rank's shard; returns ``(new_state,
    loss)``, the loss the global batch's (the same bits on every rank).

    ``state`` is this rank's part (:meth:`MFShardingPlan.place_state`),
    ``batch`` the global batch, ``rng`` the step key: the draws are those
    of ``mf.heat_train_step``, and the module docstring gives the
    exchanges.  The tables are updated in place."""
    if engine is None:
        engine = resolve_engine(cfg)
    params, tile = state.params, state.tile
    dev = batch.user_ids.device
    b = batch.user_ids.shape[0]
    lo, hi = plan.batch_rows(b)
    group, users, items = plan.batch_group, plan.users, plan.items
    local = plan.constrain_batch(batch)

    # Rows: every member of a lookup's group must hold the same ids (the
    # global batch for the user table's group, this rank's rows for the
    # item table's, whose members share their batch rows).
    if users.group.size == 1:
        user_e = users.lookup(params.user_table, local.user_ids)
    else:
        user_e = users.lookup(params.user_table, batch.user_ids)[lo:hi]
    pos_e = items.lookup(params.item_table, local.pos_ids)
    # The sampler draws the global negatives from a zero stand-in of the
    # item table's shape: a tile-sourced draw reads the replicated tile, any
    # other takes its rows through the lookup below.
    stand_in = torch.zeros((1, cfg.emb_dim), dtype=params.item_table.dtype,
                           device=dev).expand(cfg.num_items, -1)
    drawn = engine.sampler.sample(
        SampleContext(table=stand_in, tile=tile, pos_ids=batch.pos_ids,
                      weights=item_weights),
        mf.generator(mf.fold_in(rng, mf.NEG_SALT), dev),
        (b, cfg.num_negatives))
    neg_ids, slots = drawn.ids, drawn.local_idx
    tile = drawn.state.tile
    if slots is not None and tile.tile_emb is not None:
        neg_e = drawn.embs[lo:hi]
    else:
        neg_e = items.lookup(params.item_table, neg_ids[lo:hi])

    aggregator = params.aggregator
    rows = [user_e, pos_e, neg_e]
    if aggregator is not None:
        rows.append(items.lookup(params.item_table, local.hist_ids))
    loss, grads, agg_grads = mf.loss_and_grads(
        rows, aggregator, local.hist_mask, cfg, engine,
        scale=None if hi - lo == b else (hi - lo) / b)

    # The exchange: one all-gather along the data axes.  Row-aligned parts
    # are padded to the largest shard's rows (shards differ by at most one).
    reduce = mf.reduces_slots(tile, slots)
    most = -(-b // group.size)
    pad = lambda x: shd.pad_rows(x, most)                     # noqa: E731
    parts = [pad(local.user_ids), pad(grads[0]), pad(local.pos_ids),
             pad(grads[1])]
    if reduce:
        parts.append(samplers.reduce_local_grads(
            slots[lo:hi], grads[2], tile.tile_ids.shape[0]))
    else:
        parts += [pad(neg_ids[lo:hi]), pad(grads[2])]
    if aggregator is not None:
        parts += [pad(local.hist_ids), pad(grads[3])]
    parts.append(loss.reshape(1))
    members = shd.all_gather_parts(parts, group)
    counts = [stop - start for start, stop in shd.shard_bounds(b, group.size)]

    def rows_of(i):                 # global batch order
        return torch.cat([m[i][:n] for m, n in zip(members, counts)])

    def summed(i):                  # rank order
        acc = members[0][i].clone()
        for m in members[1:]:
            acc.add_(m[i])
        return acc

    neg = summed(4) if reduce else (rows_of(4), rows_of(5), slots)
    hist = None if aggregator is None else (rows_of(-3), rows_of(-2))
    # The update half on the shard: each table takes the global list kept
    # to this rank's rows; the replicated tile takes the whole list and
    # refreshes from the sharded item table through the lookup.
    new_state = mf.update_phase(
        state, tile, rng, cfg, engine, user=(rows_of(0), rows_of(1)),
        pos=(rows_of(2), rows_of(3)), neg=neg, hist=hist, agg_grads=agg_grads,
        owned=(users.owned, items.owned),
        item_view=lambda table: shd.ShardedRows(table, items), group=group)
    return new_state, summed(-1)[0]


def build_mf_cell(cfg: mf.MFConfig, mesh, global_batch: int,
                  engine: Optional[StepEngine] = None):
    """The dry run's program for one rank's sharded HEAT step (the
    reference's ``build_mf_cell``): returns ``(fn, args, specs, donate)``.

    ``fn(state, batch, rng)`` runs :func:`sharded_train_step` under
    ``mesh``'s plan with ``engine`` (the config's by default); ``args`` are
    this rank's part of the state (:func:`abstract_state` with the plan)
    and the global batch, empty on ``meta``, and the step key; ``specs``
    the state's and the batch's fitted spec trees and the key's; ``donate``
    names the argument the step updates in place (the state)."""
    if engine is None:
        engine = resolve_engine(cfg)
    plan = make_sharding_plan(cfg, mesh)

    def fn(state, batch, rng):
        return sharded_train_step(plan, state, batch, rng, cfg, engine=engine)

    args = (abstract_state(cfg, plan=plan), abstract_batch(cfg, global_batch),
            0)
    return fn, args, (plan.specs, batch_specs(cfg, mesh, global_batch), P()), (0,)
