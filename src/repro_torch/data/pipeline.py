"""Synthetic implicit-feedback CF data and synthetic LM batches (the CF half
and ``lm_batch`` of ``src/repro/data/pipeline.py``).

Every batch is a pure function of (seed, step): :func:`cf_batch_device`
draws from a ``torch.Generator`` seeded with ``fold_in(fold_in(seed, step),
BATCH_STREAM)`` (``repro_torch.core.mf.fold_in``, a SplitMix64 mix — never
CPython ``hash``, whose string hashes are salted per process).  A run
restarted at step N therefore sees exactly the batches it would have seen.
The dataset's ``train_pos`` and its items' interaction counts (the
``popularity`` sampler's weights) are uploaded once
(:func:`device_cf_dataset`), so steady-state training copies nothing from
the host per step.  :func:`cf_batch` is the same draw from the host dataset,
and :func:`procedural_cf_batch` draws batches of any table size without a
dataset.

Streaming (``src/repro_torch/stream/``): :func:`stream_ring_dataset` lays
each user's positives out as a fixed-capacity ring on the device,
:meth:`DeviceCFDataset.apply_events` folds a padded micro-batch of live
(user, item) events into it in place (append, evict the oldest, count
popularity) with a fixed number of launches and no host sync, and
:func:`stream_batch_device` draws recency-weighted batches over the ring
from ``fold_in(fold_in(seed, step), RING_STREAM)``, also without a host
sync.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.mf import Batch, fold_in, generator, resolve_device
from repro_torch.distributed.sharding import shard_bounds  # noqa: F401 (re-export)
from repro_torch.train.shapes import ShapeCounter

#: salt separating the batch draw from the step's own draws (which use
#: ``fold_in(seed, step)`` directly).
BATCH_STREAM = 0x0BA7C4
#: salt of the streaming ring's batch draw (:func:`stream_batch_device`).
RING_STREAM = 0x5713EA

#: distinct padded event-batch lengths ``apply_events`` has been called
#: with: a steady ingest path keeps one (the reference counts traces of its
#: jitted ``apply_events`` the same way).
APPLY_EVENTS_SHAPES = ShapeCounter("device_cf_dataset.apply_events")


@dataclasses.dataclass(frozen=True)
class CFDataset:
    """Dense interaction matrix view of a synthetic implicit-feedback set."""

    num_users: int
    num_items: int
    train_pos: np.ndarray       # (num_users, max_train) int32, -1 padded
    test_pos: np.ndarray        # (num_users, max_test) int32, -1 padded

    def train_mask(self) -> np.ndarray:
        """(num_users, num_items) bool: True where a user has a training
        positive."""
        return self._mask(self.train_pos)

    def test_mask(self) -> np.ndarray:
        """(num_users, num_items) bool: True where a user has a test
        positive."""
        return self._mask(self.test_pos)

    def _mask(self, pos: np.ndarray) -> np.ndarray:
        m = np.zeros((self.num_users, self.num_items), bool)
        u = np.repeat(np.arange(self.num_users), pos.shape[1])
        i = pos.reshape(-1)
        valid = i >= 0
        m[u[valid], i[valid]] = True
        return m


def synth_cf_dataset(num_users: int, num_items: int, *, seed: int = 0,
                     interactions_per_user: int = 20, num_clusters: int = 16,
                     test_frac: float = 0.2) -> CFDataset:
    """Clustered power-law interactions: user u prefers items from its
    cluster's popularity-ranked pool, so CF signal is recoverable.  The same
    numpy draws as the reference's ``synth_cf_dataset``, so both packages
    build the identical dataset from one seed."""
    rng = np.random.default_rng(seed)
    user_cluster = rng.integers(0, num_clusters, num_users)
    item_cluster = rng.integers(0, num_clusters, num_items)
    pools = [np.where(item_cluster == c)[0] for c in range(num_clusters)]
    pools = [p if len(p) else np.arange(num_items) for p in pools]

    n_test = max(int(interactions_per_user * test_frac), 1)
    n_train = interactions_per_user - n_test
    train = np.full((num_users, n_train), -1, np.int32)
    test = np.full((num_users, n_test), -1, np.int32)
    for u in range(num_users):
        pool = pools[user_cluster[u]]
        w = 1.0 / np.arange(1, len(pool) + 1)
        w /= w.sum()
        k = min(interactions_per_user, len(pool))
        items = rng.choice(pool, size=k, replace=False, p=w)
        train[u, :max(k - n_test, 0)] = items[:max(k - n_test, 0)]
        test[u, :min(n_test, k)] = items[max(k - n_test, 0):k]
    return CFDataset(num_users, num_items, train, test)


@dataclasses.dataclass(frozen=True)
class DeviceCFDataset:
    """Device-resident view of a :class:`CFDataset`: ``train_pos`` (int64)
    and ``item_weights`` ((num_items,) fp32 interaction counts, the
    ``popularity`` sampler's weights) live on the device the batches are
    drawn on.

    Streaming views (:func:`stream_ring_dataset`) also carry ring state:
    ``row_count`` (valid rows per user, saturating at the capacity) and
    ``write_pos`` (next slot to write, mod the capacity), both int64
    (num_users,); offline views leave them ``None``.  The tensors are the
    checkpoint's leaves (``train/checkpoint.py::map_leaves``), the two ints
    its metadata."""

    num_users: int
    num_items: int
    train_pos: torch.Tensor
    item_weights: torch.Tensor
    row_count: Optional[torch.Tensor] = None
    write_pos: Optional[torch.Tensor] = None

    def apply_events(self, user_ids, item_ids):
        """Fold one micro-batch of (user, item) events into the ring.

        ``user_ids`` / ``item_ids``: equal-length 1-D integer arrays;
        ``user_id < 0`` marks padding, which adds and writes nothing
        (callers pad to one length: :data:`APPLY_EVENTS_SHAPES` counts the
        lengths seen).  Each event appends its item to the user's ring in
        arrival order, overwriting the oldest entry once ``row_count`` has
        reached the capacity, and adds one to the item's popularity count.

        Returns ``(view, new_user_mask, new_item_mask)``: the masks flag the
        users and items seen for the first time.  The ring tensors are
        updated **in place** (the port's form of the reference's donated
        buffers), so ``view`` shares them with ``self``; ``item_weights`` is
        changed by ``index_add_``, whose version bump makes the popularity
        sampler rebuild its CDF.  Offline views refuse (they may be shared
        by callers that expect them unchanged)."""
        if self.row_count is None or self.write_pos is None:
            raise ValueError(
                "apply_events needs ring state (row_count/write_pos); build "
                "the view with stream_ring_dataset(...) — offline "
                "device_cf_dataset views are shared/memoized and must stay "
                "immutable")
        users = np.asarray(user_ids).reshape(-1)
        items = np.asarray(item_ids).reshape(-1)
        if users.shape != items.shape or np.ndim(user_ids) != 1:
            raise ValueError(f"event arrays must be equal-length 1-D, got "
                             f"{np.shape(user_ids)} vs {np.shape(item_ids)}")
        APPLY_EVENTS_SHAPES.add(users.shape)
        # one host-to-device copy of both columns
        events = torch.as_tensor(np.stack([users, items]).astype(np.int64),
                                 device=self.train_pos.device)
        new_u, new_i = _apply_events_(
            self.train_pos, self.item_weights, self.row_count, self.write_pos,
            events[0], events[1])
        return self, new_u, new_i


def _apply_events_(train_pos, item_weights, row_count, write_pos, users,
                   items):
    """The reference's sequential ring fold (``_apply_events_impl``, a
    per-event ``fori_loop``) as a fixed number of vectorized launches, bit
    for bit and with no host sync:

    1. stable-sort the events by user (padding last), so each user's events
       form a run in arrival order, and take each event's rank in its run;
    2. event ``r`` of ``n_u`` writes slot ``(write_pos[u] + r) % capacity``,
       and the slot ends holding the last event that writes it, the one of
       rank ``r + capacity * ((n_u - 1 - r) // capacity)``: every event
       writes that final value, so duplicate (user, slot) writes agree and
       ``index_put_`` needs no winner (padding repeats the first event's
       write, or rewrites ``train_pos[0, 0]`` when the batch is all
       padding);
    3. ``write_pos[u] += n_u`` mod capacity, ``row_count[u] = min(row_count[u]
       + n_u, capacity)``, from integer ``index_add_`` counts;
    4. popularity counts take ``index_add_`` of ones (fp32 integers, exact
       to 2^24 in any order; padding adds 0 to item 0, as in the reference).

    Updates the four tensors in place; returns the first-seen masks."""
    capacity = train_pos.shape[1]
    num_users = train_pos.shape[0]
    n = users.shape[0]
    dev = users.device
    valid = users >= 0
    seen_user = row_count > 0
    seen_item = item_weights > 0
    item_weights.index_add_(0, torch.where(valid, items, 0),
                            valid.to(item_weights.dtype))
    if n == 0:
        return (row_count > 0) & ~seen_user, (item_weights > 0) & ~seen_item

    key = torch.where(valid, users, num_users)
    order = torch.argsort(key, stable=True)
    su, si = key[order], items[order]
    pos = torch.arange(n, device=dev)
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = su[1:] != su[:-1]
    run_start = torch.cummax(torch.where(start, pos, 0), 0).values
    run_id = torch.cumsum(start.to(torch.int64), 0) - 1
    run_len = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, run_id, torch.ones_like(run_id))[run_id]
    rank = pos - run_start
    final = rank + capacity * torch.div(run_len - 1 - rank, capacity,
                                        rounding_mode="floor")
    ok = su < num_users
    u = torch.where(ok, su, 0)
    slot = (write_pos[u] + rank) % capacity
    val = si[run_start + final]
    # padding repeats event 0's write (itself padding only when all are)
    u0 = torch.where(ok[0], u[0], 0)
    slot0 = torch.where(ok[0], slot[0], 0)
    val0 = torch.where(ok[0], val[0], train_pos[0, 0])
    train_pos.index_put_((torch.where(ok, u, u0), torch.where(ok, slot, slot0)),
                         torch.where(ok, val, val0))

    counts = torch.zeros_like(row_count).index_add_(
        0, torch.where(valid, users, 0), valid.to(row_count.dtype))
    write_pos.copy_((write_pos + counts) % capacity)
    torch.clamp_max(row_count + counts, capacity, out=row_count)
    return (row_count > 0) & ~seen_user, (item_weights > 0) & ~seen_item


_DEVICE_VIEWS: dict = {}


def device_cf_dataset(ds: CFDataset, device, *,
                      allow_empty_users: Optional[bool] = None
                      ) -> DeviceCFDataset:
    """Upload ``train_pos`` and the items' training-interaction counts once,
    ahead of the epoch (the counts as the reference's ``device_cf_dataset``
    makes them).

    Memoized per (``CFDataset`` instance, device), and dropped when the
    dataset is garbage-collected, so repeated callers share one device copy;
    datasets are treated as immutable (a streaming view that changes is
    :func:`stream_ring_dataset`'s).

    A zero-interaction user has an empty sample range: a batch row drawn
    for it falls back to a uniform item (:func:`cf_batch_device`).
    ``allow_empty_users`` sets the contract, with the reference's messages:

    * ``None`` (default): empty users are tolerated, but an *all*-empty
      dataset (the cold-start stream case) raises, because every batch row
      would be fallback noise; cold starts belong to
      :func:`stream_ring_dataset`.
    * ``False``: any empty user raises (strict offline mode).
    * ``True``: anything goes (the caller owns sampling)."""
    empty = ~(ds.train_pos >= 0).any(axis=1)
    if allow_empty_users is not True:
        if empty.all() and ds.num_users > 0:
            raise ValueError(
                "every user has zero train interactions — an offline device "
                "view would sample pure fallback noise.  For cold-start "
                "streaming build the view with stream_ring_dataset(...) and "
                "feed it events via apply_events; pass "
                "allow_empty_users=True to override")
        if allow_empty_users is False and empty.any():
            raise ValueError(
                f"{int(empty.sum())} user(s) have zero train interactions "
                "(empty sample ranges); their batch rows fall back to a "
                "uniform item draw — pass allow_empty_users=None to accept "
                "the fallback or clean the dataset")
    device = torch.device(device)
    key = (id(ds), str(device))
    view = _DEVICE_VIEWS.get(key)
    if view is None:
        counts = np.bincount(ds.train_pos[ds.train_pos >= 0].ravel(),
                             minlength=ds.num_items)
        view = DeviceCFDataset(ds.num_users, ds.num_items,
                               torch.as_tensor(ds.train_pos, dtype=torch.int64,
                                               device=device),
                               torch.as_tensor(counts, dtype=torch.float32,
                                               device=device))
        _DEVICE_VIEWS[key] = view
        weakref.finalize(ds, _DEVICE_VIEWS.pop, key, None)
    return view


def stream_ring_dataset(num_users: int, num_items: int, capacity: int = 32,
                        *, base: Optional[CFDataset] = None,
                        device=None) -> DeviceCFDataset:
    """A streaming view on ``device`` (the card unless the caller names
    another): each user's positives in a fixed-capacity ring.

    ``base=None`` starts cold — empty rings and zero popularity (legal here,
    unlike :func:`device_cf_dataset`, because :func:`stream_batch_device`
    draws only users with ``row_count > 0`` and the service never trains
    before the first event).  With ``base`` (whose shape must match) each
    ring starts with the newest ``capacity`` stored positives of the user
    (``row[row >= 0][-capacity:]``, at the front) and the popularity counts
    are recounted from exactly what the rings hold.  The view is private:
    ``apply_events`` updates its tensors in place."""
    if capacity < 1:
        raise ValueError(f"ring capacity must be >= 1, got {capacity}")
    dev = resolve_device(device)
    train = np.full((num_users, capacity), -1, np.int32)
    if base is not None:
        if (base.num_users, base.num_items) != (num_users, num_items):
            raise ValueError(
                f"base dataset is {base.num_users}x{base.num_items}, "
                f"asked for {num_users}x{num_items}")
        ok = base.train_pos >= 0
        rank = np.cumsum(ok, axis=1) - 1            # rank among valid entries
        drop = np.maximum(ok.sum(axis=1, keepdims=True) - capacity, 0)
        keep = ok & (rank >= drop)
        rows, _ = np.nonzero(keep)
        train[rows, (rank - drop)[keep]] = base.train_pos[keep]
    counts = np.bincount(train[train >= 0].ravel(), minlength=num_items)
    row_count = (train >= 0).sum(axis=1).astype(np.int64)
    return DeviceCFDataset(
        num_users, num_items,
        torch.as_tensor(train, dtype=torch.int64, device=dev),
        torch.as_tensor(counts, dtype=torch.float32, device=dev),
        row_count=torch.as_tensor(row_count, device=dev),
        write_pos=torch.as_tensor(row_count % capacity, device=dev))


def cf_batch_device(ds: DeviceCFDataset, seed: int, step: int,
                    batch_size: int, history_len: int = 0) -> Batch:
    """Users uniform over the dataset and one train positive each, drawn on
    the dataset's device; pure in (seed, step).

    A drawn padding slot (-1) falls back to the user's column 0; a user with
    no positive at all falls back to a uniform item, as in the reference.
    With ``history_len > 0`` the batch also carries the user's first
    ``history_len`` train columns as history (``train_pos[users,
    :history_len]``, so at most the dataset's width), padding masked out and
    pointed at item 0, as the reference's ``_cf_batch_from``."""
    return _batch_from(ds.train_pos, ds.num_users, ds.num_items, seed, step,
                       batch_size, history_len)


def cf_batch(ds: CFDataset, step: int, batch_size: int, history_len: int = 0,
             seed: int = 0, *, device=None) -> Batch:
    """The batch of :func:`cf_batch_device` from the host dataset, bit for
    bit: ``train_pos`` is uploaded to ``device`` (the card unless the
    caller names another; see ``mf.resolve_device``) on every call, so a
    loop holds a :func:`device_cf_dataset` view instead."""
    train_pos = torch.as_tensor(ds.train_pos, dtype=torch.int64,
                                device=resolve_device(device))
    return _batch_from(train_pos, ds.num_users, ds.num_items, seed, step,
                       batch_size, history_len)


def cf_batch_shard(ds: DeviceCFDataset, seed: int, step: int,
                   global_batch: int, shard: int, num_shards: int,
                   history_len: int = 0) -> Batch:
    """Shard ``shard``'s rows of the *global* (seed, step) batch: every shard
    draws the whole batch (ids only, cheap) and keeps its contiguous row
    range, so the concatenated shards equal :func:`cf_batch_device`'s batch
    bit for bit."""
    start, stop = shard_bounds(global_batch, num_shards)[shard]
    full = cf_batch_device(ds, seed, step, global_batch, history_len)
    return Batch(*(None if x is None else x[start:stop] for x in full))


def _batch_from(train_pos: torch.Tensor, num_users: int, num_items: int,
                seed: int, step: int, batch_size: int,
                history_len: int) -> Batch:
    """The one (seed, step)-pure batch draw behind :func:`cf_batch_device`
    and :func:`cf_batch`."""
    gen = generator(fold_in(fold_in(seed, step), BATCH_STREAM),
                    train_pos.device)
    users = torch.randint(0, num_users, (batch_size,), generator=gen,
                          device=train_pos.device)
    cols = torch.randint(0, train_pos.shape[1], (batch_size,), generator=gen,
                         device=train_pos.device)
    uniform = torch.randint(0, num_items, (batch_size,), generator=gen,
                            device=train_pos.device)
    pos = train_pos[users, cols]
    pos = torch.where(pos >= 0, pos, train_pos[users, 0])
    pos = torch.where(pos >= 0, pos, uniform)
    hist_ids = hist_mask = None
    if history_len > 0:
        h = train_pos[users, :history_len]
        hist_mask = (h >= 0).to(torch.float32)
        hist_ids = torch.where(h >= 0, h, 0)
    return Batch(user_ids=users, pos_ids=pos, hist_ids=hist_ids,
                 hist_mask=hist_mask)


class RingDraw(NamedTuple):
    """What a ring draw needs that changes only at ingest, computed once a
    round by :func:`ring_draw` instead of at every step: the running count
    of active users (``row_count > 0``) that :func:`ring_users` searches,
    and the fp32 recency constants ``q = exp(-recency)`` and ``log q`` (0-d
    device tensors; ``None`` at ``recency=0``)."""

    active: torch.Tensor
    q: Optional[torch.Tensor]
    log_q: Optional[torch.Tensor]


def ring_draw(ds: DeviceCFDataset, recency: float = 0.0) -> RingDraw:
    """The :class:`RingDraw` of a ring view; pure in its ``row_count``, so
    it stays valid until the next ``apply_events``."""
    if ds.row_count is None or ds.write_pos is None:
        raise ValueError("stream_batch_device needs a ring view "
                         "(stream_ring_dataset), not an offline one")
    active = torch.cumsum((ds.row_count > 0).to(torch.int64), 0)
    if recency <= 0.0:
        return RingDraw(active, None, None)
    q = float(np.exp(-recency))
    dev = ds.train_pos.device
    # 0-d device tensors, so the division is elementwise true division (a
    # Python divisor may become a multiply by its reciprocal); filled on the
    # device, not copied from the host (a blocking copy that synchronizes
    # the stream)
    return RingDraw(active,
                    torch.full((), q, dtype=torch.float32, device=dev),
                    torch.full((), math.log(q), dtype=torch.float32,
                               device=dev))


def ring_users(row_count: torch.Tensor, u: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Users drawn uniformly over those with ``row_count > 0`` from fp64
    uniforms ``u`` in [0, 1), on the device and with no host sync: draw
    ``j = floor(u * count)`` with ``count`` a device scalar, then take the
    ``j``-th active user through ``searchsorted`` over ``active``, the
    running count of active users (:attr:`RingDraw.active`; recomputed from
    ``row_count`` when not given).  The reference draws the same
    distribution (a categorical over equal logits); with no active user
    every draw is user 0, as there."""
    if active is None:
        active = torch.cumsum((row_count > 0).to(torch.int64), 0)
    count = active[-1]
    j = torch.minimum(torch.floor(u * count).to(torch.int64).clamp_min(0),
                      count - 1)
    users = torch.searchsorted(active, j, right=True)
    return users.clamp_max(row_count.shape[0] - 1)


def stream_batch_from(ds: DeviceCFDataset, users: torch.Tensor,
                      u01: torch.Tensor, *, recency: float = 0.0,
                      history_len: int = 0,
                      draw: Optional[RingDraw] = None) -> Batch:
    """The deterministic part of :func:`stream_batch_device`: drawn users
    (int64) and fp32 uniforms ``u01`` -> the batch, in the reference's
    arithmetic (``src/repro/data/pipeline.py:389-411``).

    User ``u`` takes its positive at ring age ``a`` (0 = newest) from the
    truncated geometric ``P(a) ~ exp(-recency * a)`` over its valid ages,
    by the fp32 inverse CDF ``floor(log1p(-u01 * (1 - q^count)) / log q)``
    with ``q = exp(-recency)`` (``recency=0``: uniform over the ring); an
    empty slot falls back to item 0.  With ``history_len > 0`` the history
    is the user's newest ``history_len`` ring entries, invalid ones masked
    out and pointed at item 0.  ``draw`` is the ring's :func:`ring_draw`
    for this ``recency`` (computed here when not given)."""
    if draw is None:
        draw = ring_draw(ds, recency)
    capacity = ds.train_pos.shape[1]
    dev = ds.train_pos.device
    count = torch.clamp_min(ds.row_count[users], 1).to(torch.float32)
    if recency > 0.0:
        age = torch.floor(torch.log1p(-u01 * (1.0 - torch.pow(draw.q, count)))
                          / draw.log_q)
    else:
        age = torch.floor(u01 * count)
    age = torch.minimum(torch.clamp_min(age, 0), count - 1).to(torch.int64)
    wp = ds.write_pos[users]
    pos = ds.train_pos[users, (wp - 1 - age) % capacity]
    pos = torch.where(pos >= 0, pos, 0)
    hist_ids = hist_mask = None
    if history_len > 0:
        h_age = torch.arange(history_len, device=dev)[None, :]
        h = ds.train_pos[users[:, None], (wp[:, None] - 1 - h_age) % capacity]
        h_ok = (h_age < ds.row_count[users, None]) & (h >= 0)
        hist_mask = h_ok.to(torch.float32)
        hist_ids = torch.where(h_ok, h, 0)
    return Batch(user_ids=users, pos_ids=pos, hist_ids=hist_ids,
                 hist_mask=hist_mask)


def stream_batch_device(ds: DeviceCFDataset, seed: int, step: int,
                        batch_size: int, *, recency: float = 0.0,
                        history_len: int = 0,
                        draw: Optional[RingDraw] = None) -> Batch:
    """Recency-weighted batch over a streaming ring view, drawn on its
    device with no host sync; pure in (seed, step, ring state).

    Users are uniform over the users with at least one ingested positive
    (:func:`ring_users`, fp64 uniforms); each contributes one positive at a
    recency-weighted ring age (:func:`stream_batch_from`, fp32 uniforms).
    Both draws come from ``fold_in(fold_in(seed, step), RING_STREAM)``, apart
    from the step's own ``fold_in(seed, step)`` draws.  With no event
    ingested yet every row is user 0 / item 0; the service never trains
    then.  ``draw`` is the ring's :func:`ring_draw` for this ``recency``,
    which a caller drawing many batches between ingests computes once
    (computed here when not given)."""
    if draw is None:
        draw = ring_draw(ds, recency)
    dev = ds.train_pos.device
    gen = generator(fold_in(fold_in(seed, step), RING_STREAM), dev)
    u_user = torch.rand((batch_size,), generator=gen, dtype=torch.float64,
                        device=dev)
    u01 = torch.rand((batch_size,), generator=gen, device=dev)
    return stream_batch_from(ds, ring_users(ds.row_count, u_user, draw.active),
                             u01, recency=recency, history_len=history_len,
                             draw=draw)


def procedural_cf_batch(step: int, batch_size: int, num_users: int,
                        num_items: int, num_clusters: int = 64, seed: int = 0,
                        *, device=None) -> Batch:
    """Batches at any table size without a dataset, pure in (seed, step):
    users uniform, user u in cluster ``u % num_clusters``, its positive at a
    power-law offset ``floor(block * v^3)`` (fp32, ``v`` uniform) into that
    cluster's contiguous block of ``num_items // num_clusters`` items, as
    the reference draws it.  Drawn on ``device`` (the card unless the caller
    names another)."""
    dev = resolve_device(device)
    gen = generator(fold_in(fold_in(seed, step), BATCH_STREAM), dev)
    users = torch.randint(0, num_users, (batch_size,), generator=gen,
                          device=dev)
    v = torch.rand((batch_size,), generator=gen, device=dev)
    block = max(num_items // num_clusters, 1)
    offset = torch.clamp_max((block * v ** 3).to(torch.int64), block - 1)
    pos = (users % num_clusters) * block + offset
    return Batch(user_ids=users, pos_ids=torch.clamp_max(pos, num_items - 1))


def lm_batch(step: int, batch_size: int, seq_len: int, vocab: int,
             seed: int = 0, device="cpu", extras: Optional[dict] = None) -> dict:
    """Synthetic LM batch ``{"tokens": (B, S) int64}`` on ``device``, pure
    in (seed, step): uniform tokens of which half the positions (a fair coin
    each) copy their predecessor, the reference's Markov structure, so the
    loss has signal to learn.  Drawn from ``fold_in(fold_in(seed, step),
    BATCH_STREAM)`` on the device.

    ``extras`` (``{name: (shape, dtype)}``, e.g. a VLM's ``patches``) adds
    one tensor per name, 0.1 times unit normals of that shape and dtype,
    each from its own stream ``fold_in(<the batch's key>, crc32(name))``:
    pure in (seed, step, name), keyed by CRC-32 as the reference keys it
    (never ``hash``, whose string hashes are salted per process), and the
    tokens are the same with or without extras."""
    key = fold_in(fold_in(seed, step), BATCH_STREAM)
    gen = generator(key, device)
    base = torch.randint(0, vocab, (batch_size, seq_len), generator=gen,
                         device=device)
    copy = torch.rand((batch_size, seq_len), generator=gen, device=device) < 0.5
    shifted = torch.cat([base[:, :1], base[:, :-1]], dim=1)
    batch = {"tokens": torch.where(copy, shifted, base)}
    for name, (shape, dtype) in (extras or {}).items():
        g = generator(fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF), device)
        batch[name] = torch.randn(tuple(shape), generator=g, dtype=dtype,
                                  device=device) * 0.1
    return batch
