"""Mesh context and the explicit exchanges of sharded training (the port of
``src/repro/distributed/sharding.py``).

Axis conventions are the reference's:
  - ``pod``   cross-pod data parallelism (outermost)
  - ``data``  in-pod data parallelism (batch rows, user-table rows)
  - ``model`` item-table rows

A :class:`Mesh` lays those axes over an initialized ``torch.distributed``
process group, rank-major like ``jax.make_mesh``'s device grid (rank =
``(pod * data + d) * model + m``), and builds one subgroup per axis, plus
one over the data axes together when both are present.  The active mesh is
a process-global, installed by the launcher with :func:`set_mesh` or
:func:`use_mesh`, as in the reference.

The reference runs one global program and lets GSPMD insert collectives
from sharding annotations (``constrain``, ``replicated``, ``named``); its
``shard_map`` and ``tree_shardings`` are GSPMD machinery too.  None of them
has a counterpart here.  Each rank runs its own program and the exchanges
are explicit:

  - :meth:`RowShard.lookup`, the owner-masked row lookup: every member of
    the group holds the same ids, gathers the rows it owns and zeros for the
    rest; the parts are all-gathered and each row is taken from its owner's
    part, so the result is the rows' exact bits.
  - :func:`all_gather_parts`, the all-gather of a step's (ids, grads) along
    the data axes: the parts come back in group order, which is the global
    batch order, packed into one byte buffer so a step's exchange is one
    collective.
  - :func:`sum_over`: a sum across ranks is an all-gather followed by a sum
    in group order on every rank.  No ``all_reduce`` is used, so the
    replicas hold the same bits whatever order a backend sums in.

The LM's sharded step differentiates through its exchanges, so these have
autograd forms: :func:`copy_to` (identity forward, sum over the group
backward) and :func:`reduce_from` (sum forward, identity backward), the
pair around the expert-parallel MoE; :func:`gather_leaves`, the all-gather
of sharded parameter slices whose backward slices the gradient (a ``model``
group, whose ranks compute the same gradient) or sums it over the group
first (a data group, whose ranks see other rows: a reduce-scatter); and
:func:`row_lookup`, the owner-masked lookup whose gradient lands only in
the owner's rows (:class:`ShardedRows`, the vocab tables).

Gloo cannot address CUDA memory for an all-gather, so a gloo group stages
CUDA tensors through the host (two ranks sharing one card run gloo; NCCL
refuses two ranks on one card).  A group of one rank exchanges nothing.

:class:`ExchangeCounter` counts the bytes every exchange moves, under the
reference's five collective kinds (:data:`EXCHANGE_KINDS`): each
collective adds the bytes of its result on this rank, as the reference's
dry run sums the result shapes of its HLO collectives.  Every exchange
here is an all-gather and is counted as one, whatever the caller computes
with it: ``sum_over`` (an all-reduce's work) and ``gather_leaves``'
backward over a data group (a reduce-scatter's) gather every member's
whole operand and sum it locally, so their result is the group's size
times the operand, where an all-reduce's is the operand and a
reduce-scatter's a group's share of it.  The other four kinds stay 0.
With no counter active the count costs one ``None`` test.  On ``meta`` tensors (the dry run) the two places here whose
sizes depend on the data take a fixed size and name themselves in the
counter's ``bounded``: :meth:`RowShard.owned` keeps the whole update list,
masked (the reference's fixed-shape form), and :func:`all_gather_rows`
takes every member's row count as this rank's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import tiling

DATA_AXES = ("pod", "data")     # batch rows shard over every present data-like axis
MODEL_AXIS = "model"
AXES = ("pod", "data", "model")

#: the reference's collective kinds (``launch/dryrun.py::_COLLECTIVES``).
EXCHANGE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

#: seconds a rank waits on a collective, a rendezvous or a subgroup's
#: creation before it fails (a dead peer must fail a run, not hang it).
COLLECTIVE_TIMEOUT_S = 60


class PartitionSpec(tuple):
    """Stand-in for ``jax.sharding.PartitionSpec``: one entry per dimension,
    each an axis name, a tuple of axis names, or None (not sharded); a
    tuple of one name is that name, as jax writes it."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks that differ only in ``axes`` (this rank's among them):
    ``ranks`` in group order (row-major over ``axes``), ``index`` this
    rank's position, ``pg`` the process group (None for a group of one)."""

    axes: tuple
    ranks: tuple
    index: int
    pg: Any = None

    @property
    def size(self) -> int:
        """Number of ranks in the group."""
        return len(self.ranks)

    @property
    def over_data(self) -> bool:
        """Whether the group spans a data axis (its ranks hold other batch
        rows, so their gradients are partial sums)."""
        return any(a in DATA_AXES for a in self.axes)


class Mesh:
    """A named grid of ranks over the initialized default process group.

    ``shape`` maps axis names (from :data:`AXES`, outermost first) to sizes
    whose product must equal the world size; a mesh of one rank needs no
    process group.  ``coords`` is this rank's position on each axis."""

    def __init__(self, shape: dict):
        names = tuple(shape)
        bad = [n for n in names if n not in AXES]
        if bad or len(set(names)) != len(names):
            raise ValueError(f"mesh axes must be distinct names from {AXES}, "
                             f"got {names}")
        self.axis_names = names
        self.sizes = tuple(int(shape[n]) for n in names)
        self.size = math.prod(self.sizes)
        if dist.is_available() and dist.is_initialized():
            self.rank, world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, world = 0, 1
        if world != self.size:
            raise ValueError(
                f"a mesh of shape {dict(shape)} needs {self.size} ranks; the "
                f"process group has {world}")
        self.coords = dict(zip(names, self._coords_of(self.rank)))
        self._groups = {}
        combos = [(n,) for n in names]
        data = tuple(a for a in DATA_AXES if a in names)
        if len(data) > 1:
            combos.append(data)
        for axes in combos:
            self._groups[axes] = self._make_group(axes)

    def _coords_of(self, rank: int) -> tuple:
        out = []
        for s in reversed(self.sizes):
            rank, c = divmod(rank, s)
            out.append(c)
        return tuple(reversed(out))

    def _make_group(self, axes: tuple) -> AxisGroup:
        # Every rank creates every subgroup, in the same order, as
        # dist.new_group requires; each keeps its own.
        others = [i for i, n in enumerate(self.axis_names) if n not in axes]
        members: dict = {}
        for r in range(self.size):
            c = self._coords_of(r)
            members.setdefault(tuple(c[i] for i in others), []).append(r)
        mine = None
        for ranks in members.values():
            pg = None
            if len(ranks) > 1:
                pg = dist.new_group(ranks, timeout=datetime.timedelta(
                    seconds=COLLECTIVE_TIMEOUT_S))
            if self.rank in ranks:
                mine = AxisGroup(axes, tuple(ranks), ranks.index(self.rank), pg)
        return mine

    @property
    def shape(self) -> dict:
        """``{axis: size}`` in axis order."""
        return dict(zip(self.axis_names, self.sizes))

    def group(self, axes) -> AxisGroup:
        """The group of the ranks that differ only in ``axes`` (a name, a
        tuple of names, or None); axes absent from the mesh are dropped, and
        no axis left gives this rank alone."""
        if axes is None:
            axes = ()
        elif isinstance(axes, str):
            axes = (axes,)
        kept = tuple(a for a in self.axis_names if a in axes)
        if not kept or math.prod(self.shape[a] for a in kept) == 1:
            return AxisGroup((), (self.rank,), 0, None)
        if kept not in self._groups:
            raise KeyError(f"no subgroup over {kept}; the mesh has one per "
                           f"axis and one over {DATA_AXES}")
        return self._groups[kept]

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        if self.size > 1:
            dist.barrier()

    def broadcast(self, obj, src: int = 0):
        """``obj`` of rank ``src`` (any picklable value) on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]):
    """Install ``mesh`` as the process-global active mesh (None clears it)."""
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    """The active mesh, or None when running single-device."""
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Context manager: install ``mesh`` for the block, restore on exit."""
    prev = _MESH
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def mesh_axes() -> frozenset:
    """Axis names of the active mesh (empty frozenset when none)."""
    return frozenset(_MESH.axis_names) if _MESH is not None else frozenset()


def resolve(spec) -> PartitionSpec:
    """Drop logical axes that the active mesh does not have."""
    axes = mesh_axes()

    def keep(ax):
        if ax is None:
            return None
        if isinstance(ax, tuple):
            kept = tuple(a for a in ax if a in axes)
            return kept if kept else None
        return ax if ax in axes else None

    return P(*(keep(ax) for ax in spec))


def batch_spec(*trailing) -> PartitionSpec:
    """``P(("pod", "data"), *trailing)`` resolved against the mesh."""
    return resolve(P(DATA_AXES, *trailing))


def active_mesh() -> Optional[Mesh]:
    """The installed mesh when it can actually shard (more than one rank),
    else None: the guard sharded paths use to fall back to single-device."""
    if _MESH is None or _MESH.size <= 1:
        return None
    return _MESH


def data_shards() -> int:
    """Product of the data-parallel axis sizes of the active mesh."""
    if _MESH is None:
        return 1
    return math.prod(_MESH.shape.get(a, 1) for a in DATA_AXES)


def model_shards() -> int:
    """Size of the model axis of the active mesh (1 when absent)."""
    if _MESH is None:
        return 1
    return _MESH.shape.get(MODEL_AXIS, 1)


# ----------------------------------------------------------------------------
# The exchange byte counter
# ----------------------------------------------------------------------------

class ExchangeCounter:
    """Bytes of every exchange issued while it is active, by kind.

    ``with ExchangeCounter() as c: ...`` makes ``c`` the active counter
    (counters nest; the innermost counts).  ``bytes[kind]`` sums the
    result bytes of each collective on this rank by the reference's kinds
    (every exchange here is an all-gather, whose result is the group's
    size times the packed buffer), ``by_axes[axes]`` the same bytes by the
    axes of the group they crossed, and ``bounded`` names the places whose
    size was taken as an upper bound on ``meta`` tensors (the module
    docstring)."""

    def __init__(self):
        self.bytes = dict.fromkeys(EXCHANGE_KINDS, 0)
        self.by_axes: dict = {}
        self.bounded: set = set()
        self._prev = None

    @property
    def total(self) -> int:
        """Bytes of every kind together."""
        return sum(self.bytes.values())

    def __enter__(self):
        global _COUNTER
        self._prev, _COUNTER = _COUNTER, self
        return self

    def __exit__(self, *exc):
        global _COUNTER
        _COUNTER = self._prev
        return False


_COUNTER: Optional[ExchangeCounter] = None


def note_bounded(name: str) -> None:
    """Record in the active counter that the exchange ``name`` took an
    upper bound of its size (a ``meta`` run); nothing without one."""
    if _COUNTER is not None:
        _COUNTER.bounded.add(name)


# ----------------------------------------------------------------------------
# Exchanges
# ----------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_parts(parts: Sequence[torch.Tensor], group: AxisGroup) -> list:
    """Every member's ``parts`` in group order: ``out[j][i]`` is member
    ``j``'s ``parts[i]``.  Every member must pass parts of the same shapes
    and dtypes.  The parts travel packed in one byte buffer (each part
    padded to 8 bytes), so this is one collective, counted by the active
    :class:`ExchangeCounter`."""
    if group.size == 1:
        return [list(parts)]
    dev = parts[0].device
    sizes = [_nbytes(p) for p in parts]
    padded = [-(-s // 8) * 8 for s in sizes]
    flat = torch.zeros(sum(padded), dtype=torch.uint8, device=dev)
    offsets = list(itertools.accumulate([0] + padded))
    for p, o, s in zip(parts, offsets, sizes):
        flat[o:o + s] = p.detach().contiguous().reshape(-1).view(torch.uint8)
    staged = dist.get_backend(group.pg) == "gloo" and flat.is_cuda
    send = flat.cpu() if staged else flat
    recv = [torch.empty_like(send) for _ in range(group.size)]
    dist.all_gather(recv, send, group=group.pg)
    if _COUNTER is not None:
        n = group.size * _nbytes(send)
        _COUNTER.bytes["all-gather"] += n
        _COUNTER.by_axes[group.axes] = _COUNTER.by_axes.get(group.axes, 0) + n
    got = torch.stack(recv).to(dev) if staged else torch.stack(recv)
    return [[got[j, o:o + s].view(p.dtype).reshape(p.shape)
             for p, o, s in zip(parts, offsets, sizes)]
            for j in range(group.size)]


def sum_over(tensors: Sequence[torch.Tensor], group: AxisGroup) -> list:
    """Each tensor summed over the group's members, in group order, on every
    member (the same bits everywhere); one all-gather for all of them."""
    if group.size == 1:
        return list(tensors)
    members = all_gather_parts(tensors, group)
    out = [t.clone() for t in members[0]]
    for parts in members[1:]:
        for acc, t in zip(out, parts):
            acc.add_(t)
    return out


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows`` rows."""
    if x.shape[0] == rows:
        return x
    pad = torch.zeros((rows - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def shard_bounds(global_batch: int, num_shards: int) -> list:
    """Contiguous ``[start, stop)`` row ranges partitioning a global batch.

    Remainder rows (``global_batch % num_shards``) go one per shard to the
    lowest shard indices, so sizes differ by at most one and the
    concatenation of all shards is exactly the global batch."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    base, rem = divmod(global_batch, num_shards)
    bounds, start = [], 0
    for s in range(num_shards):
        stop = start + base + (1 if s < rem else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A table's rows split over ``group``: member ``j`` holds rows
    ``bounds[j]`` of ``num_rows``; a group of one holds them all."""

    group: AxisGroup
    num_rows: int

    def __post_init__(self):
        if self.num_rows < self.group.size:
            raise ValueError(f"{self.num_rows} rows cannot be split over "
                             f"{self.group.size} ranks")

    @property
    def bounds(self) -> list:
        """``[start, stop)`` of each member, in group order."""
        return shard_bounds(self.num_rows, self.group.size)

    @property
    def own(self) -> tuple:
        """``(start, stop)`` of this rank's rows."""
        return self.bounds[self.group.index]

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole table (a view)."""
        lo, hi = self.own
        return whole[lo:hi]

    def lookup(self, local: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` (any shape; the same ids on every member) of the
        sharded table whose local part is ``local``: exact, owner-masked."""
        if self.group.size == 1:
            return tiling.gather_rows(local, ids)
        lo, hi = self.own
        mine = (ids >= lo) & (ids < hi)
        rows = local[(ids - lo).clamp(0, hi - lo - 1)]
        rows = torch.where(mine[..., None], rows, 0.0)
        parts = torch.stack([m[0] for m in all_gather_parts([rows],
                                                            self.group)])
        starts = torch.tensor([b[0] for b in self.bounds[1:]],
                              dtype=ids.dtype, device=ids.device)
        owner = torch.bucketize(ids, starts, right=True)
        return parts.gather(0, owner[None, ..., None].expand(
            (1,) + tuple(rows.shape)))[0]

    def owned(self, ids: torch.Tensor, grads: torch.Tensor):
        """The entries of an update list ``(ids (...), grads (..., K))``
        that address this rank's rows, in their order, with local ids (the
        whole list, flattened, for a group of one)."""
        ids = ids.reshape(-1)
        grads = grads.reshape(-1, grads.shape[-1])
        if self.group.size == 1:
            return ids, grads
        lo, hi = self.own
        keep = (ids >= lo) & (ids < hi)
        if ids.device.type == "meta":
            # No data to size the kept list: the whole list, the other
            # ranks' entries masked to a zero update of local row 0.
            note_bounded("RowShard.owned")
            return (torch.where(keep, ids - lo, 0),
                    torch.where(keep[:, None], grads, 0.0))
        return ids[keep] - lo, grads[keep]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole table from every member's rows (on every member)."""
        if self.group.size == 1:
            return local
        bounds = self.bounds
        most = max(hi - lo for lo, hi in bounds)
        parts = all_gather_parts([pad_rows(local, most)], self.group)
        return torch.cat([p[0][:hi - lo] for p, (lo, hi) in zip(parts, bounds)])


def all_gather_cat(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    """Every member's ``x`` (the same shape on each) concatenated along
    ``dim`` in group order (no autograd)."""
    if group.size == 1:
        return x
    return torch.cat([p[0] for p in all_gather_parts([x], group)], dim)


def all_gather_rows(x: torch.Tensor, group: AxisGroup, offset: bool = False):
    """Every member's rows ``x`` (the row counts may differ) concatenated
    in group order (no autograd): the counts travel first.  With
    ``offset``, returns ``(rows, the index of this member's first row)``."""
    if group.size == 1:
        return (x, 0) if offset else x
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    got = all_gather_parts([n], group)
    if x.device.type == "meta":      # no counts to read: every member's is ours
        note_bounded("all_gather_rows")
        counts = [x.shape[0]] * group.size
    else:
        counts = [int(c[0][0]) for c in got]
    parts = all_gather_parts([pad_rows(x, max(counts))], group)
    rows = torch.cat([p[0][:c] for p, c in zip(parts, counts)])
    return (rows, sum(counts[:group.index])) if offset else rows


def _own_slice(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.index * n, n)


def _gather_stage(xs: list, plans: list, stage) -> list:
    """One exchange per group, in ``stage`` order: every (tensor, dim)
    sharded over that group is all-gathered in one collective."""
    out = list(xs)
    for key in stage:
        hits = [(i, d, g) for i, plan in enumerate(plans) for d, g in plan
                if g.axes == key]
        if not hits:
            continue
        group = hits[0][2]
        got = all_gather_parts([out[i].contiguous() for i, _, _ in hits],
                               group)
        for j, (i, d, _) in enumerate(hits):
            out[i] = torch.cat([m[j] for m in got], d)
    return out


def _group_order(plans: list) -> list:
    keys = []
    for plan in plans:
        for _, g in plan:
            if g.axes not in keys:
                keys.append(g.axes)
    return keys


class _GatherLeaves(torch.autograd.Function):
    """Whole tensors from sharded slices; see :func:`gather_leaves`."""

    @staticmethod
    def forward(ctx, plans, *xs):
        ctx.plans = plans
        return tuple(_gather_stage(list(xs), plans, _group_order(plans)))

    @staticmethod
    def backward(ctx, *grads):
        plans = ctx.plans
        grads = list(grads)
        for key in reversed(_group_order(plans)):
            hits = [(i, d, g) for i, plan in enumerate(plans) for d, g in plan
                    if g.axes == key]
            group = hits[0][2]
            if group.over_data:          # ranks of other rows: sum first
                summed = sum_over([grads[i] for i, _, _ in hits], group)
                for (i, _, _), s in zip(hits, summed):
                    grads[i] = s
            for i, d, _ in hits:
                grads[i] = _own_slice(grads[i], d, group).contiguous()
        return (None, *grads)


def gather_leaves(xs: Sequence[torch.Tensor], plans: Sequence) -> list:
    """The whole tensors of sharded slices ``xs``; ``plans[i]`` lists
    ``(dim, group)`` of each sharded dimension of ``xs[i]``.  One
    collective per group for all tensors.  Backward: the gradient of a
    dimension sharded over ``model`` is sliced (every model rank computed
    the same whole gradient), that of one sharded over a data group is
    summed over the group and then sliced (a reduce-scatter)."""
    return list(_GatherLeaves.apply(list(plans), *xs))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_over([g.contiguous()], ctx.group)[0], None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return sum_over([x.contiguous()], group)[0]

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Identity forward; backward sums the gradient over ``group``: the
    entry of a replicated value into per-rank partial work."""
    return x if group.size == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Sum over ``group`` forward (group order, the same bits on every
    member); identity backward: the exit of per-rank partial results."""
    return x if group.size == 1 else _ReduceFrom.apply(x, group)


class _RowLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, ids, shard):
        ctx.save_for_backward(ids)
        ctx.shard, ctx.rows = shard, local.shape[0]
        return shard.lookup(local, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        lo, hi = ctx.shard.own
        idx = torch.where((ids >= lo) & (ids < hi), ids - lo, ctx.rows)
        return (tiling.segment_sum(idx.reshape(-1),
                                   g.reshape(-1, g.shape[-1]), ctx.rows),
                None, None)


def row_lookup(local: torch.Tensor, ids: torch.Tensor,
               shard: RowShard) -> torch.Tensor:
    """:meth:`RowShard.lookup` with autograd: the gradient of each row
    lands in its owner's ``local`` rows only (summed in id order, no
    atomics), the others' parts get none."""
    if shard.group.size == 1:
        return tiling.gather_rows(local, ids)
    return _RowLookup.apply(local, ids, shard)


class ShardedRows(NamedTuple):
    """A table whose rows are split over ``shard``'s group, as the sampled
    head and the samplers see it: ``shape`` is the whole table's, so draws
    range over every row, and ``lookup`` is :func:`row_lookup`."""

    local: torch.Tensor
    shard: RowShard

    @property
    def shape(self) -> tuple:
        """The whole table's shape."""
        return (self.shard.num_rows,) + tuple(self.local.shape[1:])

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the whole table (:func:`row_lookup`)."""
        return row_lookup(self.local, ids, self.shard)
