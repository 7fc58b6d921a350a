"""Parameter definition trees (the port of ``src/repro/models/params.py``):
shape, logical partition spec and init of every leaf, and the sharded
layout derived from them.

Models declare their parameters as nested dicts of :class:`ParamDef`;
:func:`materialize` turns such a tree into tensors, and under a mesh into
this rank's slices of them.  The leaves are visited
in the reference's flatten order (dict keys sorted, as ``jax.tree`` flattens
them), and leaf ``i`` is drawn by its own ``torch.Generator`` seeded with
``fold_in(key, i)``, so every leaf is a pure function of (key, its index)
and the draw does not depend on the device order of earlier leaves.  The
draws are not the reference's threefry numbers: cross-package tests carry
the reference's parameters across with ``convert.py``.

Sharding: each def carries the reference's logical spec (axis names per
dimension); :func:`partition_specs` fits them to a mesh (:func:`fit_spec`)
and :func:`fsdpify` adds the data axis to large weights, as the reference
does.  A rank stores the slice of each leaf that its mesh coordinates
select (:func:`slice_leaf`); the model reads a sharded leaf through
:func:`use`, which all-gathers it whole with an autograd backward that
hands each rank its slice of the gradient (``distributed/sharding.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.mf import fold_in, generator
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import PartitionSpec


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape, init scheme (``normal`` with
    ``scale``, ``zeros``, ``ones``, or ``scaled_fan_in``: a unit normal
    divided by the square root of the second-to-last dimension) and the
    reference's logical partition spec."""

    shape: tuple[int, ...]
    init: str = "normal"
    scale: float = 0.02
    spec: PartitionSpec = PartitionSpec()


def is_def(x: Any) -> bool:
    """True when ``x`` is a :class:`ParamDef` leaf."""
    return isinstance(x, ParamDef)


def map_defs(fn: Callable[[ParamDef], Any], tree):
    """Rebuild a tree of dicts, NamedTuples, tuples and lists with each
    ParamDef replaced by ``fn(def)`` (None stays None)."""
    if isinstance(tree, dict):
        return {k: map_defs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_defs(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_defs(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_items(tree, prefix: str = ""):
    """``[(path, leaf), ...]`` of a nested dict in the reference's flatten
    order (sorted keys), ``path`` the keys joined by ``/``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_items(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Rebuild a nested dict with every leaf replaced by ``fn(leaf, *the
    leaves at the same path of rest)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_from_items(items) -> dict:
    """The nested dict whose :func:`tree_items` are ``items``
    (``[(path, leaf), ...]``)."""
    out: dict = {}
    for path, leaf in items:
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def materialize(key: int, tree, dtype=torch.float32, device="cpu", *,
                specs=None, mesh=None):
    """Tensors for a ParamDef tree on ``device``; leaf ``i`` (in flatten
    order) draws from ``generator(fold_in(key, i))``.  With ``specs`` (the
    tree's fitted :func:`partition_specs`) and ``mesh``, each leaf is this
    rank's slice of the whole leaf: made whole, sliced, and the whole freed
    before the next leaf is made, so no rank holds the whole model."""
    spec_of = dict(tree_items(specs)) if specs is not None else {}

    def make(i: int, d: ParamDef, path: str):
        x = draw(i, d)
        if mesh is None or path not in spec_of:
            return x
        return slice_leaf(x, spec_of[path], mesh)

    def draw(i: int, d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        x = torch.randn(d.shape, dtype=dtype, device=device,
                        generator=generator(fold_in(key, i), device))
        if d.init == "scaled_fan_in":
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            return x.div_(math.sqrt(fan_in))
        return x.mul_(d.scale)

    return tree_from_items([(path, make(i, d, path)) for i, (path, d)
                            in enumerate(tree_items(tree))])


def abstract(tree, dtype=torch.float32, device="meta", *, mesh=None):
    """Stand-ins of a ParamDef tree (dicts and NamedTuples): an empty tensor
    of each leaf's shape and ``dtype`` on ``device`` (``meta`` by default:
    nothing is allocated).  With ``mesh``, each leaf is this rank's slice
    under the def's own spec (pass :func:`fitted_defs`), built at its
    :func:`local_shape` directly, never whole."""
    def make(d: ParamDef):
        shape = d.shape if mesh is None else local_shape(d.shape, d.spec, mesh)
        return torch.empty(shape, dtype=dtype, device=device)
    return map_defs(make, tree)


def def_leaves(tree) -> list:
    """The ParamDef leaves of a tree of dicts and NamedTuples, in
    :func:`map_defs` order."""
    out: list = []
    map_defs(out.append, tree)
    return out


def bytes_per_device(tree, mesh_shape: dict, bytes_per_elem: int = 2) -> int:
    """Parameter bytes landing on one device under each leaf's spec as it
    stands (fit it first for the fitted layout): the reference's arithmetic,
    floor division by the product of the spec's present axis sizes
    included."""
    total = 0
    for leaf in def_leaves(tree):
        n = math.prod(leaf.shape)
        shards = 1
        for ax in leaf.spec:
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                shards *= mesh_shape.get(a, 1)
        total += n * bytes_per_elem // max(shards, 1)
    return total


def count_params(tree) -> int:
    """Total element count of a ParamDef or tensor tree."""
    return sum(math.prod(leaf.shape) for _, leaf in tree_items(tree))


def fit_spec(shape: tuple, spec, mesh_shape: dict):
    """Make a logical spec (a tuple of axis names, tuples of names or None
    per dimension) legal for a concrete shape and mesh; returns a
    :class:`~repro_torch.distributed.sharding.PartitionSpec`.

    1. Axes absent from the mesh are dropped.
    2. An axis whose dimension is not divisible by the axis size is dropped
       there and *relocated* to the largest free dimension that divides it
       (never dimension 0 of a stacked tensor of 3 or more dimensions with
       an unsharded lead: that is the scan layer dimension).
    The reference's rule, line for line."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    axes = axes[:len(shape)]

    def axis_prod(ax) -> int:
        if ax is None:
            return 1
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= mesh_shape.get(a, 1)
        return n

    def present(ax):
        if ax is None:
            return None
        items = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                      if a in mesh_shape)
        if not items:
            return None
        return items if len(items) > 1 else items[0]

    axes = [present(a) for a in axes]
    dropped = []
    for i, ax in enumerate(axes):
        if ax is not None and shape[i] % axis_prod(ax) != 0:
            dropped.append(ax)
            axes[i] = None

    protect0 = len(shape) >= 3 and (len(spec) == 0 or list(spec)[0] is None)
    start = 1 if protect0 else 0
    for ax in dropped:
        n = axis_prod(ax)
        candidates = sorted(
            (i for i in range(start, len(shape))
             if axes[i] is None and shape[i] % n == 0 and shape[i] >= n),
            key=lambda i: -shape[i])
        if candidates:
            axes[candidates[0]] = ax
    return PartitionSpec(*axes)


def partition_specs(tree, mesh_shape: Optional[dict] = None):
    """The PartitionSpec tree of a ParamDef tree (dicts and NamedTuples);
    with ``mesh_shape`` each spec is fitted to its leaf (:func:`fit_spec`)."""
    def spec(d: ParamDef):
        return d.spec if mesh_shape is None else fit_spec(d.shape, d.spec,
                                                          mesh_shape)
    return map_defs(spec, tree)


def fsdpify(tree, data_shards: int, axis: str = "data"):
    """ZeRO-3/FSDP: also shard each weight of rank 2 or more over ``axis``
    on the last dimension (never dimension 0, the stacked layer axis) whose
    spec is free and whose size ``data_shards`` divides.  The reference's
    rule, line for line."""
    def maybe(d: ParamDef) -> ParamDef:
        if len(d.shape) < 2:
            return d
        spec = list(d.spec) + [None] * (len(d.shape) - len(d.spec))
        for dim in range(len(d.shape) - 1, 0, -1):
            if spec[dim] is None and d.shape[dim] % data_shards == 0 \
                    and d.shape[dim] >= data_shards:
                spec[dim] = axis
                return dataclasses.replace(d, spec=PartitionSpec(*spec))
        return d
    return map_defs(maybe, tree)


def fitted_defs(tree, mesh_shape: dict):
    """The ParamDef tree with each spec replaced by its fitted spec."""
    return map_defs(lambda d: dataclasses.replace(
        d, spec=fit_spec(d.shape, d.spec, mesh_shape)), tree)


def sharded_dims(spec, mesh) -> list:
    """``[(dim, group), ...]`` of the dimensions that ``spec`` shards over a
    group of more than one rank of ``mesh``, in dimension order."""
    out = []
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        group = mesh.group(ax)
        if group.size > 1:
            out.append((dim, group))
    return out


def local_shape(shape: tuple, spec, mesh) -> tuple:
    """The shape of one rank's slice of a ``shape`` leaf under ``spec``."""
    out = list(shape)
    for dim, group in sharded_dims(spec, mesh):
        out[dim] //= group.size
    return tuple(out)


def slice_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the whole leaf ``x`` under ``spec`` (a copy
    when anything is sliced, so the whole can be freed)."""
    dims = sharded_dims(spec, mesh)
    for dim, group in dims:
        n = x.shape[dim] // group.size
        x = x.narrow(dim, group.index * n, n)
    return x.contiguous().clone() if dims else x


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's slice ``x`` under ``spec`` (no
    autograd; every rank of each group must call)."""
    for dim, group in reversed(sharded_dims(spec, mesh)):
        x = shd.all_gather_cat(x, dim, group)
    return x


class Shard(NamedTuple):
    """A leaf as the model sees it under a mesh: this rank's slice
    ``local`` and its fitted ``spec``; :func:`use` makes it whole."""

    local: torch.Tensor
    spec: PartitionSpec


def use(x, keep: tuple = ()):
    """The whole tensor of a leaf: ``x`` itself when it is a tensor, else
    the :class:`Shard`'s slices all-gathered over their groups, the
    dimensions in ``keep`` left sharded.  The backward gives each rank its
    slice of the gradient (``sharding.gather_leaves``)."""
    if not isinstance(x, Shard):
        return x
    return use_tree({"x": x}, keep)["x"]


def use_tree(tree, keep: tuple = (), skip: tuple = ()):
    """:func:`use` of every leaf of a dict tree in one exchange per group
    (the subtrees named in ``skip`` are left as they are)."""
    items = tree_items({k: v for k, v in tree.items() if k not in skip})
    shards = [(path, leaf) for path, leaf in items if isinstance(leaf, Shard)]
    if not shards:
        return tree
    mesh = shd.get_mesh()
    got, todo = {}, []
    for path, leaf in shards:
        plan = [(d, g) for d, g in sharded_dims(leaf.spec, mesh)
                if d not in keep]
        if plan:
            todo.append((path, leaf.local, plan))
        else:
            got[path] = leaf.local
    if todo:
        whole = shd.gather_leaves([x for _, x, _ in todo],
                                  [plan for _, _, plan in todo])
        got.update(zip((path for path, _, _ in todo), whole))
    out = tree_from_items([(path, got.get(path, leaf)) for path, leaf in items])
    out.update({k: tree[k] for k in skip if k in tree})
    return out


def unbind_leaf(x) -> list:
    """A stacked (L, ...) leaf as its L layers: a tensor's ``unbind``, or
    for a :class:`Shard` the layers of its slice with the spec's tail (a
    leaf sharded on the layer axis is gathered whole first)."""
    if not isinstance(x, Shard):
        return list(x.unbind(0))
    if x.spec and x.spec[0] is not None:
        return list(use(x).unbind(0))
    tail = PartitionSpec(*x.spec[1:])
    return [Shard(t, tail) for t in x.local.unbind(0)]
