"""Parameter definition trees (the port of ``src/repro/models/params.py``)
and :func:`fit_spec`, the divisibility-aware spec fitting that the MF
sharding plan uses (the LM's ``partition_specs`` and ``fsdpify`` wait for
LM sharding).

Models declare their parameters as nested dicts of :class:`ParamDef`;
:func:`materialize` turns such a tree into tensors.  The leaves are visited
in the reference's flatten order (dict keys sorted, as ``jax.tree`` flattens
them), and leaf ``i`` is drawn by its own ``torch.Generator`` seeded with
``fold_in(key, i)``, so every leaf is a pure function of (key, its index)
and the draw does not depend on the device order of earlier leaves.  The
draws are not the reference's threefry numbers: cross-package tests carry
the reference's parameters across with ``convert.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core.mf import fold_in, generator
from repro_torch.distributed.sharding import PartitionSpec


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape and init scheme (``normal`` with
    ``scale``, ``zeros``, ``ones``, or ``scaled_fan_in``: a unit normal
    divided by the square root of the second-to-last dimension)."""

    shape: tuple[int, ...]
    init: str = "normal"
    scale: float = 0.02


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


def materialize(key: int, tree, dtype=torch.float32, device="cpu"):
    """Tensors for a ParamDef tree on ``device``; leaf ``i`` (in flatten
    order) draws from ``generator(fold_in(key, i))``."""
    def make(i: int, d: ParamDef):
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

    return tree_from_items([(path, make(i, d)) for i, (path, d)
                            in enumerate(tree_items(tree))])


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
