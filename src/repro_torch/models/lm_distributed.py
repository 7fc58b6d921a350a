"""The LM's sharded layout over a :class:`~repro_torch.distributed.sharding.
Mesh`: which slice of every parameter and optimizer-state leaf a rank
holds, and the exchanges the training step adds around the model.

The reference runs one global program whose parameters GSPMD lays out by
``partition_specs(model_defs(cfg), mesh)`` (``fsdpify``-ed for fsdp archs)
and whose batch rows it pins to the data axes.  Here every rank runs its
own step on its rows (``shard_bounds`` over the data axes) and holds its
slice of each leaf under the same fitted specs; the optimizer state's
leaves are laid out by ``optimizer.state_defs`` of the fitted defs.  The
model reads sharded leaves through ``params.use`` and splits its work in
three places only (the expert-parallel MoE, the vocab tables' owner-masked
lookups, the batch rows); :class:`LMShardingPlan` supplies the rest of the
step's exchanges:

* :meth:`LMShardingPlan.view`, the parameter tree as the model sees it
  (a sharded leaf becomes a ``params.Shard``);
* :meth:`LMShardingPlan.sync_grads`, the sum over the data group of the
  gradient of every leaf the data axes do not shard (each data rank's
  loss is weighted by its share of the batch's tokens, so the sum is the
  gradient of the whole batch's mean);
* :meth:`LMShardingPlan.reduce_losses`, the window's losses summed over
  the data group, once a window;
* :meth:`LMShardingPlan.update`, the optimizer on the slices (SGD and
  AdamW are elementwise; Adafactor's factored moments and clipping norm
  span the whole leaf, so each sharded leaf is gathered, updated whole and
  sliced again);
* :meth:`LMShardingPlan.gather_state` / :meth:`LMShardingPlan.place_state`,
  the whole state for a checkpoint in the unsharded layout, and a whole
  state sliced onto this mesh (any mesh: restores are elastic).

The decode cache's counterparts: :func:`place_cache` lays a whole
``lm.DecodeCache`` onto a mesh (each leaf this rank's slice under
``lm.cache_defs``' specs fitted to the leaf, a ``params.Shard`` where the
mesh splits it), :func:`gather_cache` makes it whole again, and
:func:`abstract_cache` builds the slices directly, empty (``meta`` for the
dry run).  ``lm.prefill`` under a mesh returns its cache placed, and
``lm.decode_step`` reads and writes such a cache (``models/lm.py``); each
rank serves its own batch rows, so only the dimensions other than the
rows are gathered where attention reads them.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import KVCache
from repro_torch.models.params import (
    ParamDef,
    Shard,
    fit_spec,
    fitted_defs,
    gather_leaf,
    local_shape,
    map_defs,
    partition_specs,
    sharded_dims,
    slice_leaf,
    tree_from_items,
    tree_items,
)
from repro_torch.optim.optimizers import FactoredMoment, OptState, Optimizer
from repro_torch.train.checkpoint import map_leaves, named_leaves

#: bytes of gradients summed over the data group in one collective.
SYNC_CHUNK_BYTES = 256 << 20


class LMShardingPlan:
    """The sharded layout of an LM of ``cfg`` trained by ``optimizer`` on
    ``mesh`` (see the module docstring).  ``specs`` is the fitted spec tree
    of the parameters, ``state_specs`` that of the optimizer state (None
    without an optimizer: a serving plan, whose :meth:`view` is all it
    needs)."""

    def __init__(self, cfg: ArchConfig, mesh: shd.Mesh,
                 optimizer: Optional[Optimizer] = None):
        self.cfg, self.mesh, self.optimizer = cfg, mesh, optimizer
        with shd.use_mesh(mesh):          # fsdpify reads the data shards
            defs = lm.model_defs(cfg)
        self.specs = partition_specs(defs, mesh.shape)
        self._state_defs = self.state_specs = None
        if optimizer is not None:
            self._state_defs = fitted_defs(
                optimizer.state_defs(fitted_defs(defs, mesh.shape)),
                mesh.shape)
            self.state_specs = partition_specs(self._state_defs)
        self.data = mesh.group(shd.DATA_AXES)
        self._spec_of = dict(named_leaves(_SpecTree(self.specs,
                                                    self.state_specs)))
        self._param_spec = dict(tree_items(self.specs))

    def sharded(self, spec) -> bool:
        """Whether ``spec`` splits a leaf over more than one rank."""
        return bool(sharded_dims(spec, self.mesh))

    def _data_sharded(self, spec) -> bool:
        return any(g.over_data for _, g in sharded_dims(spec, self.mesh))

    # ---- the step -----------------------------------------------------------

    def init_opt_state(self, device) -> OptState:
        """This rank's slices of a fresh optimizer state (zeros), laid out
        by the optimizer's ``state_defs``: the moments shard like their
        parameters (AdamW's ZeRO-1 moments over the data axes too)."""
        moments = map_defs(lambda d: torch.zeros(
            local_shape(d.shape, d.spec, self.mesh), dtype=torch.float32,
            device=device), self._state_defs.moments)
        return OptState(moments, torch.zeros((), dtype=torch.int32,
                                             device=device))

    def view(self, params: dict) -> dict:
        """The parameter tree as the model reads it: each sharded leaf a
        ``Shard(local, spec)``, the others as they are."""
        return tree_from_items([
            (path, Shard(x, self._param_spec[path])
             if self.sharded(self._param_spec[path]) else x)
            for path, x in tree_items(params)])

    def batch_rows(self, rows: int) -> tuple:
        """``(start, stop)`` of this rank's rows of a batch of ``rows``."""
        return shd.shard_bounds(rows, self.data.size)[self.data.index]

    def sync_grads(self, grads: dict) -> dict:
        """Every gradient the data axes do not shard summed over the data
        group (group order, the same bits on every member), in collectives
        of at most :data:`SYNC_CHUNK_BYTES`."""
        if self.data.size == 1:
            return grads
        items = tree_items(grads)
        todo = [i for i, (path, _) in enumerate(items)
                if not self._data_sharded(self._param_spec[path])]
        out = dict(items)
        chunk, size = [], 0
        for i in todo + [None]:
            if i is not None:
                chunk.append(i)
                size += items[i][1].numel() * items[i][1].element_size()
            if chunk and (i is None or size >= SYNC_CHUNK_BYTES):
                summed = shd.sum_over([items[j][1] for j in chunk], self.data)
                out.update((items[j][0], s) for j, s in zip(chunk, summed))
                chunk, size = [], 0
        return tree_from_items(list(out.items()))

    def reduce_losses(self, window: torch.Tensor) -> torch.Tensor:
        """A window's per-rank weighted losses summed over the data group:
        the whole batch's losses (the window itself on one data rank)."""
        return shd.sum_over([window], self.data)[0]

    def update(self, grads: dict, state: OptState, params: dict, lr: float):
        """The optimizer's update of this rank's slices (see the module
        docstring); returns ``(params, state)``."""
        opt = self.optimizer
        if opt.name != "adafactor" or not any(
                self.sharded(s) for s in self._param_spec.values()):
            return opt.update(grads, state, params, lr)
        moment_specs = dict(tree_items(self.state_specs.moments))
        moments = dict(tree_items(state.moments))
        g_of = dict(tree_items(grads))
        for path, p in tree_items(params):
            spec, fm = self._param_spec[path], moments[path]
            if not self.sharded(spec):
                opt.update({"x": g_of[path]}, OptState({"x": fm}, state.count),
                           {"x": p}, lr)
                continue
            mspec = moment_specs[path]
            whole_fm = FactoredMoment(*(
                None if m is None else gather_leaf(m, s, self.mesh)
                for m, s in zip(fm, mspec)))
            whole_p = gather_leaf(p, spec, self.mesh)
            opt.update({"x": gather_leaf(g_of[path], spec, self.mesh)},
                       OptState({"x": whole_fm}, state.count),
                       {"x": whole_p}, lr)
            p.copy_(slice_leaf(whole_p, spec, self.mesh))
            for m, w, s in zip(fm, whole_fm, mspec):
                if m is not None:
                    m.copy_(slice_leaf(w, s, self.mesh))
        return params, OptState(state.moments, state.count + 1)

    # ---- checkpoints --------------------------------------------------------

    def gather_state(self, state):
        """The whole state on the host, in the unsharded layout (every rank
        of the mesh must call)."""
        def whole(name, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            spec = self._spec_of.get(name)
            if spec is not None:
                leaf = gather_leaf(leaf, spec, self.mesh)
            return leaf.cpu()
        return map_leaves(state, whole)

    def place_state(self, state, device: Optional[torch.device] = None):
        """This rank's slices of a whole state (host or device tensors), on
        ``device`` (default: where they are)."""
        def part(name, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            spec = self._spec_of.get(name)
            if spec is not None:
                leaf = slice_leaf(leaf, spec, self.mesh)
            return leaf.to(device) if device is not None else leaf
        return map_leaves(state, part)


def _map_cache(fn, cache):
    """``cache`` (an ``lm.DecodeCache``) with every leaf ``x`` replaced by
    ``fn(x, its logical spec, whether it holds K/V rows)`` (``lm.KV_SPEC``
    for K/V rows, ``lm.CONV_SPEC`` / ``lm.STATE_SPEC`` for a Mamba
    cache)."""
    def rebuild(node, items):
        return type(node)(*items) if hasattr(node, "_fields") else tuple(items)

    def kv(node):
        if node is None:
            return None
        if isinstance(node[0], KVCache):          # an interleaved-MoE pair
            return tuple(kv(m) for m in node)
        return rebuild(node, [fn(x, lm.KV_SPEC, True) for x in node])

    mamba = cache.mamba
    if mamba is not None:
        mamba = type(mamba)(fn(mamba.conv, lm.CONV_SPEC, False),
                            fn(mamba.state, lm.STATE_SPEC, False))
    return lm.DecodeCache(kv(cache.kv), mamba, kv(cache.shared_kv),
                          kv(cache.cross_kv))


def place_cache(cache, mesh: shd.Mesh, batch: Optional[int] = None):
    """This rank's slices of a whole decode cache: each leaf under its
    logical spec fitted to its shape and ``mesh`` (``lm.cache_defs``'
    layout), a ``Shard`` where the mesh splits it, the whole tensor where
    it does not.  With ``batch`` (the whole batch's rows), the cache holds
    only this rank's rows of it (``lm.prefill`` under a mesh): where the
    fitted spec splits the rows (dim 1) they are kept as they are."""
    def part(x, spec, _):
        if isinstance(x, Shard):
            return x
        shape = tuple(x.shape)
        if batch is not None:
            shape = shape[:1] + (batch,) + shape[2:]
        fitted = fit_spec(shape, spec, mesh.shape)
        if not sharded_dims(fitted, mesh):
            return x
        cut = fitted
        if x.shape[1] != shape[1]:                  # the rows are ours
            cut = shd.P(fitted[0], None, *fitted[2:])
        return Shard(slice_leaf(x, cut, mesh), fitted)
    return _map_cache(part, cache)


def gather_cache(cache, mesh: shd.Mesh):
    """The whole decode cache from every rank's slices (every rank of the
    mesh must call)."""
    return _map_cache(lambda x, *_: gather_leaf(x.local, x.spec, mesh)
                      if isinstance(x, Shard) else x, cache)


def cache_specs(cache):
    """The spec tree of a placed decode cache: each ``Shard``'s fitted
    spec, and an empty spec for a leaf kept whole."""
    return _map_cache(lambda x, *_: x.spec if isinstance(x, Shard)
                      else shd.P(), cache)


def abstract_cache(cfg: ArchConfig, batch: int, seq: int, mesh: shd.Mesh,
                   dtype=torch.bfloat16):
    """This rank's slices of an empty decode cache on ``meta`` for
    ``batch`` sequences of ``seq`` positions, built at their local shapes
    (nothing whole): K/V rows in ``dtype`` (``TrainOptions.cache_dtype``),
    a Mamba cache in fp32, as ``lm.prefill`` keeps them."""
    def make(x: ParamDef, spec, kv: bool):
        fitted = fit_spec(x.shape, spec, mesh.shape)
        t = torch.empty(local_shape(x.shape, fitted, mesh),
                        dtype=dtype if kv else torch.float32, device="meta")
        return Shard(t, fitted) if sharded_dims(fitted, mesh) else t
    return _map_cache(make, lm.cache_defs(cfg, batch, seq))


class _SpecTree(NamedTuple):
    """The spec trees named as an LM state names its ``params`` and
    ``opt_state``, so a state leaf's checkpoint name finds its spec."""

    params: Any
    opt_state: Any
