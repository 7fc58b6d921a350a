"""One rank's program for every (arch x shape) cell of the dry run, built on
``meta`` (the port of ``src/repro/launch/specs.py``).

The reference hands ``jax.jit(...).lower`` ShapeDtypeStruct stand-ins and a
sharding tree, and GSPMD partitions one global program.  Here a rank runs
its own program on its own slices, so a cell is this rank's step with empty
``meta`` tensors at its slices' shapes (``params.local_shape`` under the
fitted specs): nothing is allocated, every op computes its output's shape,
and the step issues the same exchanges a real rank issues
(``distributed/sharding.py``).  :func:`build_cell` returns the step as a
:class:`CellProgram` for ``launch/dryrun.py::lower_cell`` to run once.

The dtypes are those of the port's own step: fp32 parameters and optimizer
state, int64 tokens, fp32 modality inputs, and the decode cache's K/V in
``TrainOptions.cache_dtype`` (a Mamba cache fp32, as ``lm.prefill`` keeps
it).  The reference lowered bf16 parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.samplers import TileState
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P, PartitionSpec
from repro_torch.models import lm
from repro_torch.models import lm_distributed as lmd
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.params import fit_spec
from repro_torch.optim.optimizers import Optimizer, get_optimizer
from repro_torch.train.trainer import LMTrainState, make_lm_train_step_raw


def arch_optimizer(cfg: ArchConfig) -> Optimizer:
    """Adafactor where full moments cannot fit (fsdp archs), else AdamW
    with ZeRO-1 moments over the active mesh's data shards."""
    if cfg.fsdp:
        return get_optimizer("adafactor", bf16_step=cfg.opt_bf16_step)
    return get_optimizer("adamw", zero1=True, data_shards=shd.data_shards(),
                         bf16_step=cfg.opt_bf16_step)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig):
    """``(batch, spec batch)`` of a train or prefill step: the global batch
    as empty tensors on ``meta`` (int64 tokens; the audio family's
    ``frames`` and the VLM family's ``patches`` in fp32, as the port's
    step takes them) and the reference's logical specs (rows over the data
    axes)."""
    b, s = shape.global_batch, shape.seq_len
    dp = shd.DATA_AXES
    batch = {"tokens": torch.empty((b, s), dtype=torch.int64, device="meta")}
    spec = {"tokens": P(dp, None)}
    if cfg.family == "audio":
        batch["frames"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                      device="meta")
        spec["frames"] = P(dp, None, None)
    if cfg.family == "vlm":
        batch["patches"] = torch.empty((b, cfg.num_patches, cfg.d_model),
                                       device="meta")
        spec["patches"] = P(dp, None, None)
    return batch, spec


def tile_abstract(cfg: ArchConfig):
    """``(id-only vocab tile on meta, its specs)`` for the configured tile
    size, or ``(None, None)`` when tiling is off."""
    if not (cfg.heat.enabled and cfg.heat.tile_size):
        return None, None
    tile = TileState(torch.empty((cfg.heat.tile_size,), dtype=torch.int64,
                                 device="meta"), None, 0)
    return tile, TileState(P(), None, P())


def _map_specs(fn, specs, *rest):
    """``specs`` (dicts, NamedTuples, tuples of PartitionSpecs; None
    stays) with each spec replaced by ``fn(spec, *the leaves at its place
    in rest)``."""
    if specs is None:
        return None
    if isinstance(specs, PartitionSpec):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    items = [_map_specs(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(specs)]
    return type(specs)(*items) if hasattr(specs, "_fields") else type(specs)(items)


def resolve_tree(spec_tree, mesh, abs_tree=None):
    """A spec tree resolved against ``mesh``: each spec fitted to the
    matching leaf's shape when ``abs_tree`` is given (``params.fit_spec``,
    the reference's ``fix``), else with the axes the mesh lacks dropped."""
    mesh_shape = mesh.shape

    def fix(sp, leaf=None):
        if leaf is not None:
            return fit_spec(tuple(leaf.shape), sp, mesh_shape)
        cleaned = []
        for ax in sp:
            if isinstance(ax, tuple):
                kept = tuple(a for a in ax if a in mesh_shape)
                cleaned.append(kept if kept else None)
            elif isinstance(ax, str):
                cleaned.append(ax if ax in mesh_shape else None)
            else:
                cleaned.append(None)
        return P(*cleaned)

    if abs_tree is None:
        return _map_specs(fix, spec_tree)
    return _map_specs(fix, spec_tree, abs_tree)


@dataclasses.dataclass
class CellProgram:
    """One rank's program of a cell: ``fn(*args)`` runs its step once on
    the ``meta`` stand-ins ``args`` (named by ``names``), whose fitted
    spec trees are ``specs``; ``donate`` lists the arguments the step
    updates in place."""

    fn: Any
    args: tuple
    specs: tuple
    names: tuple
    donate: tuple = ()


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               opts: Optional[lm.TrainOptions] = None, lr: float = 1e-3,
               optimizer: Optional[Optimizer] = None) -> CellProgram:
    """This rank's step of a cell on ``meta``; must run inside
    ``shd.use_mesh(mesh)`` (fsdp archs and ZeRO-1 read the data shards).

    train: ``trainer.make_lm_train_step_raw`` under an
    ``LMShardingPlan`` (forward, backward, the data group's gradient sum and
    ``LMShardingPlan.update``) with ``optimizer`` (:func:`arch_optimizer`
    by default); prefill: ``lm.prefill``; decode: ``lm.decode_step`` of one
    token at the last of ``seq_len`` cache rows."""
    opts = opts or lm.TrainOptions()
    train = shape.kind == "train"
    if train:
        optimizer = optimizer or arch_optimizer(cfg)
    plan = lmd.LMShardingPlan(cfg, mesh, optimizer if train else None)
    params = lm.abstract_params(cfg, torch.float32, mesh)
    params_spec = plan.specs

    if train:
        opt_state = plan.init_opt_state("meta")
        batch, batch_spec = batch_specs(cfg, shape)
        tile, tile_spec = tile_abstract(cfg)
        step_fn = make_lm_train_step_raw(cfg, opts, optimizer, lr, 1, plan)

        def train_step(params, opt_state, tile, batch, rng):
            state, loss = step_fn(LMTrainState(params, opt_state, tile, 0),
                                  batch, rng)
            return state.params, state.opt_state, state.tile, loss

        return CellProgram(
            train_step, (params, opt_state, tile, batch, 0),
            (params_spec, plan.state_specs, tile_spec,
             resolve_tree(batch_spec, mesh, batch), P()),
            ("params", "opt_state", "tile", "batch", "rng"), donate=(0, 1))

    if shape.kind == "prefill":
        batch, batch_spec = batch_specs(cfg, shape)

        def prefill_step(params, batch):
            return lm.prefill(plan.view(params), batch, cfg, opts,
                              device="meta")

        return CellProgram(prefill_step, (params, batch),
                           (params_spec, resolve_tree(batch_spec, mesh, batch)),
                           ("params", "batch"))

    # decode: one new token against a seq_len-deep cache
    b = shape.global_batch
    cache = lmd.abstract_cache(cfg, b, shape.seq_len, mesh, opts.cache_dtype)
    token = torch.empty((b, 1), dtype=torch.int64, device="meta")

    def serve_step(params, cache, token, pos):
        return lm.decode_step(plan.view(params), cache, token, pos, cfg, opts,
                              device="meta")

    cache_spec = lmd.cache_specs(cache)
    token_spec = fit_spec((b, 1), P(shd.DATA_AXES, None), mesh.shape)
    return CellProgram(serve_step, (params, cache, token, shape.seq_len - 1),
                       (params_spec, cache_spec, token_spec, P()),
                       ("params", "cache", "token", "pos"), donate=(1,))
