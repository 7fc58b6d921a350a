"""The training loops of the port: the MF half of
``src/repro/train/trainer.py`` (``train_mf``) and its LM half
(``train_lm``: an LM of any family with the HEAT vocab head or the softmax
head, under SGD, AdamW or Adafactor).

The loop runs in K-step windows: an :class:`EpochExecutor` runs K steps as a
Python loop, each drawing its batch on the device from (seed, step), and
keeps the per-step losses on the device; the loop reads them back once per
window.  Every step's draws are pure in (seed, step), so any K gives the same
trajectory, and a run restored from a checkpoint at step N replays the
uninterrupted run bit for bit.  Windows end on the checkpoint schedule and
on an armed failure injection, so both land on window edges, as in the
reference.  Under a mesh (``train_mf(mesh=)``) every rank runs the same
loop on its shard (``core/mf_distributed.py``); capturing each window as a
CUDA graph is a later optimization.

The LM step (:func:`make_lm_train_step_raw`) takes the gradients of every
parameter with ``torch.autograd.grad`` (``grad_accum`` micro-batches summed
in order) and applies the optimizer to the whole tree.  Under a mesh
(``TrainerConfig.mesh``, or the active mesh) every rank runs the same loop
on its slices of the parameters and state and its rows of each batch
(``models/lm_distributed.py``); checkpoints hold the whole state.  On the
card it is deterministic: the table gathers sum duplicate rows in a fixed order
(``core/tiling.py::gather_rows``), the CCL kernels use no atomics and
matmuls run in full fp32 (PyTorch's default, TF32 off), so a run healed
from a checkpoint ends on the bits of the uninterrupted run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import mf, samplers
from repro_torch.core import mf_distributed as mfd
from repro_torch.core.engine import StepEngine, resolve_engine
from repro_torch.data import pipeline
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.models import lm_distributed as lmd
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import tree_from_items, tree_items, tree_map
from repro_torch.optim.optimizers import Optimizer, get_optimizer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import spans
from repro_torch.train.shapes import ShapeCounter

#: restarts ``train_mf`` makes after injected failures before it re-raises.
MAX_RESTARTS = 2


class SimulatedFailure(RuntimeError):
    """An injected failure (``fail_at_step``): the loop restores its latest
    checkpoint and carries on, as after a real crash."""


class EpochExecutor:
    """Runs ``body(state, step) -> (state, loss)`` over K-step windows.

    ``run`` returns the window's losses as one device tensor, so a window
    costs one host sync, taken by the caller at its edge.  The state may be
    any carry the body threads (an ``MFState``, or the streaming service's
    ``(state, data)`` pair).  ``trace_counter`` counts the distinct window
    lengths dispatched — the reference compiles one program per length and
    counts its traces — and raises past ``trace_budget``.  Each run is a
    ``window`` span and each body call a ``step`` span (``train/spans.py``).
    ``reduce``
    (optional) maps the window's stacked losses before they are returned:
    a sharded LM run sums its ranks' parts there, once a window."""

    def __init__(self, body: Callable, steps_per_dispatch: int, *,
                 trace_budget: Optional[int] = None,
                 reduce: Optional[Callable] = None):
        self.body = body
        self.reduce = reduce
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)
        self.trace_counter = ShapeCounter("epoch_executor.window",
                                          trace_budget)

    def run(self, state, start: int, length: int):
        """Run steps ``[start, start + length)``; returns
        ``(new_state, (length,) device loss tensor)``."""
        self.trace_counter.add(length)
        with spans.span("window", anchor=True):
            losses = []
            for step in range(start, start + length):
                with spans.span("step", step):
                    state, loss = self.body(state, step)
                losses.append(loss)
            window = torch.stack(losses)
            return state, (window if self.reduce is None
                           else self.reduce(window))


def _window_length(step: int, stop: int, k: int, ckpt_every: int,
                   fail_at_step: Optional[int]) -> int:
    """Next window length: at most ``k`` steps, truncated so window edges
    land exactly on the run end, the checkpoint schedule and any armed
    failure injection (the same rule as the reference)."""
    length = min(k, stop - step)
    if ckpt_every:
        length = min(length, ckpt_every - step % ckpt_every)
    if fail_at_step is not None and step < fail_at_step:
        length = min(length, fail_at_step - step)
    return length


def run_window(executor: EpochExecutor, state, step: int, stop: int,
               ckpt_every: int = 0, fail_at_step: Optional[int] = None):
    """One window, truncated at the run end, the checkpoint schedule and an
    armed failure, and its edge sync; returns ``(state, host losses,
    length)``."""
    length = _window_length(step, stop, executor.steps_per_dispatch,
                            ckpt_every, fail_at_step)
    state, window = executor.run(state, step, length)
    return state, window.cpu().tolist(), length


def train_mf(cfg: mf.MFConfig, ds: pipeline.CFDataset, steps: int, *,
             batch_size: int = 256, seed: int = 0,
             engine: Optional[StepEngine] = None, item_weights=None,
             ckpt_dir: Optional[str] = None, ckpt_every: int = 200,
             fail_at_step: Optional[int] = None,
             steps_per_dispatch: int = 1, mesh=None, device=None,
             log: Callable[[str], None] = print):
    """HEAT CF training (the Fig. 3 loop) with restart on failure; returns
    ``(state, losses)``.

    Runs on the card unless ``device`` names another device (``"cpu"`` runs
    the kernels' plain versions); with no CUDA device and no ``device`` it
    raises.  ``engine`` defaults to the one ``cfg`` names.  The dataset is
    uploaded once and batches (with ``cfg.history_len`` history columns) are
    drawn on the device, ``steps_per_dispatch`` steps per window.
    ``item_weights`` ((I,)) feeds the ``popularity`` sampler; with that
    sampler and none given, the dataset's interaction counts
    (``DeviceCFDataset.item_weights``) are used, as in the reference.

    With ``ckpt_dir`` the run resumes from its latest checkpoint, saves
    every ``ckpt_every`` steps, and on a :class:`SimulatedFailure` (armed by
    ``fail_at_step``, fired once) restores the latest valid checkpoint — or
    starts over when there is none — at most ``MAX_RESTARTS`` times.  The
    losses of replayed steps are logged again, as in the reference.

    ``mesh`` (default: the active mesh when it has more than one rank) runs
    the same loop sharded, on every rank of the mesh at once, each on its
    ``device``: the state is placed by ``mf_distributed.make_sharding_plan``
    (user rows over the data axes, item rows over ``model``), each step
    draws the global batch and exchanges explicitly
    (``mf_distributed.sharded_train_step``), and checkpoints hold the whole
    state (``checkpoint.save(plan=)``).  It returns this rank's state
    (``plan.gather_state`` makes it whole) and the global batch's losses,
    the same on every rank; an injected failure fires on every rank at the
    same step."""
    dev = mf.resolve_device(device)
    if engine is None:
        engine = resolve_engine(cfg)
    mesh = mesh if mesh is not None else shd.active_mesh()
    plan = mfd.make_sharding_plan(cfg, mesh) if mesh is not None else None

    def init_state():
        state = mf.init_mf(seed, cfg, device=dev)
        return plan.place_state(state) if plan is not None else state

    state = init_state()
    dds = pipeline.device_cf_dataset(ds, dev)
    if item_weights is None and engine.sampler_name == "popularity":
        item_weights = dds.item_weights

    def batch_fn(step):
        return pipeline.cf_batch_device(dds, seed, step, batch_size,
                                        cfg.history_len)

    executor = EpochExecutor(
        mf.make_scan_body(cfg, batch_fn, seed, engine=engine,
                          item_weights=item_weights, plan=plan),
        steps_per_dispatch)
    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start, _ = ckpt.restore(ckpt_dir, state, plan=plan)
        log(f"[mf] resumed from step {start}")

    losses: list = []
    step, restarts = start, 0
    while step < steps:
        try:
            if fail_at_step is not None and step == fail_at_step \
                    and restarts == 0:
                raise SimulatedFailure(f"injected failure at step {step}")
            state, window, length = run_window(
                executor, state, step, steps, ckpt_every if ckpt_dir else 0,
                fail_at_step if restarts == 0 else None)
            losses.extend(window)
            step += length
            if ckpt_dir and step % ckpt_every == 0:
                if plan is not None:
                    state = plan.settle(state)
                ckpt.save(ckpt_dir, step, state, plan=plan)
        except SimulatedFailure as e:
            restarts += 1
            if restarts > MAX_RESTARTS or not ckpt_dir:
                raise
            log(f"[mf] {e} -> restoring")
            if ckpt.latest_step(ckpt_dir) is not None:
                state, step, _ = ckpt.restore(ckpt_dir, state, plan=plan)
            else:       # failed before the first checkpoint: start over
                state, step = init_state(), 0
    return state, losses


# ----------------------------------------------------------------------------
# LM trainer
# ----------------------------------------------------------------------------

#: salt of the LM init key, ``fold_in(seed, INIT_STREAM)``: far above any
#: step, so it never meets a step key ``fold_in(seed, step)``.
INIT_STREAM = 1 << 40


@dataclasses.dataclass
class TrainerConfig:
    """LM trainer knobs (steps, lr, batch, checkpointing, failure
    injection, the mesh): the reference's fields.  ``mesh`` (a
    ``distributed.sharding.Mesh``) shards the run; None takes the active
    mesh, if any."""

    steps: int = 100
    lr: float = 1e-3
    batch_size: int = 8
    seq_len: int = 64
    seed: int = 0
    optimizer: str = "adamw"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    fail_at_step: Optional[int] = None      # failure injection
    max_restarts: int = 2
    grad_accum: int = 1
    fixed_batch: bool = False               # overfit one batch (tests/demos)
    steps_per_dispatch: int = 1             # steps per window
    mesh: Optional[Any] = None              # None: the active mesh


class LMTrainState(NamedTuple):
    """The LM training carry: parameter tree, optimizer state, the id-only
    vocab tile (or None) and the step (host int)."""

    params: Any
    opt_state: Any
    tile: Optional[samplers.TileState]
    step: int


def make_lm_train_step_raw(cfg: ArchConfig, opts: lm.TrainOptions,
                           optimizer: Optimizer, lr: float,
                           grad_accum: int = 1, plan=None) -> Callable:
    """``step_fn(state, batch, rng) -> (state, loss)``: the LM step.  ``rng``
    is the step's integer key; ``grad_accum > 1`` splits every tensor of the
    batch (the tokens and any modality extras) along its first dimension
    into that many micro-batches (micro-batch ``i`` keyed ``fold_in(rng,
    i)``), sums
    their gradients in order, divides by ``grad_accum`` and applies one
    optimizer update.  The loss is a 0-d tensor on the device.

    With ``plan`` (an ``lm_distributed.LMShardingPlan``) ``state`` holds
    this rank's slices and ``batch`` is the whole batch: each micro-batch's
    rows are split over the data group (``plan.batch_rows``), each rank's
    loss is weighted by its share of the micro-batch's tokens, the
    gradients are summed over the data group (``plan.sync_grads``) and the
    returned loss is this rank's part of the whole batch's
    (``plan.reduce_losses`` sums the parts); the step runs under the
    plan's mesh."""
    split = plan is not None and plan.data.size > 1

    def one_micro(params, tile, batch, rng):
        weight = None
        if split:
            rows = batch["tokens"].shape[0]
            lo, hi = plan.batch_rows(rows)
            if hi == lo:
                raise ValueError(f"a micro-batch of {rows} rows leaves a "
                                 f"data rank of {plan.data.size} none")
            batch = {k: v[lo:hi] for k, v in batch.items()}
            weight = (hi - lo) / rows
        items = [(path, p.detach().requires_grad_())
                 for path, p in tree_items(params)]
        leaves = [p for _, p in items]
        view = tree_from_items(items)
        if plan is not None:
            view = plan.view(view)
        with torch.enable_grad():
            loss, new_tile = lm.forward_train(view, batch, cfg, opts, rng,
                                              tile)
            if weight is not None:
                loss = loss * weight
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(),
                tree_from_items([(path, g) for (path, _), g in
                                 zip(items, grads)]), new_tile)

    def step_fn(state: LMTrainState, batch: dict, rng: int):
        if plan is not None and shd.get_mesh() is not plan.mesh:
            with shd.use_mesh(plan.mesh):
                return step_fn(state, batch, rng)
        if grad_accum == 1:
            loss, grads, tile = one_micro(state.params, state.tile, batch, rng)
        else:
            micro = {k: v.reshape((grad_accum, -1) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            g_sum = tree_map(torch.zeros_like, state.params)
            tile, losses = state.tile, []
            for i in range(grad_accum):
                loss_i, g, tile = one_micro(state.params, tile,
                                            {k: v[i] for k, v in micro.items()},
                                            mf.fold_in(rng, i))
                g_sum = tree_map(torch.add, g_sum, g)
                losses.append(loss_i)
            grads = tree_map(lambda g: g / grad_accum, g_sum)
            loss = torch.stack(losses).mean()
        if plan is None:
            params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params, lr)
        else:
            params, opt_state = plan.update(plan.sync_grads(grads),
                                            state.opt_state, state.params, lr)
        return LMTrainState(params, opt_state, tile, state.step + 1), loss

    return step_fn


def init_lm_state(seed: int, cfg: ArchConfig, opts: lm.TrainOptions,
                  optimizer: Optimizer, dtype=torch.float32,
                  device=None, plan=None) -> LMTrainState:
    """Fresh :class:`LMTrainState` on ``device`` (the card by default):
    parameters from ``fold_in(fold_in(seed, INIT_STREAM), 0)``, and with the
    HEAT head and ``cfg.heat.tile_size > 0`` an id-only vocab tile from
    ``fold_in(..., 1)``.  With ``plan`` the parameters and the optimizer
    state are this rank's slices of the unsharded state's (the tile is the
    same on every rank)."""
    dev = mf.resolve_device(device)
    key = mf.fold_in(seed, INIT_STREAM)
    params = lm.init_params(mf.fold_in(key, 0), cfg, dtype, dev,
                            mesh=None if plan is None else plan.mesh)
    tile = None
    if opts.loss == "heat" and cfg.heat.enabled and cfg.heat.tile_size:
        tile = samplers.id_tile_init(mf.generator(mf.fold_in(key, 1), dev),
                                     cfg.vocab, cfg.heat.tile_size)
    opt_state = (optimizer.init(params) if plan is None
                 else plan.init_opt_state(dev))
    return LMTrainState(params, opt_state, tile, 0)


def lm_window_body(cfg: ArchConfig, opts: lm.TrainOptions, tcfg: TrainerConfig,
                   optimizer: Optimizer, extras_spec: Optional[dict] = None,
                   device=None, plan=None) -> Callable:
    """:func:`train_lm`'s window body, ``body(state, step) -> (state,
    loss)``: the step on ``pipeline.lm_batch`` drawn on ``device`` from
    (seed, step) (``tcfg.fixed_batch``: always step 0's, with
    ``extras_spec``'s modality inputs) with the key ``fold_in(seed,
    step)``; with ``plan``, the sharded step on the whole batch."""
    step_fn = make_lm_train_step_raw(cfg, opts, optimizer, tcfg.lr,
                                     tcfg.grad_accum, plan)

    def body(state: LMTrainState, step: int):
        batch = pipeline.lm_batch(0 if tcfg.fixed_batch else step,
                                  tcfg.batch_size, tcfg.seq_len, cfg.vocab,
                                  tcfg.seed, device, extras_spec)
        return step_fn(state, batch, mf.fold_in(tcfg.seed, step))

    return body


def train_lm(cfg: ArchConfig, opts: lm.TrainOptions, tcfg: TrainerConfig,
             extras_spec: Optional[dict] = None, *, device=None,
             log: Callable[[str], None] = print):
    """End-to-end LM training with restart on failure; returns
    ``(state, losses)``.  ``extras_spec`` (``{name: (shape, dtype)}``) adds
    the modality inputs to every batch (``pipeline.lm_batch(extras=)``: a
    VLM's ``patches``).

    Runs on the card unless ``device`` names another device.  Batches are
    drawn on the device from (seed, step) (``tcfg.fixed_batch``: always
    step 0's), the step key is ``fold_in(seed, step)``, and the steps run in
    windows of ``tcfg.steps_per_dispatch`` whose losses are read back once
    per window.  With ``tcfg.ckpt_dir`` the run resumes from its latest
    checkpoint, saves every ``tcfg.ckpt_every`` steps, and on a
    :class:`SimulatedFailure` (armed by ``tcfg.fail_at_step``, fired once)
    restores the latest valid checkpoint — or starts over when there is
    none — at most ``tcfg.max_restarts`` times.

    ``tcfg.mesh`` (or, without one, the active mesh) runs the same loop
    sharded on every rank of the mesh, each on its ``device``, as the
    reference's mesh does (``models/lm_distributed.py``): it returns this
    rank's state (``plan.gather_state`` makes it whole) and the whole
    batch's losses, the same on every rank; checkpoints hold the whole
    state and restore onto any mesh."""
    mesh = tcfg.mesh if tcfg.mesh is not None else shd.get_mesh()
    if mesh is not None and shd.get_mesh() is not mesh:
        with shd.use_mesh(mesh):
            return train_lm(cfg, opts, tcfg, extras_spec, device=device,
                            log=log)
    dev = mf.resolve_device(device)
    optimizer = get_optimizer(tcfg.optimizer)
    plan = None if mesh is None else lmd.LMShardingPlan(cfg, mesh, optimizer)
    state = init_lm_state(tcfg.seed, cfg, opts, optimizer, device=dev,
                          plan=plan)
    executor = EpochExecutor(lm_window_body(cfg, opts, tcfg, optimizer,
                                            extras_spec, dev, plan),
                             tcfg.steps_per_dispatch,
                             reduce=None if plan is None else plan.reduce_losses)
    start = 0
    if tcfg.ckpt_dir and ckpt.latest_step(tcfg.ckpt_dir) is not None:
        state, start, _ = ckpt.restore(tcfg.ckpt_dir, state, plan=plan)
        log(f"[trainer] resumed from step {start}")

    losses: list = []
    step, restarts = start, 0
    while step < tcfg.steps:
        try:
            if tcfg.fail_at_step is not None and step == tcfg.fail_at_step \
                    and restarts == 0:
                raise SimulatedFailure(f"injected failure at step {step}")
            state, window, length = run_window(
                executor, state, step, tcfg.steps,
                tcfg.ckpt_every if tcfg.ckpt_dir else 0,
                tcfg.fail_at_step if restarts == 0 else None)
            losses.extend(window)
            if tcfg.log_every:
                for i in range(step, step + length):
                    if i % tcfg.log_every == 0:
                        log(f"[trainer] step {i} loss {window[i - step]:.4f}")
            step += length
            if tcfg.ckpt_dir and step % tcfg.ckpt_every == 0:
                ckpt.save(tcfg.ckpt_dir, step, state, plan=plan)
        except SimulatedFailure as e:
            restarts += 1
            if restarts > tcfg.max_restarts or not tcfg.ckpt_dir:
                raise
            log(f"[trainer] {e} -> restoring latest checkpoint")
            if ckpt.latest_step(tcfg.ckpt_dir) is not None:
                state, step, _ = ckpt.restore(tcfg.ckpt_dir, state, plan=plan)
            else:
                state = init_lm_state(tcfg.seed, cfg, opts, optimizer,
                                      device=dev, plan=plan)
                step = 0
    return state, losses
