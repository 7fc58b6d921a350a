"""The ``mf`` kind: HEAT's MF model trained as ``trainer.train_mf`` composes
it.

The run drives ``mf.init_mf`` from the seed, a ``DeviceCFDataset`` of the
benchmark's own data (``heatbench/traffic.py``), ``mf.make_scan_body``
over ``pipeline.cf_batch_device`` with the configuration's engine, and
``trainer.EpochExecutor`` windows of ``steps_per_dispatch`` steps, each read
back at its edge as ``trainer.run_window`` reads it.  Step numbers run on
from set-up, so tile refreshes and aggregator flushes fall where training
puts them.  Set-up runs the first :data:`~heatbench.check.STEPS` steps, kept
for the check: one step, then windows of ``steps_per_dispatch`` steps, which
also warm up every shape the window uses.  The check is
:mod:`heatbench.check` against :mod:`heatbench.reference.mf`.  A
configuration's file holds every ``MFConfig`` field at the top level.
"""
from __future__ import annotations

import dataclasses
import gc

import torch

from heatbench import check, peaks, traffic, work
from heatbench.reference import mf as ref_mf

NAMES = check.NAMES
FAULTS = tuple(f for f in ref_mf.FAULTS if f)
CONTROL = {"precision": "tf32"}


class Run:
    """The training object of one cell and seed, driven from the seed
    through its first :data:`~heatbench.check.STEPS` steps (losses and
    touched rows kept for the check), ready for the window."""

    def __init__(self, cell, seed: int, dev: torch.device, clock):
        mf, pipeline, trainer, engine = clock.part("import", _import_program)
        if dev.type == "cuda":
            clock.part("cuda_init", lambda: torch.zeros(1, device=dev))
            torch.cuda.reset_peak_memory_stats(dev)
        self.cell, self.seed, self.dev = cell, seed, dev
        fields = {f.name for f in dataclasses.fields(mf.MFConfig)}
        self.cfg = cfg = mf.MFConfig(**{k: v for k, v in cell.config.items()
                                        if k in fields})
        self.rcfg = ref_mf.RefConfig.from_dict(cell.config)
        self.rows = int(cell.traffic["batch_size"])
        self.k = int(cell.traffic["steps_per_dispatch"])

        self.train_pos, weights = clock.part(
            "data", lambda: traffic.make_dataset(
                cfg.num_users, cfg.num_items, cell.traffic, seed, dev))
        dds = pipeline.DeviceCFDataset(cfg.num_users, cfg.num_items,
                                       self.train_pos, weights)
        self.state = clock.part("init",
                                lambda: mf.init_mf(seed, cfg, device=dev))

        def batch_fn(step):
            return pipeline.cf_batch_device(dds, seed, step, self.rows,
                                            cfg.history_len)

        self.batch_fn = batch_fn
        self.executor = trainer.EpochExecutor(
            mf.make_scan_body(cfg, batch_fn, seed,
                              engine=engine.resolve_engine(cfg)), self.k)

        # The training object's first steps, through the window's own call:
        # one step, then whole windows.
        ids = clock.part("check", lambda: ref_mf.touched_ids(
            self.train_pos, self.rcfg, self.rows, seed, check.STEPS))
        self.snaps = {0: clock.part(
            "check", lambda: check.snapshot(self.state, ids))}
        self.first_losses: list = []
        self.step = 0
        while self.step < check.STEPS:
            length = 1 if self.step == 0 else min(self.k,
                                                  check.STEPS - self.step)
            self.first_losses += clock.part(
                "first_steps", lambda: self.run(length).cpu().tolist())
            if self.step in (1, check.STEPS):
                self.snaps[self.step] = clock.part(
                    "check", lambda: check.snapshot(self.state, ids))
        del ids

    def run(self, length: int):
        """Enqueue ``length`` steps from the current one; returns the
        window's device losses."""
        self.state, window = self.executor.run(self.state, self.step, length)
        self.step += length
        return window

    def window(self) -> list:
        """One window and its readback at the edge; returns its host
        losses."""
        return self.run(self.k).cpu().tolist()

    def sync(self) -> None:
        """Wait for the device."""
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def metric_inputs(self, start: int) -> dict:
        """The batches ``(users, pos, hist or None)`` of the steps from
        ``start`` on, and the tile's ids."""
        return {"batches": [tuple(getattr(self.batch_fn(s), f) for f in
                                  ("user_ids", "pos_ids", "hist_ids"))
                            for s in range(start, self.step)],
                "tile_ids": self.state.tile.tile_ids.clone()}

    def free_program(self) -> None:
        """Drop the program's state and its references to the dataset."""
        del self.state, self.executor, self.batch_fn
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, **kw) -> dict:
        """The reference's first steps of this run (keywords as
        :func:`heatbench.reference.mf.run` takes them)."""
        return ref_mf.run(self.train_pos, self.rcfg, self.rows, self.seed,
                          check.STEPS, **kw)

    def readings(self):
        """The compared numbers of the program against the reference."""
        return check.readings(self.first_losses, self.snaps, self.reference(),
                              self.cfg.lr)


def build(cell, seed: int, dev: torch.device, clock) -> Run:
    """The run of ``cell`` from ``seed`` on ``dev``."""
    return Run(cell, seed, dev, clock)


def reference_reading(cell, seed: int, dev, **kw) -> dict:
    """The reference under ``kw`` (a lower precision or a fault) in the
    program's place, against the fp32 reference, for one seed."""
    rcfg = ref_mf.RefConfig.from_dict(cell.config)
    batch = int(cell.traffic["batch_size"])
    train_pos, _ = traffic.make_dataset(rcfg.num_users, rcfg.num_items,
                                        cell.traffic, seed, dev)
    ref = ref_mf.run(train_pos, rcfg, batch, seed, check.STEPS)
    other = ref_mf.run(train_pos, rcfg, batch, seed, check.STEPS, **kw)
    values, detail = check.readings(other["losses"], other["snaps"], ref,
                                    rcfg.lr)
    return {"values": values, "detail": detail}


def model_flops(config: dict, traffic_mix: dict):
    """Model FLOPs of one batch row (``work.step_model_flops``: the CCL's
    dots and norms, and with history the average and the (K, K) aggregator
    product, each forward and backward once), and the fp32 peak off the
    tensor cores (both configurations compute in fp32, TF32 off)."""
    b = traffic_mix["batch_size"]
    flops = work.step_model_flops(b, config["num_negatives"],
                                  config["emb_dim"], config["history_len"])
    return flops / b, peaks.FP32_FLOP_PER_S


def _import_program():
    from repro_torch.core import engine, mf
    from repro_torch.data import pipeline
    from repro_torch.train import trainer
    return mf, pipeline, trainer, engine
