"""One run of one MF training cell.

The window drives the port's MF training loop as ``trainer.train_mf``
composes it: ``mf.init_mf`` from the seed, a ``DeviceCFDataset`` of the
benchmark's own data, ``mf.make_scan_body`` over
``pipeline.cf_batch_device`` with the configuration's engine, and
``trainer.EpochExecutor`` windows of ``steps_per_dispatch`` steps, each
read back at its edge as ``trainer.run_window`` reads it.  Step numbers run
on from set-up, so tile refreshes and aggregator flushes fall where training
puts them.

Set-up: imports, the CUDA context, the data, the tables, and the first
:data:`~heatbench.check.STEPS` steps, kept for the check: one step, then
windows of ``steps_per_dispatch`` steps, which also warm up every shape the
window uses.  Then the window runs whole windows until ``seconds`` have
passed and ends at the last window's readback and one
``torch.cuda.synchronize()``; ``train_samples_per_s`` is the rows of the
batches of those finished steps over that time.  Traced, the window is
followed by :data:`TRACE_WINDOWS` profiled windows; ``train.mfu_pct`` takes
its rate from the untraced window.  Then the program's state is freed and
the reference decides ``correct``.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import time
from typing import Callable

import torch

from heatbench import check, spec, traffic
from heatbench import profiling as tr
from heatbench.reference import mf as ref_mf

TRACE_WINDOWS = 4


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric reader may read: the cell's files, the
    traced stretch, its step count, the batches of its steps ``(users, pos,
    hist or None)``, the tile's ids during it, and the rate of the untraced
    window before it (``train_samples_per_s``)."""

    config: dict
    traffic: dict
    steps: int
    trace: tr.Trace
    batches: list
    tile_ids: torch.Tensor
    samples_per_s: float


class Clock:
    """Host spans of the benchmark's own code: ``(name, seconds)``, from
    ``t0`` on ``time.perf_counter``'s clock."""

    def __init__(self, t0: float, parts=()):
        self.t0 = t0
        self.parts: list = list(parts)

    def part(self, name: str, fn: Callable):
        """Run ``fn()`` and record its seconds under ``name``."""
        start = time.perf_counter()
        out = fn()
        self.parts.append((name, time.perf_counter() - start))
        return out

    def seconds(self, name: str) -> float:
        """Summed seconds of the parts named ``name``."""
        return sum(s for n, s in self.parts if n == name)


class Run:
    """The training object of one cell and seed, driven from the seed
    through its first :data:`~heatbench.check.STEPS` steps (losses and
    touched rows kept for the check), ready for the window."""

    def __init__(self, cell: spec.Cell, seed: int, dev: torch.device,
                 clock: Clock):
        mf, pipeline, trainer, engine = clock.part("import", _import_program)
        if dev.type == "cuda":
            clock.part("cuda_init", lambda: torch.zeros(1, device=dev))
            torch.cuda.reset_peak_memory_stats(dev)
        self.cell, self.seed, self.dev = cell, seed, dev
        fields = {f.name for f in dataclasses.fields(mf.MFConfig)}
        self.cfg = cfg = mf.MFConfig(**{k: v for k, v in cell.config.items()
                                        if k in fields})
        self.rcfg = ref_mf.RefConfig.from_dict(cell.config)
        self.batch = int(cell.traffic["batch_size"])
        self.k = int(cell.traffic["steps_per_dispatch"])

        self.train_pos, weights = clock.part(
            "data", lambda: traffic.make_dataset(
                cfg.num_users, cfg.num_items, cell.traffic, seed, dev))
        dds = pipeline.DeviceCFDataset(cfg.num_users, cfg.num_items,
                                       self.train_pos, weights)
        self.state = clock.part("init",
                                lambda: mf.init_mf(seed, cfg, device=dev))

        def batch_fn(step):
            return pipeline.cf_batch_device(dds, seed, step, self.batch,
                                            cfg.history_len)

        self.batch_fn = batch_fn
        self.executor = trainer.EpochExecutor(
            mf.make_scan_body(cfg, batch_fn, seed,
                              engine=engine.resolve_engine(cfg)), self.k)

        # The training object's first steps, through the window's own call:
        # one step, then whole windows.
        ids = clock.part("check", lambda: ref_mf.touched_ids(
            self.train_pos, self.rcfg, self.batch, seed, check.STEPS))
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

    def free_program(self) -> None:
        """Drop the program's state and its references to the dataset."""
        del self.state, self.executor, self.batch_fn
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, **kw) -> dict:
        """The reference's first steps of this run (keywords as
        :func:`heatbench.reference.mf.run` takes them)."""
        return ref_mf.run(self.train_pos, self.rcfg, self.batch, self.seed,
                          check.STEPS, **kw)

    def readings(self, ref: dict):
        """The compared numbers of the program against ``ref``."""
        return check.readings(self.first_losses, self.snaps, ref, self.cfg.lr)


def timed_window(run: Run, seconds: float, losses: list,
                 log: Callable[[str], None]) -> float:
    """Whole windows until ``seconds`` have passed, ending at the last
    window's readback and a device sync; their losses go to ``losses``.
    Returns the window's wall seconds."""
    t_start = time.perf_counter()
    edges = [t_start]
    while True:
        losses.extend(run.window())
        edges.append(time.perf_counter())
        if edges[-1] - t_start >= seconds:
            break
    run.sync()
    window_s = time.perf_counter() - t_start
    each = sorted(b - a for a, b in zip(edges, edges[1:]))
    log(f"[heatbench] {len(each)} windows of {run.k} steps (s): min "
        f"{each[0]:.6f} median {each[len(each) // 2]:.6f} max "
        f"{each[-1]:.6f}")
    log(f"[heatbench] window: {len(losses)} steps of batch {run.batch} "
        f"in {window_s:.6f} s")
    return window_s


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", t0: float | None = None, parts=(),
             log: Callable[[str], None] = print) -> dict:
    """Run ``cell`` once; returns the result object (the keys of the last
    line) with ``checks`` last.  ``t0`` is the process's start on
    ``time.perf_counter``'s clock (default: now), ``parts`` the set-up
    parts timed before this call."""
    clock = Clock(time.perf_counter() if t0 is None else t0, parts)
    dev = torch.device(device)
    run = Run(cell, seed, dev, clock)
    clock.part("sync", run.sync)
    setup_s = time.perf_counter() - clock.t0 - clock.seconds("check")
    if dev.type == "cuda":
        # The peak of the training that the window runs, not of the
        # check's snapshots in set-up.
        torch.cuda.reset_peak_memory_stats(dev)

    losses: list = []
    window_s = timed_window(run, seconds, losses, log)
    e2e = {"setup_s": setup_s,
           "train_samples_per_s": len(losses) * run.batch / window_s}
    metrics: dict = {}
    device_info: dict = {}
    breakdown = None
    if traced:
        start = run.step

        def stretch():
            for _ in range(TRACE_WINDOWS):
                losses.extend(run.window())

        trace = tr.profile(stretch, dev.type)
        ctx = MetricContext(
            cell.config, cell.traffic, run.step - start, trace,
            [tuple(getattr(run.batch_fn(s), f) for f in
                   ("user_ids", "pos_ids", "hist_ids"))
             for s in range(start, run.step)],
            run.state.tile.tile_ids.clone(), e2e["train_samples_per_s"])
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        busy = trace.busy_s()
        if dev.type == "cuda" and busy > 0:
            device_info.update(busy_s=busy, window_s=trace.window_s)
        breakdown = trace.breakdown()
        del ctx
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    log("[heatbench] set-up parts (s): " + ", ".join(
        f"{n} {s:.6f}" for n, s in clock.parts) + f"; setup_s {setup_s:.6f}")

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = sum(1 for x in losses if not math.isfinite(x))
    run.free_program()
    t_ref = time.perf_counter()
    values, detail = run.readings(run.reference())
    log(f"[heatbench] reference {check.STEPS} steps and comparison: "
        f"{time.perf_counter() - t_ref:.6f} s")
    log("[heatbench] check detail: " + repr(detail))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell.entry["chips"]),
                   "memory_peak_bytes": int(peak), **device_info}
    if dev.type == "cuda":
        device_info["power_limit_w"] = power_limit_w()
    result = {"correct": check.verdict(values, cell.limits) and failed == 0,
              "attempted": len(losses), "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    log("[heatbench] readings: " + ", ".join(
        f"{n} {values[n]!r}" for n in check.NAMES))
    result["checks"] = {n: {"value": values[n], "limit": limit}
                        for n, limit in cell.limits.items()}
    return result


def power_limit_w():
    """The card's power limit in watts as ``nvidia-smi`` reads it, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _import_program():
    from repro_torch.core import engine, mf
    from repro_torch.data import pipeline
    from repro_torch.train import trainer
    return mf, pipeline, trainer, engine
