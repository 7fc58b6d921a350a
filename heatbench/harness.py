"""One run of one training cell, of any configuration kind.

The cell's kind (``kinds/<kind>.py``, found by the configuration's
``"kind"``; ``heatbench/kinds/__init__.py`` gives the contract) builds the
training object: set-up runs imports, the CUDA context, the data, the
model's state, and the first steps that the kind's check follows, which
also warm up every shape the window uses.  Then the window runs whole
windows of the kind's ``k`` steps until ``seconds`` have passed and ends at
the last window's readback and one ``torch.cuda.synchronize()``;
``train_samples_per_s`` is the kind's ``rows`` a step times those finished
steps over that time.  Traced, the window is followed by
:data:`TRACE_WINDOWS` profiled windows; ``train.mfu_pct`` takes its rate
from the untraced window.  Then the program's state is freed and the kind's
plain reference decides ``correct``.
"""
from __future__ import annotations

import dataclasses
import math
import subprocess
import time
from typing import Callable

import torch

from heatbench import check, spec
from heatbench import profiling as tr

TRACE_WINDOWS = 4


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric reader may read: the cell's files, the
    traced stretch, its step count, the batches of its steps ``(users, pos,
    hist or None)`` and the tile's ids during it (the ``mf`` kind's; empty
    and None in another kind), the rate of the untraced window before it
    (``train_samples_per_s``), the cell's kind module (None: ``mf``), and
    whatever else the kind hands its own readers (``extra``)."""

    config: dict
    traffic: dict
    steps: int
    trace: tr.Trace
    batches: list
    tile_ids: torch.Tensor
    samples_per_s: float
    kind: object = None
    extra: dict = dataclasses.field(default_factory=dict)


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


def Run(cell: spec.Cell, seed: int, dev: torch.device, clock: Clock):
    """The run object of ``cell``'s kind (``kinds/<kind>.py``'s
    ``build``), driven from the seed through the first steps its check
    follows, ready for the window."""
    return spec.kind_module(cell.kind).build(cell, seed, dev, clock)


def timed_window(run, seconds: float, losses: list,
                 log: Callable[[str], None]) -> float:
    """Whole windows of ``run`` (a kind's run object) until ``seconds``
    have passed, ending at the last window's readback and a device sync;
    their losses go to ``losses``.  Returns the window's wall seconds."""
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
    log(f"[heatbench] window: {len(losses)} steps of {run.rows} rows "
        f"in {window_s:.6f} s")
    return window_s


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", t0: float | None = None, parts=(),
             log: Callable[[str], None] = print) -> dict:
    """Run ``cell`` once; returns the result object (the keys of the last
    line) with ``checks`` last.  ``t0`` is the process's start on
    ``time.perf_counter``'s clock (default: now), ``parts`` the set-up
    parts timed before this call."""
    kind = spec.kind_module(cell.kind)
    unknown = sorted(set(cell.limits) - set(kind.NAMES))
    if unknown:
        raise ValueError(f"cell {cell.name!r} limits {unknown}, which its "
                         f"kind {cell.kind!r} does not report: {kind.NAMES}")
    clock = Clock(time.perf_counter() if t0 is None else t0, parts)
    dev = torch.device(device)
    run = kind.build(cell, seed, dev, clock)
    clock.part("sync", run.sync)
    setup_s = time.perf_counter() - clock.t0 - clock.seconds("check")
    if dev.type == "cuda":
        # The peak of the training that the window runs, not of the
        # check's snapshots in set-up.
        torch.cuda.reset_peak_memory_stats(dev)

    losses: list = []
    window_s = timed_window(run, seconds, losses, log)
    e2e = {"setup_s": setup_s,
           "train_samples_per_s": len(losses) * run.rows / window_s}
    metrics: dict = {}
    device_info: dict = {}
    breakdown = None
    if traced:
        start = run.step

        def stretch():
            for _ in range(TRACE_WINDOWS):
                losses.extend(run.window())

        trace = tr.profile(stretch, dev.type)
        inputs = {"batches": [], "tile_ids": None, **run.metric_inputs(start)}
        ctx = MetricContext(cell.config, cell.traffic, run.step - start, trace,
                            samples_per_s=e2e["train_samples_per_s"],
                            kind=kind, **inputs)
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
    values, detail = run.readings()
    log(f"[heatbench] reference and comparison: "
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
        f"{n} {values[n]!r}" for n in kind.NAMES))
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
