"""The traced stretch of a run: ``torch.profiler`` over a few steady windows,
read back from its own Chrome trace.

On the card only the device's activity is recorded (CUDA, with the CUDA
runtime and driver calls that CUPTI reports beside it), not the host's
operators, so the tracer adds little host time to a host-paced step.  The
stretch is bounded by a device sync on each side and timed on the host's
clock; nothing runs on the device outside it.  Device operations are the
trace's kernels, copies and sets; busy time is the union of their
intervals, and idle the rest of the stretch.  An idle gap between two device
operations is labelled by what the host was doing at its middle: the CUDA
call that covers it (a launch, a copy, a synchronize), or host Python
between CUDA calls.  Off the card nothing is traced.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Callable

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
PYTHON = "host Python between CUDA calls"
EDGES = "stretch edges, before the first and after the last device operation"
#: entries of each list of a breakdown.
TOP = 10
#: characters of a device operation's name kept in a breakdown: enough to
#: tell template instances apart, short enough for the ledger.
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    """A traced stretch of ``window_s`` host seconds: ``ops`` are ``(name,
    start, dur)`` of device operations, ``calls`` the same of the host's
    CUDA calls, in seconds on the trace's own clock."""

    window_s: float
    ops: list
    calls: list

    def busy_intervals(self) -> list:
        """Merged ``[start, end]`` intervals in which a device operation
        runs."""
        out: list = []
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            e = s + d
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        """Seconds in which some device operation runs."""
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> list:
        """``(label, start, dur)`` of each gap between device operations,
        labelled by :meth:`label_at` its middle, and last the idle time
        at the stretch's edges (its wall time less the span from the first
        device operation's start to the last one's end)."""
        busy = self.busy_intervals()
        if not busy:
            return [(EDGES, 0.0, self.window_s)]
        gaps = [(self.label_at((a[1] + b[0]) / 2), a[1], b[0] - a[1])
                for a, b in zip(busy, busy[1:])]
        edges = self.window_s - (busy[-1][1] - busy[0][0])
        return gaps + [(EDGES, busy[-1][1], max(edges, 0.0))]

    def label_at(self, t: float) -> str:
        """The host's CUDA call covering time ``t`` (the shortest), or
        :data:`PYTHON` where none does."""
        best = None
        for name, s, d in self.calls:
            if s <= t <= s + d and (best is None or d < best[1]):
                best = (name, d)
        return best[0] if best else PYTHON

    def device_time_s(self, match: Callable[[str], bool]) -> float:
        """Summed duration of the device operations whose names match."""
        return sum(d for name, _, d in self.ops if match(name))

    def breakdown(self) -> dict:
        """The ``breakdown`` of a traced result: the device operations that
        took most time in all, and idle time by what the host was doing
        (total and longest gap of each label)."""
        by_op: dict = {}
        for name, _, d in self.ops:
            by_op[name] = by_op.get(name, 0.0) + d
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        ops = [(n[:NAME_CHARS], s) for n, s in ops]
        by_label: dict = {}
        for label, _, d in self.idle_gaps():
            total, longest, count = by_label.get(label, (0.0, 0.0, 0))
            by_label[label] = (total + d, max(longest, d), count + 1)
        gaps = []
        for label, (total, longest, count) in sorted(
                by_label.items(), key=lambda kv: -kv[1][0]):
            gaps.append([f"{label}: all {count} gaps", total])
            gaps.append([f"{label}: longest gap", longest])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": gaps[:TOP]}


def read_chrome_trace(path: str, window_s: float) -> Trace:
    """Parse an exported trace of a stretch of ``window_s`` host seconds
    into a :class:`Trace`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, calls = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        item = (e.get("name", ""), float(e["ts"]) * 1e-6,
                float(e["dur"]) * 1e-6)
        if cat in DEVICE_CATS:
            ops.append(item)
        elif cat in HOST_CATS:
            calls.append(item)
    return Trace(window_s, ops, calls)


def profile(run: Callable[[], None], device_type: str) -> Trace:
    """Run ``run()`` between two device syncs, under ``torch.profiler``
    recording the device's activity on the card, and read the trace back.
    The trace file lives in ``TMPDIR`` only while it is read.  Off the card
    the stretch is timed and nothing is traced."""
    import torch

    if device_type != "cuda":
        start = time.perf_counter()
        run()
        return Trace(time.perf_counter() - start, [], [])
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - start
    fd, path = tempfile.mkstemp(prefix="heatbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, window_s)
    finally:
        os.remove(path)
