"""The program's own spans joined with a traced stretch.

The port records spans (``repro_torch/train/spans.py``: ``window``,
``step`` and the MF step's phases) while ``torch.profiler`` runs, on the
host's ``time.perf_counter_ns`` clock.  Each recorded ``window`` opens with
an anchor: one CUDA call (the module's ``ANCHOR_CALL``) between two host
stamps.  The trace holds the same calls among its host calls, on its own
clock, so the median of the anchors' midpoint differences maps every span
onto the trace's clock.

Device time is put down to spans by order.  The host's enqueue calls are
its kernel launches, copies and sets; on the one stream the MF step uses,
the enqueue calls put the device operations (by start time) on the device
in the same order.  The tracer may lose the device records of the first
few launches after it starts (on the H100 with torch 2.11, 0 to 4 of a
stretch's ~10,000–20,000, each a launch whose runtime call the trace does
hold), so calls and operations are paired from the stretch's end: the k-th
last call with the k-th last operation, and the calls left over at the
start put nothing on the record (:attr:`Joined.lost`).  Every pair must
agree in kind (kernel, copy, set): pairs off by one disagree thousands of
times in a stretch.  Where one does not, where there are more operations
than calls, or where the program recorded nothing (a program without
spans), :func:`join` gives None and every reader of it finds nothing.  An
operation belongs to the innermost span that holds the middle of its
enqueue call.  Start times are not compared: the trace's device times lie
up to ~0.6 ms before its host times in places.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import statistics

from heatbench import profiling

#: host calls that put one operation on the device each.
ENQUEUE = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaMemcpy|cudaMemset)")
#: spans whose device time is the row update's.
UPDATE = ("update.user", "update.item", "tile.write")


@dataclasses.dataclass
class Joined:
    """Spans on the trace's clock joined with its device operations.

    ``spans`` are ``(name, start, end, parent, step)`` in seconds on the
    trace's clock, ``ops`` the trace's device operations by start time,
    ``owner[k]`` the index of the innermost span holding the enqueue call
    of ``ops[k]`` (-1 for none), ``offsets`` each anchor's clock offset
    (host seconds less trace seconds), ``steps`` the number of ``step``
    spans and ``lost`` the enqueue calls at the stretch's start whose
    operations the trace does not hold."""

    trace: profiling.Trace
    spans: list
    ops: list
    owner: list
    offsets: list
    steps: int
    lost: int

    def device_us(self, names) -> float:
        """Device microseconds a step of the operations whose innermost
        span is named in ``names``."""
        total = sum(d for (_, _, d), i in zip(self.ops, self.owner)
                    if i >= 0 and self.spans[i][0] in names)
        return 1e6 * total / self.steps

    def step_intervals(self) -> list:
        """``(start, end)`` of every ``step`` span, in order."""
        return sorted((s, e) for name, s, e, _, _ in self.spans
                      if name == "step")


def recording():
    """The program's spans, anchors and drops, or None where the program
    records no span or none was recorded."""
    try:
        from repro_torch.train import spans
    except ImportError:
        return None
    rec = spans.read()
    if not rec.spans:
        return None
    return rec, spans.ANCHOR_CALL


def enqueue_calls(calls: list) -> list:
    """The host's enqueue calls by start time; a call inside another one
    (a driver call under its runtime call) is the same enqueue."""
    out: list = []
    for call in sorted((c for c in calls if ENQUEUE.match(c[0])),
                       key=lambda c: c[1]):
        if out and call[1] + call[2] <= out[-1][1] + out[-1][2]:
            continue
        out.append(call)
    return out


def innermost(spans: list, times: list) -> list:
    """For each of ``times`` (ascending), the index of the innermost of
    ``spans`` (properly nested ``(name, start, end, ...)``) that holds it,
    or -1."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    stack: list = []
    out, j = [], 0
    for t in times:
        while j < len(order) and spans[order[j]][1] <= t:
            i = order[j]
            while stack and spans[stack[-1]][2] < spans[i][1]:
                stack.pop()
            stack.append(i)
            j += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def join(trace: profiling.Trace, recorded=None):
    """The program's recorded spans joined with ``trace`` (default: what
    the program holds now), or None (see the module's docstring)."""
    recorded = recording() if recorded is None else recorded
    if recorded is None:
        return None
    rec, anchor_call = recorded
    calls = sorted((c for c in trace.calls if c[0] == anchor_call),
                   key=lambda c: c[1])
    if not calls or len(calls) != len(rec.anchors):
        return None
    offsets = [(before + after) * 0.5e-9 - (s + d / 2)
               for (before, after), (_, s, d) in zip(rec.anchors, calls)]
    offset = statistics.median(offsets)
    spans = [(sp.name, sp.start_ns * 1e-9 - offset,
              float("inf") if sp.end_ns is None else sp.end_ns * 1e-9 - offset,
              sp.parent, sp.step) for sp in rec.spans]
    steps = sum(1 for sp in spans if sp[0] == "step")
    ops = sorted(trace.ops, key=lambda o: o[1])
    enq = enqueue_calls(trace.calls)
    lost = len(enq) - len(ops)
    if not steps or lost < 0:
        return None
    enq = enq[lost:]
    if any(_kind(call) != _kind(op)
           for (call, _, _), (op, _, _) in zip(enq, ops)):
        return None
    owner = innermost(spans, [s + d / 2 for _, s, d in enq])
    return Joined(trace, spans, ops, owner, offsets, steps, lost)


def _kind(name: str) -> str:
    """``copy``, ``set`` or ``kernel``: what an enqueue call or a device
    operation (``Memcpy ...``, ``Memset ...``) of that name is."""
    low = name.lower()
    return "copy" if "memcpy" in low else "set" if "memset" in low else "kernel"


def host_self_us(joined: Joined) -> float:
    """Host microseconds a step inside ``step`` spans and outside every
    CUDA runtime or driver call."""
    calls = merged((s, s + d) for _, s, d in joined.trace.calls)
    inside = sum(b - a - covered(calls, a, b)
                 for a, b in joined.step_intervals())
    return 1e6 * inside / joined.steps


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted disjoint
    ``[start, end]`` lists."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(union: list, a: float, b: float) -> float:
    """Length of ``[a, b]`` that the disjoint sorted ``union`` covers."""
    total = 0.0
    for s, e in union[max(bisect.bisect_left(union, [a]) - 1, 0):]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


def idle_in_steps_s(joined: Joined) -> float:
    """Seconds of idle gaps between device operations whose middles fall
    inside a ``step`` span."""
    steps = joined.step_intervals()
    starts = [a for a, _ in steps]
    total = 0.0
    for label, s, d in joined.trace.idle_gaps():
        k = bisect.bisect_right(starts, s + d / 2) - 1
        if label != profiling.EDGES and k >= 0 and s + d / 2 <= steps[k][1]:
            total += d
    return total


def by_span(joined: Joined) -> dict:
    """Per span name, a step's: device microseconds of the operations it
    enqueued itself (``device_us``), their number (``launches``), host
    microseconds in it outside its child spans and its own CUDA calls
    (``host_self_us``), and idle device microseconds whose gap's middle it
    holds innermost (``idle_us``)."""
    spans, n = joined.spans, joined.steps
    rows = {name: dict(device_us=0.0, launches=0.0, host_self_us=0.0,
                       idle_us=0.0) for name, *_ in spans}
    for (_, _, d), i in zip(joined.ops, joined.owner):
        if i >= 0:
            rows[spans[i][0]]["device_us"] += 1e6 * d / n
            rows[spans[i][0]]["launches"] += 1 / n
    for name, s, e, parent, _ in spans:
        rows[name]["host_self_us"] += 1e6 * (e - s) / n
        if parent >= 0:
            rows[spans[parent][0]]["host_self_us"] -= 1e6 * (e - s) / n
    calls = merged((s, s + d) for _, s, d in joined.trace.calls)
    for i, (s, e) in zip(innermost(spans, [(s + e) / 2 for s, e in calls]),
                         calls):
        if i >= 0:
            rows[spans[i][0]]["host_self_us"] -= 1e6 * (e - s) / n
    gaps = sorted((s + d / 2, d) for label, s, d in joined.trace.idle_gaps()
                  if label != profiling.EDGES)
    for i, (_, d) in zip(innermost(spans, [m for m, _ in gaps]), gaps):
        if i >= 0:
            rows[spans[i][0]]["idle_us"] += 1e6 * d / n
    return rows
