"""The comparison that decides ``correct``.

Set-up drives the program's training object through its first
:data:`STEPS` steps through the window's own call, and keeps the losses,
the rows those steps touch (fp64; an int8 table's payload plus its
residual) and the aggregator's weights and accumulator: before the first
step, after it, and after the last.  :data:`STEPS` reaches past the
aggregator's first flush (every 32 steps), so the flush's update of the
weights and its fresh accumulator are compared too.  After the window has
closed, the reference works the same steps out again from the seed and the
dataset, and these numbers are compared, each against its limit:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient as the optimizer got it, worked
  out from the state after one step (tables: ``(before - after) / lr``;
  the aggregator: its accumulator), by the worst leaf;
* ``change_gap``: the change after the steps, as the next step keeps it
  (tables: ``after - before``; ``agg.w``: the aggregator's weights after
  less before, which the flush moved; ``agg.acc``: its accumulator since
  the flush), by the worst leaf.

A leaf's gap is ``|norm_program - norm_reference|`` over the larger of the
reference's norm of that leaf and the median leaf's.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
(the aggregator's change leaves follow its gradient).
``grad_gap_median`` and ``change_gap_median`` are the same gaps of the
median leaf.  A cell's limits file names the numbers it compares; every run
reports all five (``PERF.md`` gives the readings behind each limit).
"""
from __future__ import annotations

import math
import statistics

import torch

#: steps the reference follows: one past the aggregator's first flush.
STEPS = 33
NAMES = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median",
         "change_gap_median")


def table_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """fp64 host rows ``ids`` of a program table (an int8 table: payload
    times scale plus residual times its scale), copied off the device in
    their stored types so that the check adds little to the device's
    peak."""
    if hasattr(table, "q"):
        q, s, e, es = (t[ids].cpu().double() for t in (
            table.q, table.scale, table.err, table.err_scale))
        return q * s + e * es
    return table[ids].cpu().double()


def snapshot(state, ids) -> dict:
    """The program's rows at the reference's touched ids, and its
    aggregator's weights and accumulator, from an ``MFState``, on the
    host."""
    users, items = ids
    out = {"user": table_rows(state.params.user_table, users),
           "item": table_rows(state.params.item_table, items)}
    if state.accum is not None:
        out["agg.w"] = state.params.aggregator.w.cpu().double()
        out["agg.acc"] = state.accum.grad_sum.w.cpu().double()
    return out


#: the gradient leaf that each change leaf follows.
BASE = {"user": "user", "item": "item", "agg.w": "agg.w", "agg.acc": "agg.w"}


def _leaf_norms(snaps: dict, lr: float):
    first, last, before = snaps[1], snaps[STEPS], snaps[0]
    grad, change = {}, {}
    for leaf in ("user", "item"):
        grad[leaf] = ((before[leaf] - first[leaf]) / lr).norm().item()
        change[leaf] = (last[leaf] - before[leaf]).norm().item()
    if "agg.w" in before:
        grad["agg.w"] = first["agg.acc"].norm().item()
        change["agg.w"] = (last["agg.w"] - before["agg.w"]).norm().item()
        change["agg.acc"] = last["agg.acc"].norm().item()
    return grad, change


def _gaps(prog: dict, ref: dict, kept) -> dict:
    median = statistics.median(ref[leaf] for leaf in kept)
    return {leaf: abs(prog[leaf] - ref[leaf]) / max(ref[leaf], median)
            for leaf in kept}


def _worst(gaps: dict) -> float:
    return max(gaps.values(), key=lambda g: math.inf if math.isnan(g) else g)


def readings(prog_losses, prog_snaps: dict, ref: dict, lr: float):
    """``({name: reading}, detail)``: the three compared numbers, and the
    per-leaf norms behind them."""
    pg, pc = _leaf_norms(prog_snaps, lr)
    rg, rc = _leaf_norms({n: {leaf: t.cpu() for leaf, t in snap.items()}
                          for n, snap in ref["snaps"].items()}, lr)
    median = statistics.median(rg.values())
    kept = [leaf for leaf in rg if rg[leaf] >= 1e-3 * median]
    kept_change = [leaf for leaf in rc if BASE[leaf] in kept]
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog_losses,
                                                     ref["losses"]))
    if not all(math.isfinite(p) for p in prog_losses):
        loss = math.inf
    grad, change = _gaps(pg, rg, kept), _gaps(pc, rc, kept_change)
    detail = {"losses": {"program": list(prog_losses),
                         "reference": list(ref["losses"])},
              "grad_norms": {"program": pg, "reference": rg, "gaps": grad},
              "change_norms": {"program": pc, "reference": rc,
                               "gaps": change},
              "leaves_kept": kept}
    return {"loss_gap": loss, "grad_gap": _worst(grad),
            "change_gap": _worst(change),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap_median": statistics.median(change.values())}, detail


def verdict(values: dict, limits: dict) -> bool:
    """True when every number that ``limits`` names is finite and within
    its limit."""
    return all(math.isfinite(values[n]) and values[n] <= limit
               for n, limit in limits.items())
