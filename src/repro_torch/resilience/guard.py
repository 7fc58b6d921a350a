"""Divergence guard: round-edge finite/spike checks on the loss and the
tables (the port of ``src/repro/resilience/guard.py``).

Numerical blowups (a bad batch, an over-large lr, a poisoned ingest) do not
announce themselves: a NaN row silently propagates through every later
window, into the checkpoint, and out the serving path.  The guard makes the
*round edge* — where the service already reads the window's losses back to
the host — the detection point:

* **loss checks** ride that readback: finiteness, an absolute ceiling, and
  a spike test against a running (EMA) reference;
* **table checks** build one (4,) fp32 tensor on the tables' device (both
  all-finite flags and both largest row norms, through
  ``optim/quantization.py::table_all_finite`` / ``::max_row_norm``, so fp32
  and int8 tables alike) and read it back once, so nothing is read back per
  step.

On a trip the :class:`~repro_torch.stream.service.StreamingTrainer` rolls
back to the last good checkpoint and skips past the poison window by
salting the window's start step, so the (seed, step)-pure draws take a
disjoint step range.  The trip reasons are the reference's strings.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.optim import quantization as qz


class DivergenceError(RuntimeError):
    """The divergence guard tripped: training state is poisoned."""


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Round-edge divergence thresholds (the reference's defaults).

    They are deliberately loose — orders of magnitude above any healthy CCL
    trajectory — because a guard that false-trips costs a full rollback and
    replay; the spike test is the tight one and it is *relative* (against
    the run's own EMA reference)."""

    max_loss: float = 1e4           # absolute per-step loss ceiling
    spike_factor: float = 100.0     # round mean vs running EMA reference
    ema_decay: float = 0.9          # EMA weight on the previous reference
    max_table_norm: float = 1e3     # max embedding row L2 norm


def table_stats(user_table: qz.Table, item_table: qz.Table) -> np.ndarray:
    """(4,) fp32 host array ``[user finite, item finite, max user row norm,
    max item row norm]``, built as one device tensor and read back once.
    For int8 tables the finiteness covers the fp32 scales (an int8 payload
    cannot hold NaN) and a row's norm is ``scale_r * ||q_r||``."""
    stats = torch.stack([
        qz.table_all_finite(user_table).to(torch.float32),
        qz.table_all_finite(item_table).to(torch.float32),
        qz.max_row_norm(user_table).to(torch.float32),
        qz.max_row_norm(item_table).to(torch.float32),
    ])
    return stats.cpu().numpy()


class DivergenceGuard:
    """Stateful round-edge divergence detector.

    ``check(params, window)`` returns ``None`` when the round is healthy
    (and folds its mean loss into the EMA reference) or a human-readable
    trip reason.  The guard is a pure function of the windows and tables it
    has seen, so two identical trajectories trip identically."""

    def __init__(self, cfg: Optional[GuardConfig] = None):
        self.cfg = cfg or GuardConfig()
        self._loss_ref: Optional[float] = None
        self.checks = 0
        self.trips = 0
        self.last_trip: Optional[str] = None

    def check(self, params, window) -> Optional[str]:
        """``params``: an ``mf.MFParams``; ``window``: the round's host loss
        array (the readback the driver already does).  The table stats are
        read only when the loss checks pass, as in the reference."""
        self.checks += 1
        cfg = self.cfg
        w = np.asarray(window, np.float64)
        reason = None
        if w.size and not np.all(np.isfinite(w)):
            bad = int(np.argmax(~np.isfinite(w)))
            reason = f"non-finite loss at window offset {bad}"
        elif w.size and float(np.max(np.abs(w))) > cfg.max_loss:
            reason = (f"loss {float(np.max(np.abs(w))):.3g} above the "
                      f"absolute ceiling {cfg.max_loss:.3g}")
        elif (self._loss_ref is not None and w.size
              and float(np.mean(np.abs(w)))
              > cfg.spike_factor * max(self._loss_ref, 1e-6)):
            reason = (f"loss spiked to {float(np.mean(np.abs(w))):.3g} "
                      f"({cfg.spike_factor:.0f}x over the running reference "
                      f"{self._loss_ref:.3g})")
        else:
            stats = table_stats(params.user_table, params.item_table)
            if stats[0] < 1.0:
                reason = "non-finite values in the user table"
            elif stats[1] < 1.0:
                reason = "non-finite values in the item table"
            elif float(np.max(stats[2:])) > cfg.max_table_norm:
                reason = (f"embedding row norm {float(np.max(stats[2:])):.3g}"
                          f" above the ceiling {cfg.max_table_norm:.3g}")
        if reason is not None:
            self.trips += 1
            self.last_trip = reason
            return reason
        if w.size:
            mean = float(np.mean(np.abs(w)))
            self._loss_ref = (mean if self._loss_ref is None else
                              cfg.ema_decay * self._loss_ref
                              + (1.0 - cfg.ema_decay) * mean)
        return None

    def reset(self) -> None:
        """Forget the EMA reference (called on rollback: the replayed rounds
        rebuild it exactly as a restarted process would)."""
        self._loss_ref = None
