"""Call-shape budgets: the port's form of the reference's trace counters.

The reference jit-compiles its hot paths and counts traces
(``analysis/sanitize.py::TraceCounter``): a steady state that retraces
recompiles on every call.  The port has no jit, so nothing is traced; what
the reference's budget protects is still observable as the set of distinct
shapes an entry point is called with (window lengths of the executor, padded
event batches of ``apply_events``, padded request batches of the server).
:class:`ShapeCounter` counts them and raises :class:`RetraceError` past its
budget, as the reference's counter does.
"""
from __future__ import annotations

from typing import Hashable, Optional


class RetraceError(RuntimeError):
    """An entry point saw more distinct call shapes than its budget."""


class ShapeCounter:
    """Distinct call shapes of one entry point, with an optional budget.

    ``add(shape)`` records a call; past ``budget`` distinct shapes it
    raises :class:`RetraceError` (the shape stays recorded, so the count
    shows the overrun).  ``count`` mirrors the reference's
    ``TraceCounter.count``: one per distinct shape, never per call."""

    def __init__(self, label: str, budget: Optional[int] = None):
        self.label = label
        self.budget = budget
        self._shapes: set = set()

    @property
    def count(self) -> int:
        """Distinct shapes seen since the last reset."""
        return len(self._shapes)

    def add(self, shape: Hashable) -> None:
        """Record one call of ``shape``; raises past the budget."""
        self._shapes.add(shape)
        if self.budget is not None and len(self._shapes) > self.budget:
            raise RetraceError(
                f"'{self.label}' was called with {len(self._shapes)} shapes "
                f"({sorted(self._shapes)}), budget {self.budget}: a steady "
                "state must keep one shape")

    def check(self) -> None:
        """Raise :class:`RetraceError` when more distinct shapes than the
        budget were seen."""
        if self.budget is not None and len(self._shapes) > self.budget:
            raise RetraceError(
                f"'{self.label}' was called with {len(self._shapes)} shapes, "
                f"budget {self.budget}: a steady state must keep one shape")

    def reset(self) -> None:
        """Forget every shape seen."""
        self._shapes = set()
