"""In-program spans: where the host's time in a training step goes, phase by
phase, on a clock that a device trace can be joined with.

A span is a named interval of the host's clock (``time.perf_counter_ns``)
with the index of the span that holds it and the step it belongs to (the
identifier that every span of one step shares).  Spans are recorded only
while a ``torch.profiler`` session is active in the process, into one
bounded in-memory :class:`Recorder` (:data:`RECORDER`): a traced stretch
records them, every other call pays one check a span
(``torch._C._autograd._profiler_enabled()``) and records nothing.  Spans
past the recorder's capacity are dropped and counted.  :func:`read` returns
what was recorded and :func:`clear` forgets it.

The names the port records (the MF step's phases in ``core/mf.py``; the
window and its steps in ``train/trainer.py::EpochExecutor``; a streaming
round's phases in ``stream/service.py``):

=================  ==========================================================
``window``         one ``EpochExecutor.run``; opens with an anchor (below)
``step``           one ``body(state, step)`` call of a window
``batch``          the step's batch draw (``make_scan_body``'s ``batch_fn``)
``gather``         one table gather of ``heat_train_step`` (user, positive,
                   history)
``sample``         the sampler: negative ids and rows
``loss``           ``loss_and_grads``: aggregation, CCL forward, backward
``update.user``    the user table's row update
``update.item``    the slot reduction and the item table's row update
``tile.write``     the tile write-through
``tile.refresh``   the tile's redraw, on the steps that redraw
``agg.accumulate`` the aggregator gradients' accumulation
``agg.flush``      the aggregator's flush, on the steps that flush
``round``          one streaming round, holding ``ingest``, ``train``,
                   ``guard`` and ``refresh``
=================  ==========================================================

The single-device MF step records all of its phases.  The sharded MF step
shares the update phases (``update.user`` to ``agg.flush``, in
``core/mf.py::update_phase``) and records those alone besides ``window``
and ``step``; an LM step records the ``window`` and ``step`` spans alone.

**Anchors.**  A recorded ``window`` span that runs with CUDA initialized
brackets one ``cudaStreamQuery`` of the current stream (:data:`ANCHOR_CALL`)
between two host stamps.  That call appears among a device trace's host
calls, waits for nothing, creates nothing and puts no operation on the
device, so the difference between the bracket's midpoint and the traced
call's midpoint maps the spans onto the trace's clock, once a window.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

#: spans a recorder keeps at most; later ones are dropped and counted.
CAPACITY = 1 << 16
#: the CUDA runtime call an anchor brackets, as a device trace names it.
ANCHOR_CALL = "cudaStreamQuery"

_recording = torch._C._autograd._profiler_enabled
_now = time.perf_counter_ns


class Span(NamedTuple):
    """One recorded span: ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``'s clock (``end_ns`` None while it is open),
    ``parent`` the index of the span that holds it (-1 for none), and the
    ``step`` it belongs to (its own, else its parent's; None outside
    steps)."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    step: Optional[int]


class Recording(NamedTuple):
    """What a recorder holds: its spans in the order they opened, its
    anchors ``(before_ns, after_ns)`` around each :data:`ANCHOR_CALL`, and
    the number of spans dropped for want of room."""

    spans: tuple
    anchors: tuple
    dropped: int


class Recorder:
    """A bounded buffer of spans, appended as they open and closed in
    place, from one thread (the training loop's): a span's parent is the
    innermost span open when it opens."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.clear()

    def clear(self) -> None:
        """Forget every span, anchor and drop."""
        self._rows: list = []
        self._open: list = []
        self._anchors: list = []
        self._dropped = 0

    def read(self) -> Recording:
        """The spans, anchors and drops recorded since the last clear."""
        return Recording(tuple(Span(*r) for r in self._rows),
                         tuple(self._anchors), self._dropped)

    def open(self, name: str, step: Optional[int], start_ns: int):
        """Record a span opening at ``start_ns``; returns its row, or None
        when it was dropped."""
        parent = self._open[-1] if self._open else -1
        row, slot = None, -1
        if len(self._rows) >= self.capacity:
            self._dropped += 1
        else:
            if step is None and parent >= 0:
                step = self._rows[parent][4]
            slot = len(self._rows)
            row = [name, start_ns, None, parent, step]
            self._rows.append(row)
        self._open.append(slot)
        return row

    def close(self, row, end_ns: int) -> None:
        """Close the innermost open span, whose row :meth:`open` returned."""
        if self._open:
            self._open.pop()
        if row is not None:
            row[2] = end_ns

    def anchor(self) -> None:
        """Bracket one :data:`ANCHOR_CALL` on the current CUDA stream with
        two stamps, where CUDA is initialized."""
        if not torch.cuda.is_initialized():
            return
        stream = torch.cuda.current_stream()
        before = _now()
        stream.query()
        after = _now()
        self._anchors.append((before, after))


#: the process's recorder: the port records into it, readers read it.
RECORDER = Recorder()


class Timed:
    """A span that always takes its two stamps (``start_ns``, ``end_ns``,
    :attr:`seconds`), and records them while a profiler session is
    active: for phases whose times the program reports itself."""

    __slots__ = ("name", "step", "anchor", "start_ns", "end_ns", "_row",
                 "_open")

    def __init__(self, name: str, step: Optional[int] = None,
                 anchor: bool = False):
        self.name, self.step, self.anchor = name, step, anchor
        self.start_ns = self.end_ns = self._row = None
        self._open = False

    def __enter__(self) -> "Timed":
        self.start_ns = _now()
        self._open = _recording()
        if self._open:
            self._row = RECORDER.open(self.name, self.step, self.start_ns)
            if self.anchor:
                RECORDER.anchor()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = _now()
        if self._open:
            RECORDER.close(self._row, self.end_ns)

    @property
    def seconds(self) -> float:
        """The span's length in seconds."""
        return (self.end_ns - self.start_ns) * 1e-9


class _Off:
    """The span of a call that records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def span(name: str, step: Optional[int] = None, *, when: bool = True,
         anchor: bool = False):
    """A context manager that records a span named ``name`` (of ``step``,
    else of its parent's) while a profiler session is active and ``when``
    holds; otherwise a shared one that does nothing.  ``anchor`` brackets
    an :data:`ANCHOR_CALL` as the span opens."""
    if when and _recording():
        return Timed(name, step, anchor)
    return _OFF


def read() -> Recording:
    """What :data:`RECORDER` holds."""
    return RECORDER.read()


def clear() -> None:
    """Empty :data:`RECORDER`."""
    RECORDER.clear()
