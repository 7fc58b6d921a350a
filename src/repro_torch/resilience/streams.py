"""Stream fault tolerance: retrying wrapper + deterministic fault injector
(the port's copy of ``src/repro/resilience/streams.py``; numpy only, so the
backoff schedule is the reference's).

Both classes implement the :class:`~repro_torch.stream.sources.InteractionStream`
protocol, so they compose with every existing source and with each other:

    RetryingStream(FlakyStream(SyntheticStream(...), failures={...}))

:class:`RetryingStream` absorbs *transient* source failures (a flaky
socket, a log shard mid-rotation) with exponential backoff + seeded jitter,
re-seeking the base to the pre-call cursor before every retry so a
partially-advanced source can never double-deliver events — the service's
bit-exact (seed, cursor) replay contract survives the retries.  After
``max_attempts`` the error propagates: a hard-down source is an operator
page, not something to spin on.

:class:`FlakyStream` is the matching chaos injector: a deterministic
fault schedule (event offset -> number of failures) so tests and the chaos
harness can place a fault inside any chosen round and replay it exactly.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from repro_torch.stream.sources import EventBatch, InteractionStream


class TransientStreamError(RuntimeError):
    """A retryable stream fault (the kind RetryingStream absorbs)."""


class RetryingStream:
    """Retry ``base.next_batch`` on transient errors with capped exponential
    backoff and *seeded* jitter.

    The jitter is derived from ``default_rng((seed, cursor, attempt))`` —
    the documented stable derivation the repo uses everywhere instead of
    salted hashes — so a replayed run backs off identically (the chaos
    bench's recovery times are reproducible, not noise).

    ``sleep`` is injectable for tests; stats: ``retries`` (absorbed
    failures), ``gave_up`` (attempt-cap exhaustions, re-raised).
    """

    def __init__(self, base: InteractionStream, *, max_attempts: int = 4,
                 base_delay: float = 0.05, max_delay: float = 2.0,
                 seed: int = 0,
                 retry_on: tuple = (TransientStreamError,),
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.base = base
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.seed = int(seed)
        self.retry_on = retry_on
        self._sleep = sleep
        self.retries = 0
        self.gave_up = 0
        self.delays: list[float] = []

    @property
    def cursor(self) -> int:
        return self.base.cursor

    def seek(self, cursor: int) -> None:
        self.base.seek(cursor)

    def _backoff(self, cursor: int, attempt: int) -> float:
        u = float(np.random.default_rng(
            (self.seed, cursor, attempt)).random())
        delay = min(self.base_delay * (2.0 ** attempt), self.max_delay)
        return delay * (0.5 + 0.5 * u)      # jitter in [delay/2, delay]

    def next_batch(self, max_events: int) -> Optional[EventBatch]:
        start = self.base.cursor
        for attempt in range(self.max_attempts):
            try:
                return self.base.next_batch(max_events)
            except self.retry_on:
                if attempt + 1 >= self.max_attempts:
                    self.gave_up += 1
                    raise
                self.retries += 1
                delay = self._backoff(start, attempt)
                self.delays.append(delay)
                self._sleep(delay)
                # a failed source may have advanced partially: rewind to the
                # pre-call cursor so nothing is skipped or double-delivered
                self.base.seek(start)
        return None     # pragma: no cover — loop always returns or raises


class FlakyStream:
    """Deterministic fault injector over a base stream.

    ``failures``: {event offset -> times to fail}.  A ``next_batch`` call
    whose requested range covers a scheduled offset with failures remaining
    raises ``error`` *before* touching the base stream (the base cursor does
    not move, exactly like a source that died before responding).  The
    schedule is plain data, so a chaos run replays bit-exactly.
    """

    def __init__(self, base: InteractionStream, failures: dict, *,
                 error=TransientStreamError):
        self.base = base
        self._remaining = {int(k): int(v) for k, v in dict(failures).items()}
        self.error = error
        self.raised = 0

    @property
    def cursor(self) -> int:
        return self.base.cursor

    def seek(self, cursor: int) -> None:
        self.base.seek(cursor)

    def next_batch(self, max_events: int) -> Optional[EventBatch]:
        c = int(self.base.cursor)
        for off in sorted(self._remaining):
            if self._remaining[off] > 0 and c <= off < c + int(max_events):
                self._remaining[off] -= 1
                self.raised += 1
                raise self.error(
                    f"injected stream fault at event {off} "
                    f"({self._remaining[off]} failure(s) remaining)")
        return self.base.next_batch(max_events)
