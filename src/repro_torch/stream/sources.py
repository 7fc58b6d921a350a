"""Interaction streams: where live (user, item) events come from — the
port's copy of ``src/repro/stream/sources.py`` (numpy only, so events, logs
and cursors are the reference's bit for bit: a log recorded by either
package replays in the other).

Every source implements the :class:`InteractionStream` protocol — bounded
micro-batches of timestamped events behind a **seekable cursor** — so the
service loop can (a) replay any run bit-exactly and (b) resume mid-stream
from a checkpointed cursor (the streaming extension of the repo's
(seed, step) restart contract: an event is a pure function of
(stream seed, event index)).

Sources:

* :class:`SyntheticStream` — seeded generator with *drifting* user/item
  popularity: the identity of the popular head rotates with the event index,
  so a model trained on stale data measurably decays — the signal the
  freshness SLO bench needs.
* :class:`ReplayLogStream` — reads a JSONL event log; :func:`record_stream`
  writes one (synthetic → log → replay round-trips bit-exactly, tested).
* :class:`ProbeInjector` — splices a burst of known (user, item) probe
  events into a base stream at a chosen offset; the freshness bench measures
  wall-clock from that splice to the item surfacing in the user's top-k.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional, Protocol, runtime_checkable

import numpy as np


class EventBatch(NamedTuple):
    """One micro-batch of interaction events, in arrival order."""

    user_ids: np.ndarray        # (n,) int32
    item_ids: np.ndarray        # (n,) int32
    times: np.ndarray           # (n,) float64 event timestamps (seconds)
    start: int                  # global index of the first event

    def __len__(self) -> int:
        return int(self.user_ids.size)


@runtime_checkable
class InteractionStream(Protocol):
    """Seekable source of timestamped (user, item) events."""

    @property
    def cursor(self) -> int:
        """Global index of the next event :meth:`next_batch` will deliver."""
        ...

    def seek(self, cursor: int) -> None:
        """Reposition so the next delivered event is ``cursor`` (resume)."""
        ...

    def next_batch(self, max_events: int) -> Optional[EventBatch]:
        """Up to ``max_events`` events from the cursor, advancing it;
        ``None`` when the stream is exhausted."""
        ...


def _power_law(u01: np.ndarray, n: int) -> np.ndarray:
    """Map uniforms to a popularity-ranked index: rank ~ floor(n * u^3)
    (the same head-heavy transform ``procedural_cf_batch`` uses)."""
    return np.minimum((n * u01 ** 3).astype(np.int64), n - 1)


class SyntheticStream:
    """Seeded synthetic interaction stream with drifting popularity.

    Event ``i`` is a pure function of ``(seed, i)``: uniforms come from
    ``np.random.default_rng((seed, i // block))`` — a documented stable
    SeedSequence derivation, never ``hash`` — sliced at ``i % block``, so
    seeking is O(1) and a resumed stream replays bit-exactly.

    Structure (so the CF objective has signal *and* staleness hurts):

    * user draw: power-law rank rotated by ``user_drift * i`` — *which*
      users are hot changes over time;
    * item draw: power-law rank **within the user's cluster pool**
      (``cluster = user % num_clusters``, contiguous item blocks), rotated
      by ``item_drift * i`` — fresh items displace stale ones inside each
      user's preference cluster.

    ``total=None`` streams forever; otherwise :meth:`next_batch` returns
    ``None`` once ``total`` events have been delivered.
    """

    def __init__(self, num_users: int, num_items: int, *, seed: int = 0,
                 num_clusters: int = 16, events_per_sec: float = 1000.0,
                 user_drift: float = 0.0, item_drift: float = 0.0,
                 total: Optional[int] = None, block: int = 2048):
        if num_users < 1 or num_items < 1:
            raise ValueError("need at least one user and one item")
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.seed = int(seed)
        self.num_clusters = max(1, min(int(num_clusters), num_items))
        self.events_per_sec = float(events_per_sec)
        self.user_drift = float(user_drift)
        self.item_drift = float(item_drift)
        self.total = None if total is None else int(total)
        self.block = int(block)
        self._cursor = 0
        self._block_cache: dict[int, np.ndarray] = {}

    @property
    def cursor(self) -> int:
        return self._cursor

    def seek(self, cursor: int) -> None:
        if cursor < 0 or (self.total is not None and cursor > self.total):
            raise ValueError(f"cursor {cursor} out of range")
        self._cursor = int(cursor)

    def _uniforms(self, idx: np.ndarray) -> np.ndarray:
        """(2, n) uniforms for global event indices ``idx`` — per-block rng,
        cached (a handful of blocks stay warm in steady state)."""
        out = np.empty((2, idx.size))
        for bi in np.unique(idx // self.block):
            u = self._block_cache.get(int(bi))
            if u is None:
                u = np.random.default_rng((self.seed, int(bi))).random(
                    (2, self.block))
                if len(self._block_cache) > 8:
                    self._block_cache.clear()
                self._block_cache[int(bi)] = u
            sel = (idx // self.block) == bi
            out[:, sel] = u[:, idx[sel] % self.block]
        return out

    def _events(self, start: int, n: int) -> EventBatch:
        idx = np.arange(start, start + n, dtype=np.int64)
        xu, xi = self._uniforms(idx)
        u_phase = (self.user_drift * idx).astype(np.int64)
        users = (_power_law(xu, self.num_users) + u_phase) % self.num_users
        pool = max(self.num_items // self.num_clusters, 1)
        i_phase = (self.item_drift * idx).astype(np.int64)
        within = (_power_law(xi, pool) + i_phase) % pool
        items = (users % self.num_clusters) * pool + within
        items = np.minimum(items, self.num_items - 1)
        return EventBatch(users.astype(np.int32), items.astype(np.int32),
                          idx / self.events_per_sec, start)

    def next_batch(self, max_events: int) -> Optional[EventBatch]:
        n = int(max_events)
        if self.total is not None:
            n = min(n, self.total - self._cursor)
        if n <= 0:
            return None
        batch = self._events(self._cursor, n)
        self._cursor += n
        return batch


class DeadLetter(NamedTuple):
    """One malformed log line skipped by a tolerant :class:`ReplayLogStream`."""

    lineno: int     # 1-based line number in the source file
    line: str       # the offending line, verbatim (stripped)
    error: str      # why it failed to parse


class ReplayLogStream:
    """Replays a JSONL event log (one ``{"u", "v", "t"}`` object per line).

    The whole log is loaded into arrays at construction (these logs are
    bounded test/replay artifacts, not production firehoses), so seeking is
    an index assignment and batches are slices.

    ``strict=True`` (the default) hard-fails on the first malformed line —
    a *recorded* log is supposed to be perfect, and silently dropping events
    would break bit-exact replay.  ``strict=False`` is for salvaging a
    damaged log: malformed lines are skipped into :attr:`dead_letters`
    (line numbers preserved) and counted, so the operator sees exactly what
    was lost instead of the whole service going down on one torn line.
    """

    def __init__(self, path: str, *, strict: bool = True):
        self.path = path
        self.strict = bool(strict)
        self.dead_letters: list[DeadLetter] = []
        users, items, times = [], [], []
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                    # parse every field BEFORE appending any — a half-parsed
                    # line must not leave the columns unbalanced
                    u, v, t = int(ev["u"]), int(ev["v"]), float(ev.get("t", 0.0))
                    users.append(u)
                    items.append(v)
                    times.append(t)
                except (ValueError, KeyError, TypeError) as e:
                    if self.strict:
                        raise ValueError(
                            f"{path}:{lineno + 1}: bad event line "
                            f"{line!r}: {e}") from e
                    self.dead_letters.append(
                        DeadLetter(lineno + 1, line, str(e)))
        self._users = np.asarray(users, np.int32)
        self._items = np.asarray(items, np.int32)
        self._times = np.asarray(times, np.float64)
        self._cursor = 0

    @property
    def dead_letter_count(self) -> int:
        return len(self.dead_letters)

    @property
    def total(self) -> int:
        return int(self._users.size)

    @property
    def cursor(self) -> int:
        return self._cursor

    def seek(self, cursor: int) -> None:
        if cursor < 0 or cursor > self.total:
            raise ValueError(f"cursor {cursor} out of range [0, {self.total}]")
        self._cursor = int(cursor)

    def next_batch(self, max_events: int) -> Optional[EventBatch]:
        c = self._cursor
        n = min(int(max_events), self.total - c)
        if n <= 0:
            return None
        self._cursor = c + n
        return EventBatch(self._users[c:c + n], self._items[c:c + n],
                          self._times[c:c + n], c)


def record_stream(stream: InteractionStream, num_events: int, path: str, *,
                  micro_batch: int = 1024) -> int:
    """Drain ``num_events`` events from ``stream`` into a JSONL log that
    :class:`ReplayLogStream` replays bit-exactly.  Written atomically
    (``.tmp`` + rename) so a crashed recording never leaves a torn log.
    Returns the number of events written (< ``num_events`` iff the stream
    ran dry)."""
    tmp = path + ".tmp"
    written = 0
    with open(tmp, "w", encoding="utf-8") as f:
        while written < num_events:
            batch = stream.next_batch(min(micro_batch, num_events - written))
            if batch is None:
                break
            for u, v, t in zip(batch.user_ids.tolist(),
                               batch.item_ids.tolist(),
                               batch.times.tolist()):
                f.write(json.dumps({"u": u, "v": v, "t": t}) + "\n")
            written += len(batch)
    os.replace(tmp, path)
    return written


class ProbeInjector:
    """Splice ``repeat`` copies of a probe (user, item) event into ``base``
    at global offset ``at_event``.

    The combined sequence is still pure and seekable — events before the
    splice keep their indices, the burst occupies ``[at_event, at_event +
    repeat)``, and later base events shift up by ``repeat`` — so freshness
    runs (and their crash/resume tests) stay bit-reproducible.  The base
    stream's cursor is managed by this wrapper; don't read from both.
    """

    def __init__(self, base: InteractionStream, at_event: int,
                 user: int, item: int, *, repeat: int = 1):
        if at_event < 0 or repeat < 1:
            raise ValueError("need at_event >= 0 and repeat >= 1")
        self.base = base
        self.at_event = int(at_event)
        self.user = int(user)
        self.item = int(item)
        self.repeat = int(repeat)
        self._cursor = 0
        self._probe_time: Optional[float] = None

    @property
    def cursor(self) -> int:
        return self._cursor

    def seek(self, cursor: int) -> None:
        if cursor < 0:
            raise ValueError(f"cursor {cursor} out of range")
        self._cursor = int(cursor)

    def _probe_batch(self, start: int, n: int) -> EventBatch:
        if self._probe_time is None:
            # stamp the burst with the base stream's time at the splice point
            self.base.seek(self.at_event)
            peek = self.base.next_batch(1)
            self._probe_time = float(peek.times[0]) if peek is not None \
                and len(peek) else 0.0
        return EventBatch(np.full(n, self.user, np.int32),
                          np.full(n, self.item, np.int32),
                          np.full(n, self._probe_time, np.float64), start)

    def next_batch(self, max_events: int) -> Optional[EventBatch]:
        users, items, times = [], [], []
        start, c, remaining = self._cursor, self._cursor, int(max_events)
        while remaining > 0:
            if c < self.at_event:                       # before the splice
                take = min(remaining, self.at_event - c)
                self.base.seek(c)
                b = self.base.next_batch(take)
                if b is None or len(b) == 0:
                    self.at_event = c   # base ran dry early: splice here
                    continue
            elif c < self.at_event + self.repeat:       # inside the burst
                take = min(remaining, self.at_event + self.repeat - c)
                b = self._probe_batch(c, take)
            else:                                       # after: shifted base
                self.base.seek(c - self.repeat)
                b = self.base.next_batch(remaining)
                if b is None or len(b) == 0:
                    break
            users.append(b.user_ids)
            items.append(b.item_ids)
            times.append(b.times)
            c += len(b)
            remaining -= len(b)
        if c == start:
            return None
        self._cursor = c
        return EventBatch(np.concatenate(users), np.concatenate(items),
                          np.concatenate(times), start)
