"""Request-batching recommendation server, the port of
``src/repro/launch/server.py``: concurrent single-user requests coalesced into
one (B, ·) device call.

  * The worker thread blocks for a first request, then drains the queue
    until ``max_batch`` requests are in hand or ``max_wait_ms`` has passed
    since the first; every device call is padded to exactly ``max_batch``
    rows.
  * There is no jit here, so nothing is traced: :attr:`trace_count` (and
    ``stats["traces"]``) counts the distinct padded call shapes the server
    has issued, which must stay 1 in steady state (a second shape raises,
    as the reference's trace budget does).
  * The port's training step updates its tables in place, so a server that
    held the trainer's tensors would serve torn, half-updated tables while
    training goes on.  The constructor and :meth:`BatchingRecommender.
    refresh_from` therefore take a device-side snapshot (``clone()``) of the
    tables they are given; training the source state further changes
    nothing served until the next refresh.

The worker issues its CUDA work on the current stream of the tables' device
and brings each answer to the host with ``.cpu()``, which waits for it.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.analysis.sanitize import edge
from repro_torch.core import mf
from repro_torch.core import retrieval as rtv
from repro_torch.optim import quantization as qz
# RetraceError is what a second call shape raises; importable from here too
from repro_torch.train.shapes import RetraceError, ShapeCounter


class _Request(NamedTuple):
    user_id: int
    event: threading.Event
    result: list           # single-slot box the worker fills


def _snapshot(table: qz.Table) -> qz.Table:
    """A device-side copy of a table, detached from the trainer's."""
    if isinstance(table, qz.QuantizedTable):
        return qz.QuantizedTable(*(t.clone() for t in table))
    return table.detach().clone()


class BatchingRecommender:
    """Batched top-k serving over device-resident MF tables.

    ``pruner="exact"`` serves through the chunked ``mf.topk_all_items``;
    ``pruner="tile"`` through ``retrieval.topk_pruned`` with ``index`` and
    ``expand_tiles``.  ``exclude_mask`` (U, I) bool, on the tables' device,
    masks each user's training positives (rows gathered per call)."""

    def __init__(self, state: mf.MFState, k: int, *,
                 pruner: str = "exact",
                 index: Optional[rtv.RetrievalIndex] = None,
                 expand_tiles: int = 8,
                 max_batch: int = 32, max_wait_ms: float = 2.0,
                 similarity: str = "cosine",
                 item_chunk: Optional[int] = None,
                 exclude_mask: Optional[torch.Tensor] = None,
                 warmup: bool = True,
                 log: Optional[Callable[[str], None]] = None):
        if pruner not in ("exact", "tile"):
            raise ValueError(f"pruner must be 'exact' or 'tile', got {pruner!r}")
        if pruner == "tile" and index is None:
            raise ValueError("pruner='tile' requires a RetrievalIndex "
                             "(retrieval.build_retrieval_index)")
        self.k = int(k)
        self.pruner = pruner
        self.expand_tiles = int(expand_tiles)
        self.max_batch = max(int(max_batch), 1)
        self.max_wait_ms = float(max_wait_ms)
        self.item_chunk = item_chunk
        self._similarity = similarity
        self._exclude_mask = exclude_mask
        self._log = log or (lambda *_: None)
        self._lock = threading.Lock()          # counters and call shapes
        self._shapes = ShapeCounter("batching_recommender.call", budget=1)
        self._device_calls = 0
        self._requests_served = 0
        # a failed refresh keeps the previous snapshot live and is counted
        self._refreshes = 0
        self._refresh_failures = 0
        self._stale_refreshes = 0
        self._last_refresh_error: Optional[str] = None

        params = state.params
        self._table_specs = qz.table_spec((params.user_table, params.item_table))
        self._device = params.user_table.device
        served = mf.MFParams(_snapshot(params.user_table),
                             _snapshot(params.item_table), None)
        if index is not None:
            index = rtv.refresh_index(index, served.item_table,
                                      similarity=similarity)
        # (params, index) swap together, so a call never pairs new tables
        # with an old index.
        self._served = (served, index)

        self._queue: queue.Queue = queue.Queue()
        self._running = True
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        if warmup:
            self.warmup()
        self._worker.start()

    # -- device path -------------------------------------------------------

    def _recommend(self, user_ids: torch.Tensor) -> torch.Tensor:
        params, index = self._served
        excl = (None if self._exclude_mask is None
                else self._exclude_mask[user_ids])
        if self.pruner == "tile":
            return rtv.topk_pruned(params, user_ids, self.k, index,
                                   expand_tiles=self.expand_tiles,
                                   similarity=self._similarity,
                                   exclude_mask=excl)
        return mf.topk_all_items(params, user_ids, self.k,
                                 similarity=self._similarity,
                                 item_chunk=self.item_chunk,
                                 exclude_mask=excl)

    def _call(self, padded: np.ndarray) -> np.ndarray:
        # The batch's upload and its answers' download are the call's two
        # explicit edges (analysis/sanitize.py).
        with edge():
            user_ids = torch.as_tensor(padded, dtype=torch.int64,
                                       device=self._device)
        with self._lock:
            self._device_calls += 1
            self._shapes.add(tuple(user_ids.shape))     # budget 1: raises
        out = self._recommend(user_ids)
        with edge():
            return out.cpu().numpy()

    def warmup(self) -> float:
        """One call on a dummy full batch, so the first request finds the
        kernels' libraries loaded and the allocator warm; returns its wall
        seconds."""
        t0 = time.perf_counter()
        self._call(np.zeros(self.max_batch, np.int64))
        return time.perf_counter() - t0

    @property
    def trace_count(self) -> int:
        """Distinct padded call shapes issued so far (1 in steady state)."""
        return self._shapes.count

    @property
    def trace_counter(self) -> ShapeCounter:
        """The counter of distinct padded call shapes (budget 1), as the
        reference's server exposes its trace counter."""
        return self._shapes

    @property
    def stats(self) -> dict:
        """Device calls, requests served, call shapes (``traces``) and
        :attr:`health`."""
        return {"device_calls": self._device_calls,
                "requests_served": self._requests_served,
                "traces": self.trace_count,
                **self.health}

    @property
    def health(self) -> dict:
        """``status`` is ``degraded`` while the last refresh(es) failed and
        the previous snapshot is served; the next good refresh restores
        ``ok``."""
        return {"status": "degraded" if self._stale_refreshes else "ok",
                "refreshes": self._refreshes,
                "refresh_failures": self._refresh_failures,
                "stale_refreshes": self._stale_refreshes,
                "last_refresh_error": self._last_refresh_error}

    def recommend_many(self, user_ids) -> np.ndarray:
        """Synchronous batched entry point: request rows padded to
        ``max_batch`` (split when there are more), answers sliced back."""
        ids = np.asarray(user_ids, np.int64).reshape(-1)
        outs = []
        for s in range(0, ids.size, self.max_batch):
            chunk = ids[s:s + self.max_batch]
            padded = np.zeros(self.max_batch, np.int64)
            padded[:chunk.size] = chunk
            outs.append(self._call(padded)[:chunk.size])
        with self._lock:
            self._requests_served += ids.size
        return np.concatenate(outs, axis=0)

    # -- queue front-end ---------------------------------------------------

    def recommend(self, user_id: int, timeout: Optional[float] = 10.0
                  ) -> np.ndarray:
        """Single-user entry point: enqueue and wait; concurrent callers are
        coalesced by the worker into one device call."""
        req = _Request(int(user_id), threading.Event(), [None])
        self._queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError(f"recommend({user_id}) timed out")
        res = req.result[0]
        if isinstance(res, BaseException):
            raise res
        return res

    def _serve_loop(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:
                return
            batch = [req]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while len(batch) < self.max_batch:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=wait)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch: list) -> None:
        padded = np.zeros(self.max_batch, np.int64)
        padded[:len(batch)] = [r.user_id for r in batch]
        try:
            out = self._call(padded)
            for i, r in enumerate(batch):
                r.result[0] = out[i]
        except Exception as e:  # noqa: BLE001 — surfaced to the waiters
            for r in batch:
                r.result[0] = e
        with self._lock:
            self._requests_served += len(batch)
        for r in batch:
            r.event.set()

    # -- online refresh ----------------------------------------------------

    def _validate_refresh(self, state: mf.MFState) -> None:
        params = state.params
        got = qz.table_spec((params.user_table, params.item_table))
        if got != self._table_specs:
            raise ValueError(
                f"refresh tables have shape/dtype/layout {got[1]} "
                f"({got[0]}), the server was built for "
                f"{self._table_specs[1]} ({self._table_specs[0]}) — "
                "refusing the swap")

    def refresh_from(self, state: mf.MFState, *,
                     on_error: str = "degrade") -> bool:
        """Serve a snapshot (``clone()`` on the device) of ``state``'s
        tables from the next call on; with a tile pruner the centroids are
        re-derived from the new item table under the same partition.

        A failed refresh (a table of another shape, dtype or layout, or an
        index refresh error) does not take serving down: with
        ``on_error="degrade"`` the previous snapshot stays live and the
        failure is logged and counted in :attr:`health`; ``"raise"``
        propagates it.  Returns True when the swap happened."""
        if on_error not in ("degrade", "raise"):
            raise ValueError(f"on_error must be 'degrade' or 'raise', "
                             f"got {on_error!r}")
        try:
            self._validate_refresh(state)
            params = mf.MFParams(_snapshot(state.params.user_table),
                                 _snapshot(state.params.item_table), None)
            index = self._served[1]
            if index is not None:
                index = rtv.refresh_index(index, params.item_table,
                                          similarity=self._similarity)
        except Exception as e:  # noqa: BLE001 — degraded serving, by design
            if on_error == "raise":
                raise
            self._refresh_failures += 1
            self._stale_refreshes += 1
            self._last_refresh_error = f"{type(e).__name__}: {e}"
            self._log(f"[serve] refresh failed ({self._last_refresh_error});"
                      " serving the previous snapshot "
                      f"(stale x{self._stale_refreshes})")
            return False
        self._served = (params, index)
        self._refreshes += 1
        self._stale_refreshes = 0
        self._last_refresh_error = None
        return True

    def stop(self) -> None:
        """Stop the worker after the requests already queued."""
        if self._running:
            self._running = False
            self._queue.put(None)
            self._worker.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
