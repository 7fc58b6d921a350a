"""The streaming service loop: ingest → train-on-recent → refresh → serve
(the port of ``src/repro/stream/service.py``).

:class:`StreamingTrainer` is the long-lived driver that turns the offline
primitives into an online recommender:

* **ingest** — pull one micro-batch from an :class:`~repro_torch.stream.\
sources.InteractionStream`, fold it into the device-resident ring
  (``DeviceCFDataset.apply_events``: no table re-upload, one padded event
  shape) and draw embedding rows for first-seen users and items from a
  ``(seed, events)``-pure generator;
* **train-on-recent** — one :class:`~repro_torch.train.trainer.EpochExecutor`
  window per round over ``stream_batch_device``'s recency-weighted ring
  sampler through ``mf.heat_train_step`` (on the config's engine: with
  ``MF_100M_PALLAS``, CUDA kernels #1, #2 and #6), the live popularity
  counts feeding the ``popularity`` sampler; the ring rides the window's
  carry (a :class:`StreamCarry`) and every round dispatches one window
  length (budget 1, counted);
* **guard** — the :class:`~repro_torch.resilience.guard.DivergenceGuard`
  checks the round's losses and tables before anything is served or saved;
* **refresh** — ``BatchingRecommender.refresh_from`` serves a snapshot of
  the just-trained tables with no new call shape;
* **checkpoint** — round-edge checkpoints hold the model state, the whole
  ring and the stream cursor, so a mid-stream crash resumes bit for bit:
  rounds are pure in (cursor, step, state, ring, salt).

The port's training step updates the tables in place (the PyTorch form of
the reference's donated carry), and ``apply_events`` updates the ring in
place: a warm-started trainer therefore **mutates the state and ring it was
given**.  A caller that still needs them passes clones.

Freshness SLO: the wall clock from an event's ingest to its item appearing
in that user's served top-k (``launch/stream.py`` prints it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import mf
from repro_torch.core.engine import StepEngine, resolve_engine
from repro_torch.data import pipeline
from repro_torch.resilience.guard import (DivergenceError, DivergenceGuard,
                                          GuardConfig)
from repro_torch.stream.sources import InteractionStream
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import spans, trainer


class StreamCarry(NamedTuple):
    """The executor carry of a streaming round: model state + ring view."""

    state: mf.MFState
    data: pipeline.DeviceCFDataset


@dataclasses.dataclass
class StreamingConfig:
    """Service-loop knobs (model knobs stay in ``mf.MFConfig``); the
    reference's fields and defaults."""

    capacity: int = 32          # per-user ring rows (cold-start construction)
    micro_batch: int = 256      # events ingested per round (padded, 1 shape)
    steps_per_round: int = 32   # executor window length per round
    batch_size: int = 256
    recency: float = 0.5        # ring age decay; 0 = uniform over the ring
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1         # rounds between checkpoints (0 = off)
    ckpt_keep: int = 3
    max_restarts: int = 2
    fail_at_event: Optional[int] = None     # crash injection (tests/demos)
    # Divergence guard: round-edge finite/spike checks; None disables.  On a
    # trip the trainer rolls back to the last good checkpoint and salts the
    # window start past the poison range.
    guard: Optional[GuardConfig] = dataclasses.field(
        default_factory=GuardConfig)
    max_rollbacks: int = 2
    poison_at_round: Optional[int] = None   # NaN injection (tests/chaos)


#: window-start stride per rollback salt: far larger than any real run's
#: step count, so salted step ranges never overlap the unsalted ones.  The
#: port's step keys are Python ints folded into 64 bits
#: (``mf.fold_in``), so nothing truncates a salted start.
SALT_STRIDE = 1 << 20

#: salt of the fresh-row draws, apart from every (seed, step) key.
FRESH_ROWS_SALT = 0xF4E5


def _init_rows_(table: torch.Tensor, mask: torch.Tensor, key: int,
                std: float) -> None:
    """Overwrite the rows of ``table`` flagged by ``mask`` with
    ``N(0, std^2)`` draws from ``generator(key)``, in place: row ``j`` of
    the draw goes to the ``j``-th flagged row in id order, so the result is
    pure in (key, mask).  Only the flagged rows are drawn (the reference
    draws a whole table and keeps the flagged rows); the flagged count is
    read back once."""
    rows = torch.nonzero(mask).reshape(-1)
    if rows.numel() == 0:
        return
    fresh = torch.randn((rows.numel(), table.shape[1]), dtype=table.dtype,
                        device=table.device,
                        generator=mf.generator(key, table.device)).mul_(std)
    table.index_copy_(0, rows, fresh)


class StreamingTrainer:
    """Long-lived ingest → train → refresh driver over one stream.

    Runs on ``device``: the card unless the caller names another (see
    ``mf.resolve_device``); a given ``state`` and ``data`` must live there.

    Cold start (the default): empty rings, embeddings initialized from the
    seed but trained only once events exist — :meth:`run_round` never trains
    before the first ingested event.  Warm start: pass ``state`` (a trained
    ``MFState``) and ``data`` (a ``stream_ring_dataset(..., base=...)`` or
    cold ring view).  Both are updated **in place** by training and ingest,
    so the caller's objects change; after a crash a warm start resumes from
    a checkpoint (it cannot replay from the originals), a cold start can
    also replay from scratch, being pure in the seed.

    ``recommender``: an optional live ``BatchingRecommender``; every round
    ends with its ``refresh_from``, so the served top-k tracks training with
    no new call shape."""

    def __init__(self, cfg: mf.MFConfig, stream: InteractionStream,
                 scfg: Optional[StreamingConfig] = None, *,
                 state: Optional[mf.MFState] = None,
                 data: Optional[pipeline.DeviceCFDataset] = None,
                 engine: Optional[StepEngine] = None,
                 recommender=None, device=None,
                 log: Callable[[str], None] = print):
        if getattr(cfg, "table_format", "fp32") != "fp32":
            raise NotImplementedError(
                "streaming training supports table_format='fp32' only; the "
                "fresh-row init path (_init_rows_) and poison injection "
                "write rows in place, which int8 tables "
                "(optim/quantization.py) do not support yet — ROADMAP item")
        self.cfg = cfg
        self.stream = stream
        self.scfg = scfg or StreamingConfig()
        self.engine = engine or resolve_engine(cfg)
        self.recommender = recommender
        self.log = log
        self.device = mf.resolve_device(device)
        self._cold_start = state is None and data is None
        if data is None:
            data = pipeline.stream_ring_dataset(
                cfg.num_users, cfg.num_items, self.scfg.capacity,
                device=self.device)
        if data.row_count is None or data.write_pos is None:
            raise ValueError("StreamingTrainer needs a ring view — build "
                             "data with pipeline.stream_ring_dataset(...)")
        if state is None:
            state = mf.init_mf(self.scfg.seed, cfg, device=self.device)
        for name, t in (("state", state.params.user_table),
                        ("data", data.train_pos)):
            if t.device.type != self.device.type:
                raise ValueError(f"the {name} lives on {t.device}, the "
                                 f"trainer runs on {self.device}")
        self.state = state
        self.data = data
        self.step = int(state.step)
        self.rounds = 0
        self.events = int(stream.cursor)
        self.restarts = 0
        self.rollbacks = 0
        # rollback salt: shifts every window's start step by salt*SALT_STRIDE
        # so the (seed, step)-pure draws take a disjoint range — the
        # deterministic "skip past the poison window".  Checkpointed and
        # restored, so resumed trajectories stay bit for bit.
        self.salt = 0
        self.guard = (DivergenceGuard(self.scfg.guard)
                      if self.scfg.guard is not None else None)
        self._has_data = bool((data.row_count > 0).any())
        self._losses: dict[int, list] = {}
        self.last_round_stats: dict = {}
        self._draw: Optional[pipeline.RingDraw] = None
        if cfg.init == "xavier":
            self._std_u = float(np.sqrt(2.0 / (cfg.num_users + cfg.emb_dim)))
            self._std_i = float(np.sqrt(2.0 / (cfg.num_items + cfg.emb_dim)))
        else:
            self._std_u = self._std_i = float(cfg.init_std)

        def body(carry: StreamCarry, step: int):
            batch = pipeline.stream_batch_device(
                carry.data, self.scfg.seed, step, self.scfg.batch_size,
                recency=self.scfg.recency, history_len=cfg.history_len,
                draw=self._draw)
            new_state, loss = mf.heat_train_step(
                carry.state, batch, mf.fold_in(self.scfg.seed, step), cfg,
                engine=self.engine, item_weights=carry.data.item_weights)
            return StreamCarry(new_state, carry.data), loss

        # steady state dispatches full rounds only: ONE window length
        self.executor = trainer.EpochExecutor(
            body, self.scfg.steps_per_round, trace_budget=1)

    # -- ingest -------------------------------------------------------------

    def ingest_events(self, user_ids, item_ids) -> int:
        """Fold host event arrays into the device ring; returns the count.

        Events are padded to ``micro_batch``-sized chunks, so every call has
        the same event shape.  New users and items get embedding rows drawn
        from ``fold_in(fold_in(fold_in(seed, FRESH_ROWS_SALT), events + s),
        table)`` (``s`` the chunk's offset, table 0 = users, 1 = items), so
        a resumed run draws the same rows.

        ``run_round`` feeds stream batches through here; out-of-band callers
        (probe bursts) may too, but only stream-sourced events are covered
        by the crash/resume contract (the cursor does not know of them)."""
        users = np.asarray(user_ids, np.int64).reshape(-1)
        items = np.asarray(item_ids, np.int64).reshape(-1)
        if users.size != items.size:
            raise ValueError("user/item event arrays differ in length")
        chunk = self.scfg.micro_batch
        key0 = mf.fold_in(self.scfg.seed, FRESH_ROWS_SALT)
        for s in range(0, users.size, chunk):
            n = min(chunk, users.size - s)
            pu = np.full(chunk, -1, np.int64)
            pi = np.full(chunk, -1, np.int64)
            pu[:n] = users[s:s + n]
            pi[:n] = items[s:s + n]
            self.data, new_u, new_i = self.data.apply_events(pu, pi)
            key = mf.fold_in(key0, self.events + s)
            params = self.state.params
            _init_rows_(params.user_table, new_u, mf.fold_in(key, 0),
                        self._std_u)
            _init_rows_(params.item_table, new_i, mf.fold_in(key, 1),
                        self._std_i)
        self.events += int(users.size)
        if users.size:
            self._has_data = True
        return int(users.size)

    # -- train --------------------------------------------------------------

    def train_round(self) -> np.ndarray:
        """One executor window over the current ring; returns the round's
        host loss array (the only sync is the window-edge readback)."""
        if not self._has_data:
            raise ValueError("the ring holds no events yet — ingest before "
                             "training (run_round() orders this correctly)")
        carry = StreamCarry(self.state, self.data)
        # the ring is fixed for the window: its draw constants once a round
        self._draw = pipeline.ring_draw(self.data, self.scfg.recency)
        # the salt offsets the window's start, so a rollback changes the
        # sampled step range without a new window length
        base = self.step + self.salt * SALT_STRIDE
        carry, window, length = trainer.run_window(
            self.executor, carry, base, base + self.scfg.steps_per_round)
        self.state, self.data = carry.state, carry.data
        self.step += length
        window = np.asarray(window, np.float32)
        self._losses[self.rounds] = window.tolist()
        return window

    # -- the round ----------------------------------------------------------

    def run_round(self) -> bool:
        """ingest → train → guard → refresh → (checkpoint); False when the
        stream is exhausted.  Crash injection (``fail_at_event``) fires
        *before* the micro-batch holding that offset is applied, so the
        failure always lands between rounds — where checkpoints are.

        The round is a ``round`` span holding ``ingest``, ``train`` (the
        window and any poison injection), ``guard`` and ``refresh`` spans
        (``train/spans.py``); ``last_round_stats`` reads their stamps
        (``train_s`` runs from the window's start to the guard's end)."""
        scfg = self.scfg
        with spans.span("round"):
            with spans.Timed("ingest") as ingest:
                batch = self.stream.next_batch(scfg.micro_batch)
                if batch is None or len(batch) == 0:
                    return False
                if (scfg.fail_at_event is not None and self.restarts == 0
                        and batch.start <= scfg.fail_at_event
                        < batch.start + len(batch)):
                    raise trainer.SimulatedFailure(
                        f"injected failure at event {scfg.fail_at_event} "
                        f"(round {self.rounds})")
                self.ingest_events(batch.user_ids, batch.item_ids)
            with spans.Timed("train") as train:
                window = self.train_round()
                if (scfg.poison_at_round is not None and self.rollbacks == 0
                        and self.rounds + 1 == scfg.poison_at_round):
                    # chaos/test injection: corrupt one trained row, as a
                    # numerical blowup inside the window would (fires once,
                    # like fail_at_event)
                    self.state.params.item_table[0, 0] = float("nan")
            with spans.Timed("guard") as guard:
                if self.guard is not None:
                    reason = self.guard.check(self.state.params, window)
                    if reason is not None:
                        # raise BEFORE refresh and BEFORE the checkpoint
                        # below: poisoned state must never reach serving or
                        # disk
                        raise DivergenceError(
                            f"divergence guard tripped after round "
                            f"{self.rounds + 1} (step {self.step}): {reason}")
            with spans.Timed("refresh") as refresh:
                if self.recommender is not None:
                    self.recommender.refresh_from(self.state)
            self.rounds += 1
            if scfg.ckpt_dir and scfg.ckpt_every \
                    and self.rounds % scfg.ckpt_every == 0:
                self._save()
        self.last_round_stats = {
            "round": self.rounds, "events": len(batch),
            "ingest_s": ingest.seconds,
            "train_s": (guard.end_ns - train.start_ns) * 1e-9,
            "refresh_s": refresh.seconds,
            "loss": float(window.mean()),
        }
        return True

    def run(self, rounds: Optional[int] = None) -> int:
        """Run until ``rounds`` more rounds have *completed* (or the stream
        runs dry).  Injected failures restore the latest round-edge
        checkpoint — or replay a cold start from scratch — and re-run the
        lost rounds, as a process restart would; a guard trip rolls back
        the same way and salts past the poison window.  Returns the net
        number of new rounds."""
        start = self.rounds
        target = None if rounds is None else start + rounds
        while target is None or self.rounds < target:
            try:
                if not self.run_round():
                    break
            except trainer.SimulatedFailure as e:
                self.restarts += 1
                if self.restarts > self.scfg.max_restarts:
                    raise
                self.log(f"[stream] {e} -> restoring")
                self._restore_or_reset()
            except DivergenceError as e:
                self.rollbacks += 1
                if self.rollbacks > self.scfg.max_rollbacks:
                    raise
                self.log(f"[stream] {e} -> rolling back and salting past "
                         "the poison window")
                self._restore_or_reset()
                self.salt += 1      # skip the poisoned (seed, step) range
                if self.guard is not None:
                    self.guard.reset()
        return self.rounds - start

    # -- checkpoint / resume -------------------------------------------------

    def _save(self) -> None:
        ckpt.save(self.scfg.ckpt_dir, self.rounds,
                  {"state": self.state, "data": self.data},
                  extra={"cursor": int(self.stream.cursor),
                         "step": int(self.step),
                         "events": int(self.events),
                         "salt": int(self.salt)},
                  keep=self.scfg.ckpt_keep)

    def restore(self, step: Optional[int] = None) -> int:
        """Resume from the latest (or given) round-edge checkpoint: model
        state, ring, step/event counters, salt and the stream cursor — the
        complete round input, so the resumed trajectory is bit-identical to
        the uninterrupted one.  The current state and ring serve as the
        template (structure, device and dtypes); every leaf is a new
        tensor."""
        tree, rounds, extra = ckpt.restore(
            self.scfg.ckpt_dir, {"state": self.state, "data": self.data}, step)
        self.state, self.data = tree["state"], tree["data"]
        self.rounds = int(rounds)
        self.step = int(extra["step"])
        self.events = int(extra["events"])
        self.salt = int(extra.get("salt", 0))
        self.stream.seek(int(extra["cursor"]))
        self._has_data = bool((self.data.row_count > 0).any())
        self._losses = {r: v for r, v in self._losses.items()
                        if r < self.rounds}
        if self.recommender is not None:
            self.recommender.refresh_from(self.state)
        return self.rounds

    def _restore_or_reset(self) -> None:
        if self.scfg.ckpt_dir and \
                ckpt.latest_step(self.scfg.ckpt_dir) is not None:
            try:
                self.restore()
                return
            except FileNotFoundError as e:
                # every on-disk checkpoint failed verification (and was
                # quarantined) — fall through to the cold-replay path
                self.log(f"[stream] {e} -> no valid checkpoint")
        if not self._cold_start:
            raise RuntimeError(
                "crashed before the first checkpoint of a warm-started "
                "trainer: the initial state was trained in place and cannot "
                "be replayed — set ckpt_every=1 (or checkpoint before "
                "streaming) when warm-starting with failure injection")
        self.log("[stream] no checkpoint yet -> cold replay from scratch")
        self.state = self.data = None       # free the old tables first
        self.state = mf.init_mf(self.scfg.seed, self.cfg, device=self.device)
        self.data = pipeline.stream_ring_dataset(
            self.cfg.num_users, self.cfg.num_items, self.scfg.capacity,
            device=self.device)
        self.step = 0
        self.rounds = 0
        self.events = 0
        self.salt = 0
        self._has_data = False
        self._losses = {}
        self.stream.seek(0)

    # -- introspection -------------------------------------------------------

    def loss_history(self) -> list:
        """Per-step losses in round order (resume-deduplicated: replayed
        rounds overwrite their pre-crash entries)."""
        return [loss for r in sorted(self._losses)
                for loss in self._losses[r]]
