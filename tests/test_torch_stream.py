"""The port's streaming subsystem (``repro_torch.stream`` and the ring half
of ``repro_torch.data.pipeline``) against the JAX package, on the CPU.

Cross-package parity, exact where the reference is integer or numpy:
* the sources' events, bit for bit, and a log recorded by either package
  replayed by the other;
* ``apply_events`` (under hypothesis: padding, duplicate users, more events
  of one user than the capacity, first-seen masks) and the warm start of
  ``stream_ring_dataset``: every ring tensor and mask equal;
* ``stream_batch_from`` fed the reference's users and uniforms (recomputed
  here from the reference's keys): ids and masks equal;
* one streaming round from one state, the reference's batches and
  negatives replayed into the port (the replay-sampler pattern of
  ``tests/test_torch_mf.py``) and its fresh rows copied in: the ring equal,
  losses and tables within 1e-5, on the fused and pallas backends with the
  uniform and popularity samplers;
* checkpoint leaf names of a stream checkpoint equal to the reference's.

Within the port (its own draws): the ring semantics of the reference's
tests, shape budgets, the freshness probe, and crash/resume bit for bit at
arbitrary offsets.
"""
import dataclasses
import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import engine as jeng
from repro.core import mf as jmf
from repro.data import pipeline as jpipe
from repro.stream import service as jservice
from repro.stream import sources as jsources
from repro.train import checkpoint as jckpt
from repro_torch import convert
from repro_torch.core import engine as teng
from repro_torch.core import mf
from repro_torch.data import pipeline
from repro_torch.launch.server import BatchingRecommender
from repro_torch.optim import quantization as tqz
from repro_torch.stream import service as stream_service
from repro_torch.stream.service import StreamingConfig, StreamingTrainer
from repro_torch.stream.sources import (EventBatch, InteractionStream,
                                        ProbeInjector, ReplayLogStream,
                                        SyntheticStream, record_stream)
from repro_torch.stream import sources as tsources
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.shapes import RetraceError

USERS, ITEMS, DIM, CAP = 64, 96, 8, 4
ATOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# sources: the reference's tests, then parity with the reference
# ---------------------------------------------------------------------------

def test_synthetic_stream_is_pure_and_seekable():
    a = SyntheticStream(USERS, ITEMS, seed=3, total=300)
    b = SyntheticStream(USERS, ITEMS, seed=3, total=300)
    ba = a.next_batch(300)
    chunks = []
    while (c := b.next_batch(70)) is not None:
        chunks.append(c)
    assert np.array_equal(ba.user_ids,
                          np.concatenate([c.user_ids for c in chunks]))
    assert np.array_equal(ba.item_ids,
                          np.concatenate([c.item_ids for c in chunks]))
    a.seek(123)
    again = a.next_batch(50)
    assert again.start == 123
    assert np.array_equal(again.user_ids, ba.user_ids[123:173])
    assert np.array_equal(again.times, ba.times[123:173])
    assert isinstance(a, InteractionStream)


def test_synthetic_stream_ranges_and_exhaustion():
    s = SyntheticStream(USERS, ITEMS, seed=0, total=100)
    b = s.next_batch(1000)
    assert len(b) == 100 and s.next_batch(1) is None
    assert b.user_ids.min() >= 0 and b.user_ids.max() < USERS
    assert b.item_ids.min() >= 0 and b.item_ids.max() < ITEMS
    with pytest.raises(ValueError):
        s.seek(101)


def test_synthetic_drift_rotates_the_popular_head():
    frozen = SyntheticStream(200, 100, seed=0, total=4000)
    drifty = SyntheticStream(200, 100, seed=0, total=4000, user_drift=0.05)

    def head(b):
        return int(np.bincount(b.user_ids, minlength=200).argmax())

    fa, fb = frozen.next_batch(2000), frozen.next_batch(2000)
    da, db = drifty.next_batch(2000), drifty.next_batch(2000)
    assert head(fa) == head(fb)
    assert head(da) != head(db)


def test_record_replay_round_trip_is_bit_exact(tmp_path):
    src = SyntheticStream(USERS, ITEMS, seed=7, total=150,
                          user_drift=0.02, item_drift=0.02)
    path = str(tmp_path / "events.jsonl")
    assert record_stream(src, 150, path) == 150
    src.seek(0)
    ref = src.next_batch(150)
    replay = ReplayLogStream(path)
    assert replay.total == 150
    got = replay.next_batch(150)
    assert np.array_equal(got.user_ids, ref.user_ids)
    assert np.array_equal(got.item_ids, ref.item_ids)
    assert np.array_equal(got.times, ref.times)


def test_replay_log_rejects_bad_lines(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"u": 1, "v": 2, "t": 0.5}\n{"u": 3}\n')
    with pytest.raises(ValueError, match=r"bad\.jsonl:2"):
        ReplayLogStream(str(path))


def test_replay_log_tolerant_mode_dead_letters_bad_lines(tmp_path):
    path = tmp_path / "damaged.jsonl"
    path.write_text('{"u": 1, "v": 2, "t": 0.5}\n'
                    '{"u": 3}\n'
                    'not json at all\n'
                    '{"u": 4, "v": 5, "t": 1.5}\n')
    replay = ReplayLogStream(str(path), strict=False)
    assert replay.total == 2 and replay.dead_letter_count == 2
    got = replay.next_batch(10)
    assert np.array_equal(got.user_ids, [1, 4])
    assert np.array_equal(got.item_ids, [2, 5])
    assert [d.lineno for d in replay.dead_letters] == [2, 3]
    assert replay.dead_letters[1].line == "not json at all"
    assert all(d.error for d in replay.dead_letters)


def test_probe_injector_splices_and_shifts():
    base = SyntheticStream(USERS, ITEMS, seed=0, total=100)
    probed = ProbeInjector(base, 40, user=5, item=9, repeat=3)
    all_ev = probed.next_batch(1000)
    assert len(all_ev) == 103
    base.seek(0)
    ref = base.next_batch(100)
    assert np.array_equal(all_ev.user_ids[:40], ref.user_ids[:40])
    assert np.all(all_ev.user_ids[40:43] == 5)
    assert np.all(all_ev.item_ids[40:43] == 9)
    assert np.array_equal(all_ev.user_ids[43:], ref.user_ids[40:])
    assert np.all(all_ev.times[40:43] == ref.times[40])
    probed.seek(38)
    again = probed.next_batch(8)
    assert np.array_equal(again.user_ids, all_ev.user_ids[38:46])


def test_probe_injector_clamps_when_base_runs_dry():
    base = SyntheticStream(USERS, ITEMS, seed=0, total=5)
    probed = ProbeInjector(base, at_event=100, user=1, item=2, repeat=3)
    ev = probed.next_batch(1000)
    assert len(ev) == 8
    assert np.all(ev.user_ids[5:] == 1)


def test_event_batch_len_and_protocol(tmp_path):
    b = EventBatch(np.zeros(3, np.int32), np.zeros(3, np.int32),
                   np.zeros(3), 0)
    assert len(b) == 3
    log = tmp_path / "p.jsonl"
    log.write_text('{"u": 0, "v": 1, "t": 0.0}\n')
    base = SyntheticStream(4, 4, total=4)
    for src in (base, ReplayLogStream(str(log)),
                ProbeInjector(base, 1, 0, 0)):
        assert isinstance(src, InteractionStream)


def _drain(stream, chunk):
    out = []
    while (b := stream.next_batch(chunk)) is not None:
        out.append(b)
    return (np.concatenate([b.user_ids for b in out]),
            np.concatenate([b.item_ids for b in out]),
            np.concatenate([b.times for b in out]),
            [b.start for b in out])


@pytest.mark.parametrize("kw", [
    dict(seed=0),
    dict(seed=5, user_drift=0.02, item_drift=0.03, num_clusters=7),
    dict(seed=2, events_per_sec=37.5, block=64, num_clusters=200),
])
def test_sources_emit_the_references_events(kw):
    """SyntheticStream (several settings, seeks across blocks) and
    ProbeInjector give the reference's events bit for bit."""
    mk = [lambda m: m.SyntheticStream(USERS, ITEMS, total=700, **kw)]
    mk.append(lambda m: m.ProbeInjector(mk[0](m), 250, user=3, item=ITEMS - 1,
                                        repeat=5))
    for make in mk:
        a, b = make(jsources), make(tsources)
        for x, y in zip(_drain(a, 97), _drain(b, 97)):
            assert np.array_equal(x, y)
        for s in (a, b):
            s.seek(301)
        ja, ta = a.next_batch(130), b.next_batch(130)
        for f in ("user_ids", "item_ids", "times"):
            assert getattr(ja, f).dtype == getattr(ta, f).dtype
            assert np.array_equal(getattr(ja, f), getattr(ta, f))
        assert ja.start == ta.start


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_log_recorded_by_one_package_replays_in_the_other(writer,
                                                            tmp_path):
    rec, rep = ((jsources, tsources) if writer == "reference"
                else (tsources, jsources))
    path = str(tmp_path / "events.jsonl")
    src = rec.SyntheticStream(USERS, ITEMS, seed=9, total=333,
                              user_drift=0.01, item_drift=0.02)
    assert rec.record_stream(src, 333, path, micro_batch=50) == 333
    src.seek(0)
    want = src.next_batch(333)
    got = rep.ReplayLogStream(path).next_batch(1000)
    for f in ("user_ids", "item_ids", "times"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


# ---------------------------------------------------------------------------
# pipeline: the ring
# ---------------------------------------------------------------------------

def _ring(users=USERS, items=ITEMS, cap=CAP, base=None):
    return pipeline.stream_ring_dataset(users, items, cap, base=base,
                                        device="cpu")


def _ring_reference(users, items, num_users, num_items, capacity,
                    train=None, counts=None, rc=None, wp=None):
    """Pure-numpy mirror of the reference's sequential ring fold."""
    train = np.full((num_users, capacity), -1, np.int64) \
        if train is None else train.copy()
    counts = np.zeros(num_items, np.float32) if counts is None \
        else counts.copy()
    rc = np.zeros(num_users, np.int64) if rc is None else rc.copy()
    wp = np.zeros(num_users, np.int64) if wp is None else wp.copy()
    for u, v in zip(users, items):
        if u < 0:
            continue
        counts[v] += 1
        train[u, wp[u]] = v
        wp[u] = (wp[u] + 1) % capacity
        rc[u] = min(rc[u] + 1, capacity)
    return train, counts, rc, wp


def test_apply_events_matches_numpy_reference():
    rng = np.random.default_rng(0)
    ds = _ring()
    train, counts, rc, wp = None, None, None, None
    for _ in range(4):
        users = rng.integers(0, USERS, 40).astype(np.int32)
        items = rng.integers(0, ITEMS, 40).astype(np.int32)
        users[rng.random(40) < 0.2] = -1
        ds, _, _ = ds.apply_events(users, items)
        train, counts, rc, wp = _ring_reference(
            users, items, USERS, ITEMS, CAP, train, counts, rc, wp)
    assert np.array_equal(_np(ds.train_pos), train)
    assert np.array_equal(_np(ds.item_weights), counts)
    assert np.array_equal(_np(ds.row_count), rc)
    assert np.array_equal(_np(ds.write_pos), wp)


def test_apply_events_evicts_oldest_and_keeps_arrival_order():
    ds = _ring(3, 32, cap=3)
    ds, _, _ = ds.apply_events(np.zeros(5, np.int32),
                               np.asarray([10, 11, 12, 13, 14], np.int32))
    assert _np(ds.row_count)[0] == 3
    row = _np(ds.train_pos)[0]
    wp = int(_np(ds.write_pos)[0])
    newest = [int(row[(wp - 1 - a) % 3]) for a in range(3)]
    assert newest == [14, 13, 12]


def test_apply_events_reports_first_seen_users_and_items():
    ds = _ring()
    ds, nu, ni = ds.apply_events(np.asarray([1, 2, 1], np.int32),
                                 np.asarray([5, 6, 5], np.int32))
    assert set(np.flatnonzero(_np(nu))) == {1, 2}
    assert set(np.flatnonzero(_np(ni))) == {5, 6}
    ds, nu, ni = ds.apply_events(np.asarray([1, 3], np.int32),
                                 np.asarray([5, 7], np.int32))
    assert set(np.flatnonzero(_np(nu))) == {3}
    assert set(np.flatnonzero(_np(ni))) == {7}


def test_apply_events_keeps_one_shape_per_batch_length():
    ds = _ring()
    rng = np.random.default_rng(1)
    pipeline.APPLY_EVENTS_SHAPES.reset()
    for _ in range(5):
        ds, _, _ = ds.apply_events(
            rng.integers(0, USERS, 16).astype(np.int32),
            rng.integers(0, ITEMS, 16).astype(np.int32))
    assert pipeline.APPLY_EVENTS_SHAPES.count == 1
    ds.apply_events(np.zeros(3, np.int32), np.zeros(3, np.int32))
    assert pipeline.APPLY_EVENTS_SHAPES.count == 2


def test_apply_events_refuses_offline_views():
    base = pipeline.synth_cf_dataset(USERS, ITEMS, interactions_per_user=4,
                                     seed=0)
    view = pipeline.device_cf_dataset(base, "cpu")
    with pytest.raises(ValueError, match="ring state"):
        view.apply_events(np.zeros(4, np.int32), np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="1-D"):
        _ring().apply_events(np.zeros((2, 2), np.int32),
                             np.zeros((2, 2), np.int32))


def test_apply_events_bumps_the_popularity_cdf():
    """In-place counts change the weights' version, so the popularity
    sampler rebuilds its CDF: an item first seen in this batch is drawn in
    the next draw."""
    ds = _ring()
    ds, _, _ = ds.apply_events(np.asarray([0], np.int32),
                               np.asarray([3], np.int32))
    sampler = teng.SAMPLERS["popularity"]
    table = torch.zeros(ITEMS, DIM)
    ctx = teng.SampleContext(table=table, tile=None, pos_ids=None,
                             weights=ds.item_weights)
    first = sampler.sample(ctx, mf.generator(0, "cpu"), (64,)).ids
    assert set(first.tolist()) == {3}
    ds, _, _ = ds.apply_events(np.asarray([1] * 8, np.int32),
                               np.asarray([50] * 8, np.int32))
    again = sampler.sample(ctx, mf.generator(0, "cpu"), (64,)).ids
    assert 50 in again.tolist()


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), cap=st.integers(1, 6),
       n=st.integers(1, 40), hot=st.integers(1, USERS),
       pad=st.floats(0.0, 1.0), batches=st.integers(1, 4))
def test_apply_events_equals_the_reference(seed, cap, n, hot, pad, batches):
    """The vectorized fold equals the reference's sequential fori_loop bit
    for bit: ring, counts, cursors and first-seen masks, with padding,
    duplicate users and users with more events than the capacity (``hot``
    narrows the users drawn)."""
    rng = np.random.default_rng(seed)
    jd = jpipe.stream_ring_dataset(USERS, ITEMS, cap)
    td = _ring(cap=cap)
    for _ in range(batches):
        users = rng.integers(0, hot, n).astype(np.int32)
        items = rng.integers(0, ITEMS, n).astype(np.int32)
        users[rng.random(n) < pad] = -1
        jd, ju, ji = jd.apply_events(users, items)
        td, tu, ti = td.apply_events(users, items)
        for name, a, b in (("train_pos", jd.train_pos, td.train_pos),
                           ("item_weights", jd.item_weights, td.item_weights),
                           ("row_count", jd.row_count, td.row_count),
                           ("write_pos", jd.write_pos, td.write_pos),
                           ("new_users", ju, tu), ("new_items", ji, ti)):
            assert np.array_equal(np.asarray(a), _np(b)), name


def test_stream_ring_dataset_warm_start_keeps_newest():
    base = pipeline.synth_cf_dataset(8, ITEMS, interactions_per_user=6,
                                     seed=0)
    ring = _ring(8, ITEMS, cap=4, base=base)
    for u in range(8):
        stored = base.train_pos[u][base.train_pos[u] >= 0][-4:]
        assert np.array_equal(_np(ring.train_pos)[u, :stored.size], stored)
    kept = _np(ring.train_pos)
    assert np.array_equal(
        _np(ring.item_weights),
        np.bincount(kept[kept >= 0].ravel(), minlength=ITEMS))


@pytest.mark.parametrize("cap", [1, 3, 4, 8])
def test_stream_ring_dataset_equals_the_reference(cap):
    """The warm start (holes in the rows included) and the cold start equal
    the reference's, and a mismatched base is refused."""
    base = pipeline.synth_cf_dataset(USERS, ITEMS, interactions_per_user=7,
                                     seed=4)
    base.train_pos[3, 1] = -1                # a hole mid-row
    base.train_pos[5, :] = -1                # an empty user
    for b in (None, base):
        jd = jpipe.stream_ring_dataset(USERS, ITEMS, cap, base=b)
        td = _ring(cap=cap, base=b)
        for f in ("train_pos", "item_weights", "row_count", "write_pos"):
            assert np.array_equal(np.asarray(getattr(jd, f)),
                                  _np(getattr(td, f))), f
    with pytest.raises(ValueError, match="base dataset"):
        _ring(USERS + 1, ITEMS, cap=cap, base=base)
    with pytest.raises(ValueError, match="capacity"):
        _ring(cap=0)


def _filled_pair(seed=0, n=200, hot=USERS // 2, cap=CAP):
    """The same ring in both packages after a few event batches."""
    rng = np.random.default_rng(seed)
    jd = jpipe.stream_ring_dataset(USERS, ITEMS, cap)
    td = _ring(cap=cap)
    for _ in range(3):
        users = rng.integers(0, hot, n).astype(np.int32)
        items = rng.integers(0, ITEMS, n).astype(np.int32)
        jd, _, _ = jd.apply_events(users, items)
        td, _, _ = td.apply_events(users, items)
    return jd, td


def _reference_draws(jd, seed, step, batch):
    """The users and uniforms ``jpipe.stream_batch_device`` draws, from its
    own keys."""
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), step), 1)
    ku, ka = jax.random.split(key)
    logits = jnp.where(jd.row_count > 0, 0.0, -jnp.inf)
    users = jax.random.categorical(ku, logits, shape=(batch,))
    return np.array(users), np.array(jax.random.uniform(ka, (batch,)))


@pytest.mark.parametrize("recency,history_len", [(0.0, 0), (0.5, 0),
                                                 (3.0, 3), (0.5, 6)])
def test_stream_batch_from_equals_the_reference(recency, history_len):
    jd, td = _filled_pair()
    for step in range(3):
        users, u01 = _reference_draws(jd, 11, step, 256)
        want = jpipe.stream_batch_device(jd, 11, step, 256, recency=recency,
                                         history_len=history_len)
        assert np.array_equal(np.asarray(want.user_ids), users)
        got = pipeline.stream_batch_from(
            td, torch.as_tensor(users, dtype=torch.int64),
            torch.as_tensor(u01), recency=recency, history_len=history_len)
        assert np.array_equal(_np(got.pos_ids), np.asarray(want.pos_ids))
        if history_len:
            assert np.array_equal(_np(got.hist_ids), np.asarray(want.hist_ids))
            assert np.array_equal(_np(got.hist_mask),
                                  np.asarray(want.hist_mask))
        else:
            assert got.hist_ids is None and want.hist_ids is None


def test_ring_users_is_uniform_over_active_users_only():
    rc = torch.zeros(10, dtype=torch.int64)
    rc[torch.tensor([2, 3, 7])] = torch.tensor([1, 4, 2])
    u = torch.tensor([0.0, 0.33, 0.34, 0.66, 0.67, 0.9999999],
                     dtype=torch.float64)
    assert pipeline.ring_users(rc, u).tolist() == [2, 2, 3, 3, 7, 7]
    assert pipeline.ring_users(torch.zeros(5, dtype=torch.int64),
                               u).tolist() == [0] * 6


def test_stream_batch_samples_only_ingested_users_and_ring_items():
    ds = _ring()
    active = {2: [10, 11], 7: [12], 40: [13, 14, 15]}
    for u, vs in active.items():
        ds, _, _ = ds.apply_events(np.full(len(vs), u, np.int32),
                                   np.asarray(vs, np.int32))
    batch = pipeline.stream_batch_device(ds, seed=0, step=3, batch_size=64)
    users, pos = _np(batch.user_ids), _np(batch.pos_ids)
    assert set(users) == set(active)          # 64 draws over 3 users
    for u, p in zip(users, pos):
        assert p in active[u]


def test_stream_batch_recency_prefers_newest():
    ds = _ring(4, ITEMS, cap=CAP)
    ds, _, _ = ds.apply_events(np.zeros(4, np.int32),
                               np.asarray([20, 21, 22, 23], np.int32))
    strong = pipeline.stream_batch_device(ds, seed=0, step=0,
                                          batch_size=2048, recency=3.0)
    frac_newest = float(np.mean(_np(strong.pos_ids) == 23))
    uniform = pipeline.stream_batch_device(ds, seed=0, step=0,
                                           batch_size=2048, recency=0.0)
    frac_uniform = float(np.mean(_np(uniform.pos_ids) == 23))
    assert frac_newest > 0.85
    assert 0.15 < frac_uniform < 0.35


def test_stream_batch_is_pure_in_seed_and_step_with_history():
    ds = _ring()
    ds, _, _ = ds.apply_events(np.arange(USERS, dtype=np.int32),
                               (np.arange(USERS, dtype=np.int32) * 3) % ITEMS)
    draws = [pipeline.stream_batch_device(ds, 0, s, 8, recency=0.5,
                                          history_len=2) for s in (0, 1, 0)]
    assert draws[0].hist_mask.shape == (8, 2)
    # each user has exactly 1 ring entry -> one valid history slot
    assert np.array_equal(_np(draws[0].hist_mask).sum(-1), np.ones(8))
    for a, b in zip(draws[0], draws[2]):
        assert torch.equal(a, b)
    assert not torch.equal(draws[0].user_ids, draws[1].user_ids)
    other = pipeline.stream_batch_device(ds, 1, 0, 8, recency=0.5)
    assert not torch.equal(draws[0].user_ids, other.user_ids)
    with pytest.raises(ValueError, match="ring view"):
        pipeline.stream_batch_device(pipeline.device_cf_dataset(
            pipeline.synth_cf_dataset(8, 16, seed=0), "cpu"), 0, 0, 4)


@pytest.mark.parametrize("recency", [0.0, 0.5])
def test_ring_draw_computed_once_equals_the_per_step_draw(recency):
    ds = _ring()
    rng = np.random.default_rng(5)
    ds, _, _ = ds.apply_events(rng.integers(0, USERS // 2, 48).astype(np.int32),
                               rng.integers(0, ITEMS, 48).astype(np.int32))
    draw = pipeline.ring_draw(ds, recency)
    for step in range(4):
        once = pipeline.stream_batch_device(ds, 3, step, 32, recency=recency,
                                            history_len=2, draw=draw)
        each = pipeline.stream_batch_device(ds, 3, step, 32, recency=recency,
                                            history_len=2)
        for a, b in zip(once, each):
            assert torch.equal(a, b)
    # new users change the running count, so the draw is redone per ingest
    ds, _, _ = ds.apply_events(np.asarray([USERS - 1], np.int32),
                               np.asarray([0], np.int32))
    assert int(pipeline.ring_draw(ds, recency).active[-1]) \
        == int(draw.active[-1]) + 1


# ---------------------------------------------------------------------------
# one streaming round: the reference's draws replayed into the port
# ---------------------------------------------------------------------------

class ReplaySampler:
    """Returns the reference's negatives for each step, in order."""

    name = "replay"

    def __init__(self):
        self.queue = []

    def sample(self, state, gen, shape):
        ids = self.queue.pop(0)
        assert tuple(ids.shape) == tuple(shape)
        return teng.NegSample(ids, tqz.gather_rows(state.table, ids), state)


@pytest.fixture
def replay():
    sampler = ReplaySampler()
    teng.register_sampler("replay")(sampler)
    yield sampler
    del teng.SAMPLERS["replay"]


def _flat(jstate):
    return {n: np.asarray(leaf) for n, leaf in jckpt._flatten_with_paths(jstate)}


@pytest.mark.parametrize("sampler", ["uniform", "popularity"])
@pytest.mark.parametrize("backend,update", [("fused", "scatter_add"),
                                            ("pallas", "pallas")])
def test_one_streaming_round_matches_the_reference(backend, update, sampler,
                                                   replay, monkeypatch):
    jcfg = jmf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                        num_negatives=8, lr=0.4, backend=backend,
                        update_impl=update, sampler=sampler)
    scfg = dict(capacity=CAP, micro_batch=64, steps_per_round=4,
                batch_size=32, recency=0.5, seed=0)
    jt = jservice.StreamingTrainer(
        jcfg, jsources.SyntheticStream(USERS, ITEMS, seed=0, total=64),
        jservice.StreamingConfig(**scfg), log=lambda *_: None)
    init = _flat(jt.state)
    batch = jt.stream.next_batch(64)
    jt.ingest_events(batch.user_ids, batch.item_ids)
    ingested = _flat(jt.state)

    # the reference's round, step by step, recording its draws
    engine = jeng.resolve_engine(jcfg)
    jstate, jlosses, batches = jt.state, [], {}
    for step in range(scfg["steps_per_round"]):
        jb = jpipe.stream_batch_device(jt.data, 0, step, 32, recency=0.5)
        rng = jax.random.fold_in(jax.random.PRNGKey(0), step)
        r_neg, _ = jax.random.split(rng)
        drawn = engine.sampler.sample(
            jeng.SampleContext(table=jstate.params.item_table, tile=None,
                               pos_ids=jb.pos_ids,
                               weights=jt.data.item_weights), r_neg, (32, 8))
        replay.queue.append(torch.as_tensor(np.asarray(drawn.ids),
                                            dtype=torch.int64))
        batches[step] = mf.Batch(
            torch.as_tensor(np.asarray(jb.user_ids), dtype=torch.int64),
            torch.as_tensor(np.asarray(jb.pos_ids), dtype=torch.int64))
        jstate, loss = jmf.heat_train_step(jstate, jb, rng, jcfg,
                                           engine=engine,
                                           item_weights=jt.data.item_weights)
        jlosses.append(float(loss))

    # the port: the reference's initial state, its fresh rows, its batches
    fresh = {USERS: ingested["params/user_table"],
             ITEMS: ingested["params/item_table"]}

    def replay_rows(table, mask, key, std):
        table[mask] = torch.as_tensor(fresh[table.shape[0]])[mask]

    monkeypatch.setattr(stream_service, "_init_rows_", replay_rows)
    monkeypatch.setattr(pipeline, "stream_batch_device",
                        lambda ds, seed, step, bs, **kw: batches[step])
    cfg = mf.MFConfig(**dataclasses.asdict(jcfg))
    tt = StreamingTrainer(
        cfg, SyntheticStream(USERS, ITEMS, seed=0, total=64),
        StreamingConfig(**scfg), state=convert.mf_state_from_numpy(init),
        data=_ring(), engine=teng.resolve_engine(cfg, sampler="replay"),
        device="cpu", log=lambda *_: None)
    assert tt.run_round()
    assert not replay.queue
    for f in ("train_pos", "item_weights", "row_count", "write_pos"):
        assert np.array_equal(_np(getattr(tt.data, f)),
                              np.asarray(getattr(jt.data, f))), f
    np.testing.assert_allclose(tt.loss_history(), jlosses, atol=ATOL)
    want, got = _flat(jstate), convert.mf_state_to_numpy(tt.state)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# checkpoints of the ring
# ---------------------------------------------------------------------------

def test_stream_checkpoint_leaves_equal_the_references(tmp_path):
    """The manifest of a stream checkpoint names the same leaves, with the
    same shapes and dtypes, in both packages, and each restores the
    other's."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jcfg = jmf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                        num_negatives=8, tile_size=16, backend="fused")
    kw = dict(capacity=CAP, micro_batch=32, steps_per_round=2, batch_size=16,
              ckpt_every=1)
    jt = jservice.StreamingTrainer(
        jcfg, jsources.SyntheticStream(USERS, ITEMS, seed=0, total=64),
        jservice.StreamingConfig(ckpt_dir=jdir, **kw), log=lambda *_: None)
    jt.run(rounds=1)
    tt = _service(ckpt_dir=tdir, cfg=mf.MFConfig(**dataclasses.asdict(jcfg)),
                  **{k: v for k, v in kw.items() if k != "ckpt_every"})
    tt.run(rounds=1)

    def manifest(d):
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            m = json.load(f)
        return [(x["name"], x["shape"], x["dtype"]) for x in m["leaves"]], m

    (jl, jm), (tl, tm) = manifest(jdir), manifest(tdir)
    assert tl == jl
    assert [n for n, _, _ in tl][:4] == ["data/train_pos", "data/item_weights",
                                         "data/row_count", "data/write_pos"]
    assert tm["extra"].keys() == jm["extra"].keys()
    # the port restores the reference's checkpoint, leaf for leaf
    tree, _, _ = tckpt.restore(jdir, {"state": tt.state, "data": tt.data})
    for name, leaf in tckpt.named_leaves(tree):
        assert np.array_equal(tckpt.leaf_to_numpy(leaf),
                              np.load(os.path.join(
                                  jdir, "step_00000001",
                                  name.replace("/", "__") + ".npy"))), name
    assert tree["data"].num_users == USERS
    # an offline view writes no ring leaves
    offline = pipeline.device_cf_dataset(
        pipeline.synth_cf_dataset(8, 16, seed=0), "cpu")
    assert [n for n, _ in tckpt.named_leaves({"data": offline})] == [
        "data/train_pos", "data/item_weights"]


# ---------------------------------------------------------------------------
# the service loop (the port's own draws)
# ---------------------------------------------------------------------------

def _service(total=6 * 32, fail_at_event=None, ckpt_dir=None,
             with_probe=True, seed=0, cfg=None, **kw):
    stream = SyntheticStream(USERS, ITEMS, seed=seed, total=total,
                             user_drift=0.02, item_drift=0.02)
    if with_probe:
        # probe user 40 sits outside the power-law head and the probe item
        # comes from another cluster: only the spliced burst teaches the pair
        stream = ProbeInjector(stream, total // 3, user=40, item=ITEMS - 1,
                               repeat=CAP)
    cfg = cfg or mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                             num_negatives=8, lr=0.4, backend="fused",
                             sampler="popularity")
    opts = dict(capacity=CAP, micro_batch=32, steps_per_round=8,
                batch_size=32, recency=0.5, seed=seed, ckpt_dir=ckpt_dir,
                ckpt_every=1, fail_at_event=fail_at_event)
    opts.update(kw)
    return StreamingTrainer(cfg, stream, StreamingConfig(**opts),
                            device="cpu", log=lambda *_: None)


def _fingerprint(t: StreamingTrainer):
    return {
        "user_table": _np(t.state.params.user_table),
        "item_table": _np(t.state.params.item_table),
        "train_pos": _np(t.data.train_pos),
        "item_weights": _np(t.data.item_weights),
        "row_count": _np(t.data.row_count),
        "write_pos": _np(t.data.write_pos),
        "step": t.step, "events": t.events, "rounds": t.rounds,
    }


def _assert_same(a: dict, b: dict):
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{k} diverged"


def test_service_freshness_probe_reaches_served_topk():
    trainer = _service()
    server = BatchingRecommender(trainer.state, 10, max_wait_ms=0.2)
    trainer.recommender = server
    served_round = None
    while trainer.run(rounds=1):
        if ITEMS - 1 in server.recommend(40).tolist():
            served_round = trainer.rounds
            break
    assert served_round is not None, "probe item never reached served top-k"
    assert trainer.executor.trace_counter.count == 1
    assert server.trace_count == 1
    s = trainer.last_round_stats
    assert s["round"] == trainer.rounds and s["events"] > 0
    server.stop()


def test_service_refuses_to_train_before_first_event():
    trainer = _service(with_probe=False)
    with pytest.raises(ValueError, match="ingest before"):
        trainer.train_round()


def test_service_refuses_int8_tables_and_offline_views():
    cfg = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                      table_format="int8")
    with pytest.raises(NotImplementedError, match="fp32"):
        _service(cfg=cfg)
    offline = pipeline.device_cf_dataset(
        pipeline.synth_cf_dataset(USERS, ITEMS, seed=0), "cpu")
    with pytest.raises(ValueError, match="ring view"):
        StreamingTrainer(mf.MFConfig(num_users=USERS, num_items=ITEMS),
                         SyntheticStream(USERS, ITEMS), data=offline,
                         device="cpu")


def test_service_ingest_pads_to_one_apply_shape():
    trainer = _service(with_probe=False)
    pipeline.APPLY_EVENTS_SHAPES.reset()
    trainer.ingest_events(np.asarray([1, 2, 3], np.int32),
                          np.asarray([4, 5, 6], np.int32))
    trainer.ingest_events(np.arange(40, dtype=np.int32),
                          np.arange(40, dtype=np.int32) % ITEMS)
    assert pipeline.APPLY_EVENTS_SHAPES.count == 1
    assert trainer.events == 43


def test_fresh_rows_are_drawn_for_first_seen_ids_only():
    trainer = _service(with_probe=False)
    before = [t.clone() for t in trainer.state.params[:2]]
    trainer.ingest_events(np.asarray([1, 2, 1], np.int32),
                          np.asarray([5, 6, 5], np.int32))
    after = trainer.state.params[:2]
    changed = [torch.nonzero((a != b).any(1)).reshape(-1).tolist()
               for a, b in zip(before, after)]
    assert changed == [[1, 2], [5, 6]]
    again = _service(with_probe=False)
    again.ingest_events(np.asarray([1, 2, 1], np.int32),
                        np.asarray([5, 6, 5], np.int32))
    for a, b in zip(after, again.state.params[:2]):
        assert torch.equal(a, b)


def test_checkpoint_covers_cursor_and_ring(tmp_path):
    ckpt = str(tmp_path / "ck")
    trainer = _service(ckpt_dir=ckpt)
    trainer.run(rounds=3)
    saved = _fingerprint(trainer)
    cursor = trainer.stream.cursor
    fresh = _service(ckpt_dir=ckpt)
    fresh.restore()
    _assert_same(saved, _fingerprint(fresh))
    assert fresh.stream.cursor == cursor
    trainer.run(rounds=2)
    fresh.run(rounds=2)
    _assert_same(_fingerprint(trainer), _fingerprint(fresh))


@settings(max_examples=4, deadline=None)
@given(fail_at=st.integers(5, 6 * 32 - 5))
def test_crash_resume_is_bit_exact_at_any_offset(fail_at):
    clean = _service()
    clean.run()
    ref = _fingerprint(clean)
    ref_topk = _np(mf.topk_all_items(clean.state.params, torch.arange(8), 10))
    ckpt = tempfile.mkdtemp(prefix="stream_resume_")
    try:
        crashed = _service(fail_at_event=fail_at, ckpt_dir=ckpt)
        crashed.run()
        assert crashed.restarts == 1
        _assert_same(ref, _fingerprint(crashed))
        got_topk = _np(mf.topk_all_items(crashed.state.params,
                                         torch.arange(8), 10))
        assert np.array_equal(ref_topk, got_topk)
        assert crashed.loss_history() == clean.loss_history()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def test_cold_start_crash_without_checkpoint_replays_from_scratch():
    clean = _service()
    clean.run()
    crashed = _service(fail_at_event=40)
    crashed.run()
    assert crashed.restarts == 1
    _assert_same(_fingerprint(clean), _fingerprint(crashed))


def test_warm_start_crash_without_checkpoint_is_a_hard_error():
    base = pipeline.synth_cf_dataset(USERS, ITEMS, interactions_per_user=4,
                                     seed=0)
    cfg = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                      num_negatives=8, backend="fused")
    state, _ = trainer_mod.train_mf(cfg, base, steps=4, batch_size=16,
                                    device="cpu", log=lambda *_: None)
    warm = StreamingTrainer(
        cfg, SyntheticStream(USERS, ITEMS, seed=0, total=200),
        StreamingConfig(capacity=CAP, micro_batch=32, steps_per_round=4,
                        batch_size=16, fail_at_event=100),
        state=state, data=_ring(base=base), device="cpu",
        log=lambda *_: None)
    with pytest.raises(RuntimeError, match="warm-started"):
        warm.run()


def test_warm_start_trains_the_given_state_in_place():
    base = pipeline.synth_cf_dataset(USERS, ITEMS, interactions_per_user=4,
                                     seed=0)
    cfg = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                      num_negatives=8, backend="fused")
    state = mf.init_mf(0, cfg, device="cpu")
    kept = state.params.item_table.clone()
    warm = StreamingTrainer(
        cfg, SyntheticStream(USERS, ITEMS, seed=0, total=64),
        StreamingConfig(capacity=CAP, micro_batch=32, steps_per_round=4,
                        batch_size=16), state=state, data=_ring(base=base),
        device="cpu", log=lambda *_: None)
    assert warm.run(rounds=1) == 1
    assert warm.state.params.item_table is state.params.item_table
    assert not torch.equal(kept, state.params.item_table)


def test_service_loop_stays_in_shape_budget_across_rounds():
    trainer = _service(with_probe=False)
    pipeline.APPLY_EVENTS_SHAPES.reset()
    trainer.run()
    assert trainer.rounds == 6
    assert trainer.executor.trace_counter.count == 1
    assert pipeline.APPLY_EVENTS_SHAPES.count == 1
    with pytest.raises(RetraceError, match="budget 1"):
        trainer.executor.run(stream_service.StreamCarry(trainer.state,
                                                        trainer.data), 0, 3)


def test_salted_start_is_not_truncated():
    """A salted window starts past 2^31 without wrapping: its draws differ
    from the unsalted and the 2^32-wrapped starts."""
    trainer = _service(with_probe=False)
    trainer.ingest_events(np.arange(USERS, dtype=np.int32),
                          np.arange(USERS, dtype=np.int32) % ITEMS)
    big = 3 * (1 << 31)
    draws = [pipeline.stream_batch_device(trainer.data, 0, s, 32).user_ids
             for s in (big, big % (1 << 32), big)]
    assert torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], draws[1])
    assert stream_service.SALT_STRIDE == 1 << 20


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_stream_cli_runs_on_the_cpu_when_asked(capsys, tmp_path):
    from repro_torch.launch import stream
    log = str(tmp_path / "events.jsonl")
    stream.main(["--device", "cpu", "--users", "48", "--items", "64",
                 "--emb-dim", "8", "--rounds", "3", "--micro-batch", "32",
                 "--batch-size", "16", "--steps-per-round", "4",
                 "--record", log, "--ckpt-dir", str(tmp_path / "ck"),
                 "--fail-at-event", "50"])
    out = capsys.readouterr().out
    assert "[stream] recorded 96 events" in out
    assert "injected failure at event 50 (round 1) -> restoring" in out
    assert "[stream] round   1: 32 events | ingest" in out
    assert "window traces=1, serve traces=1, restarts=1" in out
    assert "[stream] freshness SLO:" in out


def test_stream_cli_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.launch import stream
    with pytest.raises(SystemExit):
        stream.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingTrainer(mf.MFConfig(num_users=8, num_items=8),
                         SyntheticStream(8, 8))
