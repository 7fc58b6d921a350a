"""The port's self-healing layer (``repro_torch.resilience``) on the CPU.

Parity with the JAX package: the retry backoff schedule and the chaos
fault schedule are the reference's for several seeds, and the divergence
guard takes the same decisions, with the same reason strings, on the same
windows and tables (fp32 and int8).  Within the port: the reference's
tests of the retrying stream, the guard, degraded serving, the
rollback-resume determinism property (two identical poisoned runs heal onto
the identical trajectory) and the chaos harness end to end.
"""
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import mf as jmf
from repro.optim import quantization as jqz
from repro.resilience import chaos as jchaos
from repro.resilience import guard as jguard
from repro.resilience import streams as jstreams
from repro.stream import sources as jsources
from repro.train.checkpoint import _flatten_with_paths
from repro_torch import convert
from repro_torch.core import mf
from repro_torch.launch.server import BatchingRecommender
from repro_torch.optim import quantization as tqz
from repro_torch.resilience import (DivergenceGuard, FlakyStream, GuardConfig,
                                    RetryingStream, TransientStreamError)
from repro_torch.resilience import guard as guard_mod
from repro_torch.resilience.chaos import FAULT_KINDS, make_schedule, run_chaos
from repro_torch.stream.service import StreamingConfig, StreamingTrainer
from repro_torch.stream.sources import InteractionStream, SyntheticStream

USERS, ITEMS, DIM, CAP = 64, 96, 8, 4


# ---------------------------------------------------------------------------
# stream fault tolerance
# ---------------------------------------------------------------------------

def test_retrying_stream_absorbs_faults_bit_exactly():
    plain = SyntheticStream(USERS, ITEMS, seed=3, total=200)
    flaky = FlakyStream(SyntheticStream(USERS, ITEMS, seed=3, total=200),
                        {50: 2, 120: 1})
    retry = RetryingStream(flaky, max_attempts=4, seed=0,
                           sleep=lambda _: None)
    assert isinstance(flaky, InteractionStream)
    assert isinstance(retry, InteractionStream)
    got, ref = [], []
    while (b := retry.next_batch(25)) is not None:
        got.append(b)
    while (b := plain.next_batch(25)) is not None:
        ref.append(b)
    assert flaky.raised == 3 and retry.retries == 3 and retry.gave_up == 0
    assert np.array_equal(np.concatenate([b.user_ids for b in got]),
                          np.concatenate([b.user_ids for b in ref]))
    assert np.array_equal(np.concatenate([b.item_ids for b in got]),
                          np.concatenate([b.item_ids for b in ref]))


def test_retry_backoff_is_seeded_and_bounded():
    def run_once():
        flaky = FlakyStream(SyntheticStream(USERS, ITEMS, seed=0, total=100),
                            {10: 3})
        retry = RetryingStream(flaky, max_attempts=5, base_delay=0.05,
                               max_delay=0.3, seed=7, sleep=lambda _: None)
        while retry.next_batch(20) is not None:
            pass
        return list(retry.delays)
    a, b = run_once(), run_once()
    assert a == b and len(a) == 3
    for attempt, delay in enumerate(a):
        cap = min(0.05 * 2 ** attempt, 0.3)
        assert cap / 2 <= delay <= cap


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_retry_backoff_schedule_equals_the_reference(seed):
    """Same faults, same seed: the same delays, retries and delivered
    events as the reference's RetryingStream."""
    def run(sources, streams):
        flaky = streams.FlakyStream(
            sources.SyntheticStream(USERS, ITEMS, seed=seed, total=300),
            {0: 2, 77: 3, 150: 1, 299: 2})
        retry = streams.RetryingStream(flaky, max_attempts=5,
                                       base_delay=0.01, max_delay=0.05,
                                       seed=seed, sleep=lambda _: None)
        users = []
        while (b := retry.next_batch(40)) is not None:
            users.append(b.user_ids)
        return retry.delays, retry.retries, np.concatenate(users)

    from repro_torch.resilience import streams as tstreams
    from repro_torch.stream import sources as tsources
    want, got = run(jsources, jstreams), run(tsources, tstreams)
    assert got[0] == want[0] and got[1] == want[1] == 8
    assert np.array_equal(got[2], want[2])


def test_retrying_stream_gives_up_after_attempt_cap():
    flaky = FlakyStream(SyntheticStream(USERS, ITEMS, seed=0, total=100),
                        {0: 99})
    retry = RetryingStream(flaky, max_attempts=3, sleep=lambda _: None)
    with pytest.raises(TransientStreamError):
        retry.next_batch(10)
    assert retry.gave_up == 1 and retry.retries == 2
    flaky._remaining[0] = 0
    assert retry.next_batch(10).start == 0


def test_flaky_stream_fails_before_touching_the_base():
    flaky = FlakyStream(SyntheticStream(USERS, ITEMS, seed=0, total=100),
                        {5: 1})
    with pytest.raises(TransientStreamError):
        flaky.next_batch(10)
    assert flaky.cursor == 0
    assert flaky.next_batch(10).start == 0


# ---------------------------------------------------------------------------
# divergence guard
# ---------------------------------------------------------------------------

def _params():
    cfg = mf.MFConfig(num_users=8, num_items=8, emb_dim=4)
    return mf.init_mf(0, cfg, device="cpu").params


def test_guard_passes_a_healthy_window():
    g = DivergenceGuard()
    assert g.check(_params(), np.full(8, 0.5)) is None
    assert g.checks == 1 and g.trips == 0


def test_guard_trips_on_nonfinite_loss():
    g = DivergenceGuard()
    w = np.full(8, 0.5)
    w[3] = np.nan
    assert "non-finite loss" in g.check(_params(), w)
    assert g.trips == 1 and g.last_trip is not None


def test_guard_trips_on_absolute_loss_ceiling():
    g = DivergenceGuard(GuardConfig(max_loss=10.0))
    assert "ceiling" in g.check(_params(), np.full(8, 50.0))


def test_guard_trips_on_loss_spike_vs_ema():
    g = DivergenceGuard(GuardConfig(spike_factor=100.0))
    assert g.check(_params(), np.full(8, 0.5)) is None
    assert "spiked" in g.check(_params(), np.full(8, 500.0))


def test_guard_trips_on_nonfinite_table():
    g = DivergenceGuard()
    p = _params()
    p.item_table[0, 0] = float("nan")
    assert "item table" in g.check(p, np.full(8, 0.5))


def test_guard_trips_on_table_norm_blowup():
    g = DivergenceGuard()
    p = _params()
    p = p._replace(user_table=p.user_table * 1e6)
    assert "row norm" in g.check(p, np.full(8, 0.5))


def test_guard_reset_forgets_the_ema_reference():
    g = DivergenceGuard()
    assert g.check(_params(), np.full(8, 0.5)) is None
    g.reset()
    assert g.check(_params(), np.full(8, 500.0)) is None


def test_guard_reads_the_tables_once_per_check(monkeypatch):
    """One (4,) stats readback per round, none when a loss check trips."""
    calls = []
    orig = guard_mod.table_stats

    def counting(u, i):
        out = orig(u, i)
        calls.append(out.shape)
        return out

    monkeypatch.setattr(guard_mod, "table_stats", counting)
    g = DivergenceGuard()
    p = _params()
    for i in range(5):
        g.check(p, np.full(8, 0.5 + 0.01 * i))
    assert calls == [(4,)] * 5
    g.check(p, np.full(8, np.nan))
    assert len(calls) == 5


def _tables(fmt, poison):
    """The same (user, item) tables in both packages: fp32, or int8 from one
    quantization of the fp32 draw; ``poison`` breaks them in one of the
    guard's ways."""
    r = np.random.default_rng(3)
    u = (0.1 * r.standard_normal((40, 8))).astype(np.float32)
    i = (0.1 * r.standard_normal((60, 8))).astype(np.float32)
    if poison == "nan_user":
        u[5, 2] = np.nan
    elif poison == "inf_item":
        i[7, 0] = np.inf
    elif poison == "norm":
        i[3] *= 1e5
    if fmt == "fp32":
        return ((jnp.asarray(u), jnp.asarray(i)),
                (torch.as_tensor(u), torch.as_tensor(i)))
    jt = [jqz.quantize_table(jnp.asarray(x)) for x in (u, i)]
    tt = [tqz.QuantizedTable(*(torch.as_tensor(np.array(leaf)) for leaf in t))
          for t in jt]
    return tuple(jt), tuple(tt)


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
@pytest.mark.parametrize("poison", ["none", "nan_user", "inf_item", "norm"])
def test_guard_decides_as_the_reference(fmt, poison):
    """A sequence of windows (healthy, a spike, a NaN, an over-ceiling loss,
    a reset) over the same tables: the same reason (or None) at every
    check, and the same counters."""
    (ju, ji), (tu, ti) = _tables(fmt, poison)
    jp = jmf.MFParams(ju, ji, None)
    tp = mf.MFParams(tu, ti, None)
    windows = [np.full(8, 0.5), np.linspace(0.4, 0.6, 8), np.full(8, 80.0),
               np.array([0.5] * 7 + [np.nan]), np.full(8, 2e4), None,
               np.full(8, 80.0), np.zeros(0)]
    jg, tg = jguard.DivergenceGuard(), DivergenceGuard()
    for w in windows:
        if w is None:
            jg.reset()
            tg.reset()
            continue
        assert tg.check(tp, w) == jg.check(jp, w), (fmt, poison, w)
    assert (tg.checks, tg.trips, tg.last_trip) == (jg.checks, jg.trips,
                                                   jg.last_trip)


# ---------------------------------------------------------------------------
# degraded serving
# ---------------------------------------------------------------------------

def _live_service(**scfg_kw):
    stream = SyntheticStream(USERS, ITEMS, seed=0, total=6 * 32,
                             user_drift=0.02, item_drift=0.02)
    cfg = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                      num_negatives=8, lr=0.4, backend="fused",
                      sampler="popularity")
    scfg = StreamingConfig(capacity=CAP, micro_batch=32, steps_per_round=8,
                           batch_size=32, recency=0.5, seed=0, **scfg_kw)
    trainer = StreamingTrainer(cfg, stream, scfg, device="cpu",
                               log=lambda *_: None)
    server = BatchingRecommender(trainer.state, 10, max_wait_ms=0.2)
    trainer.recommender = server
    return trainer, server


def test_degraded_serving_keeps_the_previous_snapshot():
    trainer, server = _live_service()
    try:
        assert trainer.run(rounds=1) == 1
        assert server.health["status"] == "ok"
        bad_cfg = mf.MFConfig(num_users=USERS, num_items=ITEMS,
                              emb_dim=DIM + 1)
        bad = mf.init_mf(1, bad_cfg, device="cpu")
        assert server.refresh_from(bad) is False
        h = server.health
        assert h["status"] == "degraded" and h["refresh_failures"] == 1
        assert "built for" in h["last_refresh_error"]
        got = server.recommend(7)
        assert got.shape == (10,) and np.all(np.isfinite(got))
        assert server.refresh_from(trainer.state) is True
        h = server.health
        assert h["status"] == "ok" and h["stale_refreshes"] == 0
        assert server.trace_count == 1
    finally:
        server.stop()


def test_refresh_from_can_raise_instead_of_degrading():
    trainer, server = _live_service()
    try:
        bad = mf.init_mf(1, mf.MFConfig(num_users=USERS, num_items=ITEMS,
                                        emb_dim=DIM + 1), device="cpu")
        with pytest.raises(ValueError):
            server.refresh_from(bad, on_error="raise")
    finally:
        server.stop()


def test_poisoned_round_never_reaches_serving_or_disk(tmp_path):
    """The guard trips before the refresh and the checkpoint: the server
    keeps the last good snapshot and no checkpoint of the poisoned round is
    written; the rollback then heals the run."""
    trainer, server = _live_service(ckpt_dir=str(tmp_path), ckpt_every=1,
                                    poison_at_round=2)
    try:
        assert trainer.run(rounds=1) == 1
        refreshes = server.health["refreshes"]
        with pytest.raises(guard_mod.DivergenceError, match="item table"):
            trainer.run_round()
        assert server.health["refreshes"] == refreshes
        assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001"]
        trainer.rollbacks = 1       # as run() counts it; poison fires once
        trainer._restore_or_reset()
        trainer.salt += 1
        assert trainer.run(rounds=1) == 1 and trainer.rounds == 2
        assert bool(torch.isfinite(trainer.state.params.item_table).all())
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# divergence rollback: deterministic resume past the poison window
# ---------------------------------------------------------------------------

def _poisoned_run(poison_round, ckpt_dir, total=6 * 32):
    stream = SyntheticStream(USERS, ITEMS, seed=0, total=total,
                             user_drift=0.02, item_drift=0.02)
    cfg = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                      num_negatives=8, lr=0.4, backend="fused",
                      sampler="popularity")
    scfg = StreamingConfig(capacity=CAP, micro_batch=32, steps_per_round=8,
                           batch_size=32, recency=0.5, seed=0,
                           ckpt_dir=ckpt_dir, ckpt_every=1,
                           poison_at_round=poison_round)
    trainer = StreamingTrainer(cfg, stream, scfg, device="cpu",
                               log=lambda *_: None)
    trainer.run()
    return trainer


def _fingerprint(t: StreamingTrainer):
    return {
        "user_table": t.state.params.user_table.numpy(),
        "item_table": t.state.params.item_table.numpy(),
        "train_pos": t.data.train_pos.numpy(),
        "row_count": t.data.row_count.numpy(),
        "write_pos": t.data.write_pos.numpy(),
        "step": t.step, "events": t.events, "rounds": t.rounds,
        "salt": t.salt, "rollbacks": t.rollbacks,
    }


@settings(max_examples=4, deadline=None)
@given(poison_round=st.integers(2, 5))
def test_rollback_resume_is_deterministic(poison_round):
    """Wherever the poison lands, the guard trips exactly once, the rollback
    salts past the poison window, the healed trajectory is identical across
    two independent runs, and the window length never changes."""
    d1 = tempfile.mkdtemp(prefix="heat_rollback_a_")
    d2 = tempfile.mkdtemp(prefix="heat_rollback_b_")
    try:
        a = _poisoned_run(poison_round, d1)
        b = _poisoned_run(poison_round, d2)
        for k, v in _fingerprint(a).items():
            assert np.array_equal(v, _fingerprint(b)[k]), f"{k} diverged"
        assert a.rollbacks == 1 and a.salt == 1
        assert a.rounds == 6
        assert bool(torch.isfinite(a.state.params.item_table).all())
        assert bool(torch.isfinite(a.state.params.user_table).all())
        assert a.executor.trace_counter.count == 1
    finally:
        shutil.rmtree(d1, ignore_errors=True)
        shutil.rmtree(d2, ignore_errors=True)


def test_rollback_salt_survives_checkpoint_resume(tmp_path):
    a = _poisoned_run(3, str(tmp_path))
    assert a.salt == 1
    stream = SyntheticStream(USERS, ITEMS, seed=0, total=6 * 32,
                             user_drift=0.02, item_drift=0.02)
    cfg = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                      num_negatives=8, lr=0.4, backend="fused",
                      sampler="popularity")
    scfg = StreamingConfig(capacity=CAP, micro_batch=32, steps_per_round=8,
                           batch_size=32, recency=0.5, seed=0,
                           ckpt_dir=str(tmp_path), ckpt_every=1)
    fresh = StreamingTrainer(cfg, stream, scfg, device="cpu",
                             log=lambda *_: None)
    fresh.restore()
    assert fresh.salt == 1 and fresh.step == a.step
    for k in ("user_table", "item_table", "train_pos", "row_count"):
        assert np.array_equal(_fingerprint(fresh)[k], _fingerprint(a)[k]), k


# ---------------------------------------------------------------------------
# chaos harness
# ---------------------------------------------------------------------------

def test_chaos_schedule_is_seeded_and_well_placed():
    a = make_schedule(5, 12)
    assert a == make_schedule(5, 12)
    assert sorted(a.values()) == sorted(FAULT_KINDS)
    assert all(2 <= r <= 11 for r in a)
    with pytest.raises(ValueError, match="rounds >="):
        make_schedule(0, len(FAULT_KINDS) + 2)


@pytest.mark.parametrize("seed,rounds", [(0, 10), (1, 10), (5, 12), (99, 7),
                                         (2024, 20)])
def test_chaos_schedule_equals_the_reference(seed, rounds):
    assert jchaos.FAULT_KINDS == FAULT_KINDS
    assert make_schedule(seed, rounds) == jchaos.make_schedule(seed, rounds)


def test_chaos_harness_detects_and_recovers_every_fault():
    report = run_chaos(seed=0, rounds=8, num_users=USERS, num_items=ITEMS,
                       emb_dim=DIM, capacity=CAP, micro_batch=32,
                       steps_per_round=8, batch_size=32, device="cpu")
    assert report["problems"] == []
    assert {f["kind"] for f in report["faults"]} == set(FAULT_KINDS)
    for f in report["faults"]:
        assert f["detected"] and f["recovered"], f
        assert f["recovery_s"] >= 0.0
    fin = report["final"]
    assert fin["window_traces"] == 1 and fin["serve_traces"] == 1
    assert fin["rollbacks"] == 1 and fin["health"]["status"] == "ok"


def test_chaos_cli_at_the_reference_defaults_on_the_cpu(capsys, tmp_path):
    from repro_torch.resilience import chaos
    out_json = str(tmp_path / "report.json")
    assert chaos.main(["--device", "cpu", "--json", out_json]) == 0
    out = capsys.readouterr().out
    for kind in FAULT_KINDS:
        assert f"[chaos] {kind}" in out and "NOT RECOVERED" not in out
    assert "window_traces=1, serve_traces=1, health=ok" in out
    assert "PROBLEM" not in out


def test_chaos_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.resilience import chaos
    with pytest.raises(SystemExit):
        chaos.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_chaos(seed=0, rounds=8)


def test_convert_carries_a_reference_state_into_a_guarded_port_run():
    """A reference initial state carried over by convert.py passes the
    port's guard as it passes the reference's."""
    cfg = jmf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM)
    jstate = jmf.init_mf(jax.random.PRNGKey(0), cfg)
    tstate = convert.mf_state_from_numpy(
        {n: np.asarray(x) for n, x in _flatten_with_paths(jstate)})
    w = np.full(4, 0.7)
    assert DivergenceGuard().check(tstate.params, w) is None
    assert jguard.DivergenceGuard().check(jstate.params, w) is None
