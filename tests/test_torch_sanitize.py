"""The runtime sanitizers in both packages: ``repro_torch.analysis`` against
``repro.analysis`` on the scenarios of ``tests/test_sanitize.py``, one port
test for each of its twelve.

Each scenario runs through the reference's guard and the port's where both
can: the readback guard (``.item()`` and the other device-to-host reads,
allowed inside ``handle.edge()``), the broadcast guard, the NaN guard, the
call-signature budgets (the port counts distinct call signatures where the
reference counts traces), in-place reuse of the carried state (the port's
``data_ptr()`` form of donation), and the acceptance contract: a warm
``EpochExecutor`` window and a warm ``BatchingRecommender`` are guard-clean
and keep one call shape.  All on the CPU, whose tensors the port's guard
checks as it checks the card's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import assert_donation as j_assert_donation
from repro.analysis import donation_report as j_donation_report
from repro.analysis import sanitize as j_sanitize
from repro.analysis import trace_counter as j_trace_counter
from repro.analysis import DonationError as JDonationError
from repro.analysis import RetraceError as JRetraceError
from repro_torch.analysis import (
    DonationError,
    RetraceError,
    TransferError,
    assert_donation,
    donation_report,
    sanitize,
    trace_counter,
)
from repro_torch.core import mf
from repro_torch.data import pipeline
from repro_torch.launch.server import BatchingRecommender
from repro_torch.train import shapes, trainer


# ---------------------------------------------------------------------------
# The three armed guards
# ---------------------------------------------------------------------------

def test_transfer_guard_blocks_implicit_host_transfer():
    a = jnp.arange(4.0)
    with pytest.raises(Exception, match="[Dd]isallowed.*transfer"):
        with j_sanitize(rank_promotion=None):
            _ = a + 1
    t = torch.arange(4.0)
    for read in (lambda x: x[1].item(), lambda x: int(x[2]),
                 lambda x: bool(x[0] > 1), lambda x: x[x > 1],
                 lambda x: torch.nonzero(x), lambda x: torch.unique(x)):
        with pytest.raises(TransferError, match="[Dd]isallowed.*transfer"):
            with sanitize(rank_promotion=None):
                read(t + 1)


def test_transfer_guard_allows_warm_calls_and_explicit_edges():
    f = jax.jit(lambda x: x * 2)
    x = jnp.arange(8.0)
    f(x)
    with j_sanitize():
        host = np.asarray(f(x))
    assert host[3] == 6.0

    def g(t):
        return t * 2

    t = torch.arange(8.0)
    g(t)
    with sanitize() as s:
        y = g(t)                         # device work: clean
        with s.edge():                   # the explicit edge: allowed
            got = y.cpu().numpy()
            v = y[3].item()
    assert got[3] == 6.0 and v == 6.0 == host[3]


def test_rank_promotion_raises_on_silent_broadcast():
    with j_sanitize(transfer=None):
        with pytest.raises(ValueError, match="broadcast"):
            jnp.ones((3,)) + jnp.ones((3, 3))
    with sanitize(transfer=None):
        with pytest.raises(ValueError, match="broadcast"):
            torch.ones((3,)) + torch.ones((3, 3))
        torch.ones((3, 3)) + torch.ones(())      # a scalar is no promotion
        torch.ones((1, 3)) + torch.ones((3, 3))  # equal ranks broadcast


def test_debug_nans_traps_at_the_producing_op():
    with pytest.raises(FloatingPointError):
        with j_sanitize(transfer=None, debug_nans=True):
            jnp.log(jnp.zeros(()) - 1.0)
    with pytest.raises(FloatingPointError, match="log"):
        with sanitize(transfer=None, debug_nans=True):
            torch.log(torch.zeros(()) - 1.0)


# ---------------------------------------------------------------------------
# Call-signature budgets
# ---------------------------------------------------------------------------

def test_trace_counter_counts_signatures_not_calls():
    jc = j_trace_counter(lambda x: x + 1, label="f", budget=1)
    jf = jax.jit(jc)
    counted = trace_counter(lambda x: x + 1, label="f", budget=1)
    for n in (4, 4):
        jf(jnp.arange(n))
        counted(torch.arange(n))
    assert counted.trace_counter.count == jc.trace_counter.count == 1
    counted.trace_counter.check()
    jf(jnp.arange(8))
    counted(torch.arange(8))             # a new shape is recorded...
    assert counted.trace_counter.count == jc.trace_counter.count == 2
    with pytest.raises(JRetraceError):
        jc.trace_counter.check()
    with pytest.raises(RetraceError):    # ...and over the budget at check
        counted.trace_counter.check()
    assert RetraceError is shapes.RetraceError


def test_sanitize_checks_adopted_counters_on_exit():
    for san, tc, err in ((j_sanitize, j_trace_counter, JRetraceError),
                         (sanitize, trace_counter, RetraceError)):
        counted = tc(lambda x: x + 1, label="f")
        f = jax.jit(counted) if san is j_sanitize else counted
        arange = jnp.arange if san is j_sanitize else torch.arange
        f(arange(4))
        with pytest.raises(err):
            with san(transfer=None, trace_budgets={"f": 1}) as s:
                s.adopt("f", counted.trace_counter)
                f(arange(8))
        with san(transfer=None, trace_budgets={"f": 2}) as s:
            s.adopt("f", counted.trace_counter)
            f(arange(8))


def test_arming_the_guards_adds_no_call_shape():
    """The reference's rank promotion is part of jit's trace-cache key, so
    arming it retraces a warm entry point once; the port has no trace
    cache, and arming every guard adds no signature."""
    jc = j_trace_counter(lambda x: x + x, label="g")
    jg = jax.jit(jc)
    jg(jnp.arange(4.0))
    with j_sanitize():
        jg(jnp.arange(4.0))
    assert jc.trace_counter.count == 2           # the reference's caveat
    counted = trace_counter(lambda x: x + x, label="g")
    counted(torch.arange(4.0))
    with sanitize(rank_promotion=None):
        counted(torch.arange(4.0))
    with sanitize(debug_nans=True):
        counted(torch.arange(4.0))
    assert counted.trace_counter.count == 1


# ---------------------------------------------------------------------------
# In-place reuse of the carried state
# ---------------------------------------------------------------------------

def test_donation_report_sees_reuse_and_copies():
    shape = (1024, 64)
    rep = j_donation_report(jax.jit(lambda x: x + 1, donate_argnums=(0,)),
                            jnp.zeros(shape))
    assert rep.ok and rep.reused == 1
    rep = donation_report(lambda x: x.add_(1), torch.zeros(shape))
    assert rep.ok and rep.reused == 1 and rep.copied == 0
    jrep = j_donation_report(jax.jit(lambda x: x + 1), jnp.zeros(shape))
    rep = donation_report(lambda x: x + 1, torch.zeros(shape))
    assert not rep.ok and rep.copied == 1 == jrep.copied
    assert rep.copied_bytes == jrep.copied_bytes == 1024 * 64 * 4
    assert "COPIED" in str(rep) and "COPIED" in str(jrep)


def test_assert_donation_raises_on_copied_carry():
    shape = (1024, 64)
    out = assert_donation(lambda x: x.add_(1), torch.zeros(shape))
    assert out.shape == shape
    with pytest.raises(DonationError, match="copied"):
        assert_donation(lambda x: x + 1, torch.zeros(shape))
    with pytest.raises(JDonationError, match="copied"):
        j_assert_donation(jax.jit(lambda x: x + 1), jnp.zeros(shape))


# ---------------------------------------------------------------------------
# The acceptance contract: hot paths are guard-clean after warm-up
# ---------------------------------------------------------------------------

def _executor(num_users=256, num_items=512, batch=32, k=4):
    ds = pipeline.synth_cf_dataset(num_users, num_items,
                                   interactions_per_user=8)
    cfg = mf.MFConfig(num_users=num_users, num_items=num_items, emb_dim=64,
                      num_negatives=8, lr=0.05)
    dds = pipeline.device_cf_dataset(ds, "cpu")
    body = mf.make_scan_body(
        cfg, lambda s: pipeline.cf_batch_device(dds, 0, s, batch,
                                                cfg.history_len), 0)
    ex = trainer.EpochExecutor(body, k, trace_budget=1)
    return ex, mf.init_mf(0, cfg, device="cpu"), k


@pytest.mark.parametrize("tile", [0, 64])
def test_epoch_executor_window_is_sanitizer_clean(tile):
    """Steady-state windows make no readback and keep one window length:
    the batches are drawn on the device, and the one readback is the
    window's losses at its edge.  ``tile=64`` adds the resident tile's
    write-through and refresh."""
    ex, state, k = _executor()
    if tile:
        cfg = mf.MFConfig(num_users=256, num_items=512, emb_dim=64,
                          num_negatives=8, lr=0.05, tile_size=tile,
                          refresh_interval=3)
        state = mf.init_mf(0, cfg, device="cpu")
        ds = pipeline.device_cf_dataset(pipeline.synth_cf_dataset(
            256, 512, interactions_per_user=8), "cpu")
        ex = trainer.EpochExecutor(mf.make_scan_body(
            cfg, lambda s: pipeline.cf_batch_device(ds, 0, s, 32), 0), k,
            trace_budget=1)
    state, _ = ex.run(state, 0, k)
    with sanitize(rank_promotion=None,
                  trace_budgets={"epoch_executor.window": 1}) as s:
        s.adopt("epoch_executor.window", ex.trace_counter)
        for w in range(1, 4):
            state, losses = ex.run(state, w * k, k)
        with s.edge():
            total = float(losses.sum())
    assert ex.trace_counter.count == 1
    assert np.isfinite(total)


def test_epoch_executor_carry_is_updated_in_place():
    """The carried tables are the window's output tables (the port's form
    of the reference's donated carry)."""
    ex, state, k = _executor()
    state, _ = ex.run(state, 0, k)
    rep = donation_report(ex.run, state, k, k, min_bytes=1 << 12)
    assert rep.ok, str(rep)
    assert rep.reused >= 2


def test_batching_recommender_serving_is_sanitizer_clean():
    """The warm serve path is guard-clean at every fill level and keeps one
    call shape; ``recommend_many`` serves on the calling thread (the guard
    is thread-local)."""
    cfg = mf.MFConfig(num_users=64, num_items=200, emb_dim=16,
                      num_negatives=8, lr=0.05)
    state = mf.init_mf(0, cfg, device="cpu")
    with BatchingRecommender(state, 10, max_batch=8,
                             max_wait_ms=1.0) as server:
        assert server.trace_count == 1
        with sanitize(rank_promotion=None,
                      trace_budgets={"batching_recommender": 1}) as s:
            s.adopt("batching_recommender", server.trace_counter)
            out = server.recommend_many(np.arange(20))
        assert out.shape == (20, 10)
        assert server.trace_count == 1
        with pytest.raises(TransferError):
            with sanitize(rank_promotion=None):
                server._recommend(torch.arange(8))[0, 0].item()
