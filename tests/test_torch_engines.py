"""The rest of the MF engine in both packages: the SimpleX and MSE baselines,
the dense update, the popularity and in-batch samplers, the dataset's item
weights and the host and procedural batches, Algorithm 1, and the LM HEAT
head with the in-batch sampler.

Inputs are made with numpy from a seed and given to both packages.  The port
cannot reproduce JAX's threefry draws, so a training step's negatives come
from a replay sampler loaded with the ids the reference's sampler drew (as
in ``tests/test_torch_mf.py``), and the samplers themselves are held to
their distributions: a chi-square bound on the empirical frequencies, zero
weights never drawn, the log-uniform ids of the same uniforms equal to the
reference's, and the same bits from the same (seed, step).  Tolerance: 1e-5
absolute in fp32 unless a test says otherwise.
"""
import dataclasses
import gc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import heat_head as jhead
from repro.core import losses as jlosses
from repro.core import mf as jmf
from repro.core import similarity as jsim
from repro.core import tiling as jtiling
from repro.data import pipeline as jpipe
from repro.train.checkpoint import _flatten_with_paths
from repro_torch import convert
from repro_torch.core import engine as teng
from repro_torch.core import heat_head as thead
from repro_torch.core import losses as tlosses
from repro_torch.core import mf as tmf
from repro_torch.core import similarity as tsim
from repro_torch.core import tiling as ttiling
from repro_torch.data import pipeline as tpipe

ATOL = 1e-5
B, N_NEG, USERS, ITEMS, K = 8, 4, 128, 256, 16


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _rows(shared=False, seed=0, t=B, n=N_NEG, k=K):
    r = np.random.default_rng(seed)
    return (r.standard_normal((t, k)).astype(np.float32),
            r.standard_normal((t, k)).astype(np.float32),
            r.standard_normal((n, k) if shared else (t, n, k)).astype(np.float32))


def _mask(t=B, seed=1):
    m = (np.random.default_rng(seed).random(t) < 0.7).astype(np.float32)
    m[0] = 0.0
    return m


def _value_and_grads(tfn, jfn, args):
    """The port's and the reference's value and gradients of all args."""
    want, want_g = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(*args)
    leaves = [x.requires_grad_() for x in _t(*args)]
    got = tfn(*leaves)
    got_g = torch.autograd.grad(got, leaves, allow_unused=True)
    return got, got_g, want, want_g


def _assert_close(got, got_g, want, want_g):
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    for g, w in zip(got_g, want_g):
        g = np.zeros_like(np.asarray(w)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)


# --------------------------------------------------------------------------
# Similarities and the baseline losses.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
def test_simplex_bmm_similarities_match_reference(shared):
    u, p, negs = _rows(shared=shared, seed=3)
    negs[0] = 0.0                         # a zero row: the EPS clip
    jfn = (jsim.simplex_bmm_similarity_shared if shared
           else jsim.simplex_bmm_similarity)
    tfn = (tsim.simplex_bmm_similarity_shared if shared
           else tsim.simplex_bmm_similarity)
    for got, want in zip(tfn(*_t(u, p, negs)), jfn(u, p, negs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cosine_similarity_matches_reference():
    u, p, negs = _rows(seed=4)
    got = tsim.cosine_similarity(*_t(u, p, negs))
    want = jsim.cosine_similarity(u, p, negs)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_ccl_loss_simplex_bmm_matches_reference(shared, masked):
    u, p, negs = _rows(shared=shared, seed=5)
    m = _mask() if masked else None
    got = _value_and_grads(
        lambda a, b, c: tlosses.ccl_loss_simplex_bmm(
            a, b, c, 1.2, 0.1, mask=None if m is None else torch.as_tensor(m)),
        lambda a, b, c: jlosses.ccl_loss_simplex_bmm(
            a, b, c, 1.2, 0.1, mask=None if m is None else jnp.asarray(m)),
        (u, p, negs))
    _assert_close(*got)
    # ... and against the fused loss, which computes the same CCL.
    fused = tlosses.ccl_loss_autodiff(*_t(u, p, negs), 1.2, 0.1,
                                      mask=None if m is None else torch.as_tensor(m))
    np.testing.assert_allclose(got[0].item(), fused.item(), atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_mse_loss_dot_matches_reference(masked):
    u, p, _ = _rows(seed=6)
    m = _mask(seed=2) if masked else None
    _assert_close(*_value_and_grads(
        lambda a, b: tlosses.mse_loss_dot(
            a, b, mask=None if m is None else torch.as_tensor(m)),
        lambda a, b: jlosses.mse_loss_dot(
            a, b, mask=None if m is None else jnp.asarray(m)),
        (u, p)))


def test_bpr_loss_matches_reference():
    _assert_close(*_value_and_grads(tlosses.bpr_loss, jlosses.bpr_loss,
                                    _rows(seed=7)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("backend", ["simplex_bmm", "mse_dot"])
def test_registered_baseline_losses_match_reference(backend, shared, masked):
    """The engine's ``simplex_bmm`` and ``mse_dot`` registrations, both
    negative layouts, with and without a mask: value and every gradient
    (mse_dot's negatives get none, a zero gradient in the reference)."""
    u, p, negs = _rows(shared=shared, seed=8)
    m = _mask(seed=9) if masked else None
    kw = dict(mu=1.0, theta=0.0, similarity="cosine")
    _assert_close(*_value_and_grads(
        lambda a, b, c: teng.LOSS_IMPLS[backend](
            a, b, c, mask=None if m is None else torch.as_tensor(m), **kw),
        lambda a, b, c: jeng.LOSS_IMPLS[backend](
            a, b, c, mask=None if m is None else jnp.asarray(m), **kw),
        (u, p, negs)))


# --------------------------------------------------------------------------
# The dense update.
# --------------------------------------------------------------------------

def _groups(seed=10, rows=40, k=K):
    """Three gradient groups with ids duplicated within and across them."""
    r = np.random.default_rng(seed)
    out = []
    for shape in ((6,), (3, 4), (5,)):
        ids = r.integers(0, rows // 4, shape).astype(np.int32)
        out.append((ids, r.standard_normal(shape + (k,)).astype(np.float32)))
    return out


def test_dense_update_matches_reference():
    table = np.random.default_rng(11).standard_normal((40, K)).astype(np.float32)
    groups = _groups()
    ids, grads = groups[1]
    want = jeng.UPDATE_IMPLS["dense"](jnp.asarray(table), ids, grads, 0.3)
    got = teng.UPDATE_IMPLS["dense"](torch.as_tensor(table.copy()),
                                     torch.as_tensor(ids).long(),
                                     torch.as_tensor(grads), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dense_update_many_writes_every_group_once():
    """All groups accumulate into one dense buffer and one write, equal to
    the reference's ``_update_dense_many`` and to the sparse update; the
    table is updated in place and untouched rows keep their bits."""
    table = np.random.default_rng(12).standard_normal((40, K)).astype(np.float32)
    groups = _groups(seed=13)
    want = jeng.UPDATE_MANY_IMPLS["dense"](
        jnp.asarray(table), [(jnp.asarray(i), jnp.asarray(g)) for i, g in groups],
        0.05)
    tgroups = [(torch.as_tensor(i).long(), torch.as_tensor(g)) for i, g in groups]
    tt = torch.as_tensor(table.copy())
    got = teng.UPDATE_MANY_IMPLS["dense"](tt, tgroups, 0.05)
    assert got is tt
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    sparse = teng.UPDATE_MANY_IMPLS["scatter_add"](torch.as_tensor(table.copy()),
                                                   tgroups, 0.05)
    np.testing.assert_allclose(got.numpy(), sparse.numpy(), atol=ATOL)
    touched = np.unique(np.concatenate([i.reshape(-1) for i, _ in groups]))
    untouched = np.setdiff1d(np.arange(40), touched)
    np.testing.assert_array_equal(got.numpy()[untouched], table[untouched])


def test_every_update_has_a_single_call_many_form():
    assert teng.UPDATE_MANY_IMPLS.keys() == teng.UPDATE_IMPLS.keys() == {
        "scatter_add", "pallas", "dense"}


# --------------------------------------------------------------------------
# One replayed training step per new engine.
# --------------------------------------------------------------------------

class ReplaySampler:
    """Returns the ids it was loaded with and records the context the step
    gave it."""

    name = "replay"
    ids = local = context = None

    def sample(self, state, gen, shape):
        assert tuple(self.ids.shape) == tuple(shape)
        self.context = state
        if self.local is None:
            return teng.NegSample(self.ids, teng.qz.gather_rows(state.table, self.ids),
                                  state)
        return teng.NegSample(self.ids, state.tile.tile_emb[self.local], state,
                              local_idx=self.local)


@pytest.fixture
def replay():
    sampler = ReplaySampler()
    teng.register_sampler("replay")(sampler)
    yield sampler
    del teng.SAMPLERS["replay"]


def _tree(state):
    return {name: np.asarray(leaf) for name, leaf in _flatten_with_paths(state)}


def _batch_np(seed=100):
    r = np.random.default_rng(seed)
    return (r.integers(0, USERS, B).astype(np.int32),
            r.integers(0, ITEMS, B).astype(np.int32))


ENGINES = [("simplex_bmm", "dense", "uniform", 0, False),
           ("simplex_bmm", "dense", "tile", 16, False),
           ("mse_dot", "scatter_add", "uniform", 0, False),
           ("mse_dot", "dense", "tile", 16, False),
           ("fused", "scatter_add", "popularity", 0, True),
           ("pallas", "pallas", "popularity", 16, False),
           ("pallas", "pallas", "in_batch", 16, False),
           ("fused", "dense", "in_batch", 0, False)]


@pytest.mark.parametrize("backend,update,sampler,tile_size,weighted", ENGINES)
def test_step_matches_reference_for_each_new_engine(backend, update, sampler,
                                                    tile_size, weighted, replay):
    """One ``heat_train_step`` from the same state: the port replays the
    negatives the reference's sampler drew (with the batch positives and,
    for popularity, the item weights in its context); loss, tables and tile
    agree to 1e-5, and the port's sampler context carries the positives and
    the weights."""
    cfg = jmf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=K,
                       num_negatives=N_NEG, tile_size=tile_size,
                       refresh_interval=1000, backend=backend,
                       update_impl=update, sampler=sampler)
    r = np.random.default_rng(14)
    weights = (np.where(r.random(ITEMS) < 0.3, 0, r.integers(1, 9, ITEMS))
               .astype(np.float32) if weighted else None)
    jstate = jmf.init_mf(jax.random.PRNGKey(0), cfg)
    tstate = convert.mf_state_from_numpy(_tree(jstate))
    users, pos = _batch_np()
    rng = jax.random.PRNGKey(1)
    jw = None if weights is None else jnp.asarray(weights)
    engine = jeng.resolve_engine(cfg)
    drawn = engine.sampler.sample(
        jeng.SampleContext(table=jstate.params.item_table, tile=jstate.tile,
                           pos_ids=jnp.asarray(pos), weights=jw),
        jax.random.split(rng)[0], (B, N_NEG))
    if weighted:
        assert not np.any(weights[np.asarray(drawn.ids)] == 0)
    jstate, jloss = jmf.heat_train_step(jstate, jmf.Batch(jnp.asarray(users),
                                                          jnp.asarray(pos)),
                                        rng, cfg, engine=engine, item_weights=jw)

    replay.ids = torch.as_tensor(np.array(drawn.ids)).long()
    replay.local = None
    tcfg = tmf.MFConfig(**dataclasses.asdict(cfg))
    tw = None if weights is None else torch.as_tensor(weights)
    tstate, tloss = tmf.heat_train_step(
        tstate, tmf.Batch(torch.as_tensor(users).long(), torch.as_tensor(pos).long()),
        0, tcfg, engine=teng.resolve_engine(tcfg, sampler="replay"), item_weights=tw)
    assert torch.equal(replay.context.pos_ids, torch.as_tensor(pos).long())
    assert replay.context.weights is tw
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL)
    want, got = _tree(jstate), convert.mf_state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, err_msg=name)


def test_train_mf_defaults_popularity_weights_to_the_dataset_counts(monkeypatch):
    """With the popularity sampler and no weights, train_mf draws from the
    dataset's interaction counts: no item without a training interaction is
    ever a negative."""
    ds = tpipe.synth_cf_dataset(64, 500, seed=2)
    seen = []
    orig = teng.PopularitySampler.sample

    def spy(self, state, gen, shape):
        out = orig(self, state, gen, shape)
        seen.append((state.weights, out.ids))
        return out

    monkeypatch.setattr(teng.PopularitySampler, "sample", spy)
    cfg = tmf.MFConfig(num_users=64, num_items=500, emb_dim=8, num_negatives=16,
                       sampler="popularity")
    from repro_torch.train import trainer
    _, losses = trainer.train_mf(cfg, ds, 4, batch_size=32, device="cpu",
                                 steps_per_dispatch=2)
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    counts = np.bincount(ds.train_pos[ds.train_pos >= 0], minlength=500)
    assert len(seen) == 4
    for w, ids in seen:
        np.testing.assert_array_equal(w.numpy(), counts.astype(np.float32))
        assert np.all(counts[ids.numpy()] > 0)


# --------------------------------------------------------------------------
# The popularity sampler.
# --------------------------------------------------------------------------

def _gen(key):
    return tmf.generator(key, "cpu")


def _chi2_bound(dof):
    """A bound the chi-square statistic exceeds with probability far below
    1e-6 (mean dof, standard deviation sqrt(2 dof))."""
    return dof + 8 * math.sqrt(2 * dof)


def _popularity(weights, n, key=0):
    table = torch.zeros(len(weights), 2)
    return teng.SAMPLERS["popularity"].sample(
        teng.SampleContext(table=table, weights=torch.as_tensor(weights)),
        _gen(key), (n,)).ids.numpy()


def test_popularity_frequencies_follow_the_weights():
    r = np.random.default_rng(15)
    w = r.integers(1, 50, 60).astype(np.float32)
    w[[0, 7, 59]] = 0.0                                   # first, middle, last
    n = 300_000
    ids = _popularity(w, n)
    counts = np.bincount(ids, minlength=len(w))
    assert counts[[0, 7, 59]].sum() == 0
    keep = w > 0
    expected = n * w[keep] / w.sum()
    chi2 = float(((counts[keep] - expected) ** 2 / expected).sum())
    assert chi2 < _chi2_bound(keep.sum() - 1), chi2


def test_popularity_logits_match_reference():
    w = np.array([0.0, 1.0, 3.0, 0.0, 1e6, -2.0], np.float32)
    np.testing.assert_array_equal(teng.popularity_logits(torch.as_tensor(w)).numpy(),
                                  np.asarray(jeng.popularity_logits(jnp.asarray(w))))


def test_zero_weights_are_unreachable_at_the_ends_of_u(monkeypatch):
    """u = 0 draws the first positive id, u just below 1 (whose product
    with the total may round up to it) the last: never a zero weight."""
    w = torch.tensor([0.0, 0.0, 2.0, 0.0, 5.0, 1.0, 0.0, 0.0])
    cdf = teng.popularity_cdf(w)
    last = torch.searchsorted(cdf, cdf[-1:])[0]
    u = torch.tensor([0.0, 1.0 - 2.0 ** -53, 0.5, 2 / 8 - 1e-12, 2 / 8],
                     dtype=torch.float64)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: u)
    ids = teng.sample_popularity(cdf, last, _gen(0), (5,))
    assert ids.tolist() == [2, 5, 4, 2, 4]
    # a u whose product rounds up to the total still lands on a positive id
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.ones(1, dtype=torch.float64))
    assert teng.sample_popularity(cdf, last, _gen(0), (1,)).tolist() == [5]


def test_popularity_draw_is_pure_in_seed_and_step():
    w = np.random.default_rng(16).integers(0, 5, 1000).astype(np.float32)
    key = tmf.fold_in(tmf.fold_in(3, 7), tmf.NEG_SALT)
    a, b = _popularity(w, 4096, key), _popularity(w, 4096, key)
    c = _popularity(w, 4096, tmf.fold_in(tmf.fold_in(3, 8), tmf.NEG_SALT))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # the CDF is rebuilt when the weights tensor changes in place
    sampler = teng.PopularitySampler()
    wt = torch.ones(10)
    ctx = teng.SampleContext(table=torch.zeros(10, 2), weights=wt)
    assert set(sampler.sample(ctx, _gen(0), (200,)).ids.tolist()) == set(range(10))
    wt[:9] = 0.0
    assert set(sampler.sample(ctx, _gen(0), (200,)).ids.tolist()) == {9}


def test_popularity_cdf_is_released_with_its_weights():
    """The sampler is a registry singleton: its cached CDF must not outlive
    the weights tensor it was built from."""
    sampler = teng.PopularitySampler()
    wt = torch.ones(10)
    ctx = teng.SampleContext(table=torch.zeros(10, 2), weights=wt)
    sampler.sample(ctx, _gen(0), (4,))
    assert sampler._cached is not None
    del ctx, wt
    gc.collect()
    assert sampler._cached is None


def test_popularity_cdf_keeps_the_weights_whose_logits_are_finite():
    w = torch.tensor([1e-45, 0.0, -1.0, 2.0, float("nan"), 3.0])   # 1e-45 first: not absorbed
    kept = torch.isfinite(teng.popularity_logits(w))
    steps = torch.diff(teng.popularity_cdf(w), prepend=torch.zeros(1, dtype=torch.float64))
    assert torch.equal(steps > 0, kept)


def test_popularity_refuses_weights_without_a_positive_entry():
    ctx = teng.SampleContext(table=torch.zeros(5, 2), weights=torch.zeros(5))
    with pytest.raises(ValueError, match="positive weight"):
        teng.SAMPLERS["popularity"].sample(ctx, _gen(0), (3,))


def test_log_uniform_fallback_is_the_reference_arithmetic():
    """On the same fp32 uniforms the port's ids equal the reference's
    ``floor(exp(u * log(I + 1))) - 1`` (one exp ulp may move an id across
    an integer: at most 1 in 1,000 ids, off by one), and without weights
    the sampler's ids follow ``P(k) = log(1 + 1/(k + 1)) / log(I + 1)``."""
    num = 1000
    u = np.random.default_rng(17).random(100_000).astype(np.float32)
    want = np.clip(np.floor(np.exp(jnp.asarray(u) * jnp.log(float(num + 1))))
                   .astype(np.int32) - 1, 0, num - 1)
    got = teng.log_uniform_ids(torch.as_tensor(u), num).numpy()
    diff = got != np.asarray(want)
    assert diff.mean() <= 1e-3 and np.all(np.abs(got - want)[diff] == 1)
    n = 400_000
    ids = teng.SAMPLERS["popularity"].sample(
        teng.SampleContext(table=torch.zeros(num, 2)), _gen(5), (n,)).ids.numpy()
    assert ids.min() >= 0 and ids.max() < num
    p = np.log1p(1.0 / (np.arange(num) + 1.0)) / np.log(num + 1.0)
    # bins of at least 1,000 expected draws: the head ids alone, the tail in groups
    edges = [0]
    while edges[-1] < num:
        e = edges[-1] + 1
        while e < num and p[edges[-1]:e].sum() * n < 1000:
            e += 1
        edges.append(e)
    obs = np.add.reduceat(np.bincount(ids, minlength=num), edges[:-1])
    exp = n * np.add.reduceat(p, edges[:-1])
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert chi2 < _chi2_bound(len(exp) - 1), chi2


# --------------------------------------------------------------------------
# The in-batch sampler.
# --------------------------------------------------------------------------

def _in_batch(pos, shape, key=0):
    table = torch.zeros(100, 2)
    return teng.SAMPLERS["in_batch"].sample(
        teng.SampleContext(table=table, pos_ids=torch.as_tensor(pos)),
        _gen(key), shape).ids


def test_in_batch_never_draws_the_rows_own_slot():
    pos = torch.randperm(100, generator=_gen(1))[:12]      # distinct positives
    ids = _in_batch(pos, (12, 500))
    assert ids.shape == (12, 500)
    assert not torch.any(ids == pos[:, None])
    assert set(ids.reshape(-1).tolist()) <= set(pos.tolist())
    # every other slot is drawn, about equally often
    for b in range(12):
        counts = np.bincount([pos.tolist().index(i) for i in ids[b].tolist()],
                             minlength=12)
        assert counts[b] == 0
        assert (np.delete(counts, b) > 0).all()


def test_in_batch_excludes_slots_not_items():
    """The exclusion is by slot: an item that is also another row's
    positive may be drawn; with B == 1 the only positive is drawn."""
    pos = torch.tensor([5, 5, 9])
    ids = _in_batch(pos, (3, 200))
    assert torch.any(ids[0] == 5) and torch.any(ids[1] == 5)
    assert torch.all(ids[2] == 5)
    assert torch.all(_in_batch(torch.tensor([42]), (1, 7)) == 42)


def test_in_batch_shared_layout_draws_from_all_positives():
    pos = torch.arange(10, 30)
    ids = _in_batch(pos, (400,))
    assert ids.shape == (400,)
    assert set(ids.tolist()) == set(pos.tolist())        # all 20, none other
    a, b = _in_batch(pos, (64,), key=3), _in_batch(pos, (64,), key=3)
    assert torch.equal(a, b)


def test_in_batch_requires_positives():
    with pytest.raises(ValueError, match="pos_ids"):
        teng.SAMPLERS["in_batch"].sample(teng.SampleContext(table=torch.zeros(4, 2)),
                                         _gen(0), (2, 3))


# --------------------------------------------------------------------------
# Datasets and batches.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("users,items,seed", [(64, 300, 3), (40, 25, 0)])
def test_item_weights_equal_the_reference_counts(users, items, seed):
    jds = jpipe.synth_cf_dataset(users, items, seed=seed)
    tds = tpipe.synth_cf_dataset(users, items, seed=seed)
    want = np.asarray(jpipe.device_cf_dataset(jds).item_weights)
    got = tpipe.device_cf_dataset(tds, "cpu").item_weights
    assert got.dtype == torch.float32 and got.shape == (items,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("history_len", [0, 3])
def test_cf_batch_equals_cf_batch_device(history_len):
    ds = tpipe.synth_cf_dataset(50, 120, seed=1)
    dds = tpipe.device_cf_dataset(ds, "cpu")
    for step in (0, 1, 17):
        a = tpipe.cf_batch(ds, step, 32, history_len, seed=4, device="cpu")
        b = tpipe.cf_batch_device(dds, 4, step, 32, history_len)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


def test_cf_batch_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.cf_batch(tpipe.synth_cf_dataset(8, 20), 0, 4)


def test_procedural_cf_batch_blocks_and_purity():
    users, items, c = 1000, 6400, 64
    block = items // c
    a = tpipe.procedural_cf_batch(3, 4096, users, items, c, seed=2, device="cpu")
    b = tpipe.procedural_cf_batch(3, 4096, users, items, c, seed=2, device="cpu")
    d = tpipe.procedural_cf_batch(4, 4096, users, items, c, seed=2, device="cpu")
    assert torch.equal(a.user_ids, b.user_ids) and torch.equal(a.pos_ids, b.pos_ids)
    assert not torch.equal(a.pos_ids, d.pos_ids)
    assert a.hist_ids is None and a.user_ids.dtype == torch.int64
    cluster = a.user_ids % c
    assert torch.all(a.pos_ids >= cluster * block)
    assert torch.all(a.pos_ids < (cluster + 1) * block)
    # power law: offsets floor(block * v^3) put half the draws in the first
    # eighth of the block, as the reference's draws do
    off = (a.pos_ids - cluster * block).numpy()
    ref = jpipe.procedural_cf_batch(3, 4096, users, items, c, seed=2)
    ref_off = np.asarray(ref.pos_ids) - (np.asarray(ref.user_ids) % c) * block
    for o in (off, ref_off):
        assert abs(np.mean(o < block / 8) - 0.5) < 0.03
    # a catalog smaller than the clusters: every positive still an item
    small = tpipe.procedural_cf_batch(0, 256, 50, 10, c, device="cpu")
    assert int(small.pos_ids.max()) <= 9


# --------------------------------------------------------------------------
# Algorithm 1.
# --------------------------------------------------------------------------

REFERENCE_HW = dict(hbm_bandwidth=819e9, link_bandwidth=50e9,
                    cache_bandwidth=6.5e12, cache_bytes=96 * 2**20,
                    peak_flops=197e12)


@pytest.mark.parametrize("items", [1000, 37_123, 400_000, 9_350_000])
@pytest.mark.parametrize("iters", [1, 500, 100_000, 10_000_000])
@pytest.mark.parametrize("shards", [1, 4, 16])
def test_tune_tiling_equals_the_reference_on_its_constants(items, iters, shards):
    """Given the reference's TPU constants, every field of the plan equals
    the reference's (the same float arithmetic, so the same bits)."""
    hw = ttiling.HardwareModel(**REFERENCE_HW)
    for kw in (dict(), dict(expected_speedup=5.0, tiles_per_core=4),
               dict(bytes_per_elem=1, positive_hit_ratio=0.9)):
        for dim in (64, 128):
            want = jtiling.tune_tiling(items, iters, 64, dim, model_shards=shards, **kw)
            got = ttiling.tune_tiling(items, iters, 64, dim, model_shards=shards,
                                      hw=hw, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_hardware_model_holds_h100_constants():
    hw = ttiling.HardwareModel()
    assert hw.hbm_bandwidth == 3.35e12 and hw.cache_bytes == 50 * 2**20
    assert hw.link_bandwidth == 450e9 and hw.peak_flops == 989e12
    # the measured L2 read rate lies between HBM's and ten times it
    assert hw.hbm_bandwidth < hw.cache_bandwidth < 10 * hw.hbm_bandwidth
    plan = ttiling.tune_tiling(400_000, 100_000, 64, 128)
    assert plan.tile_size * 128 * 4 <= hw.cache_bytes
    assert plan.t_c < plan.t_m
    assert 1 <= plan.tile_size <= plan.refresh_interval <= 100_000


# --------------------------------------------------------------------------
# The LM HEAT head with the in-batch sampler.
# --------------------------------------------------------------------------

VOCAB, HN = 64, 6


@pytest.mark.parametrize("backend", ["fused", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_heat_head_with_in_batch_sampler_matches_reference(replay, backend,
                                                           masked):
    """The head hands its targets to the sampler as the batch's positives;
    with the reference's in-batch draw replayed, loss and gradients agree
    to 1e-5, and the port's own in-batch draw takes only targets."""
    r = np.random.default_rng(18)
    hidden = r.standard_normal((2, 7, K)).astype(np.float32)
    targets = r.integers(0, VOCAB, (2, 7)).astype(np.int32)
    table = (0.1 * r.standard_normal((VOCAB, K))).astype(np.float32)
    mask = ((r.random((2, 7)) < 0.7).astype(np.float32) if masked else None)
    jcfg = jhead.HeatHeadConfig(num_negatives=HN, mu=1.1, theta=0.05,
                                backend=backend, sampler="in_batch")
    rng = jax.random.PRNGKey(21)
    drawn = jeng.SAMPLERS["in_batch"].sample(
        jeng.SampleContext(table=jnp.asarray(table),
                           pos_ids=jnp.asarray(targets.reshape(-1))),
        jax.random.split(rng)[0], (HN,))
    (want, _), want_g = jax.value_and_grad(
        lambda h, tb: jhead.sampled_ccl_loss(
            h, targets, tb, rng, jcfg, None,
            None if mask is None else jnp.asarray(mask)),
        argnums=(0, 1), has_aux=True)(hidden, table)

    replay.ids, replay.local = torch.as_tensor(np.array(drawn.ids)).long(), None
    tcfg = thead.HeatHeadConfig(*jcfg._replace(sampler="replay"))
    h, tb = (x.requires_grad_() for x in _t(hidden, table))
    tt = torch.as_tensor(targets).long()
    tm = None if mask is None else torch.as_tensor(mask)
    got, tile = thead.sampled_ccl_loss(h, tt, tb, 21, tcfg, None, tm)
    assert tile is None
    assert torch.equal(replay.context.pos_ids, tt.reshape(-1))
    got_g = torch.autograd.grad(got, (h, tb))
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)

    own = thead.HeatHeadConfig(*jcfg)
    loss, _ = thead.sampled_ccl_loss(h, tt, tb, 21, own, None, tm)
    assert math.isfinite(loss.item())
    ids = teng.SAMPLERS["in_batch"].sample(
        teng.SampleContext(table=tb, pos_ids=tt.reshape(-1)),
        tmf.generator(tmf.fold_in(21, tmf.NEG_SALT), "cpu"), (HN,)).ids
    assert set(ids.tolist()) <= set(targets.reshape(-1).tolist())


def test_lm_cli_takes_every_reference_sampler():
    """The LM head resolves every sampler of the registry (``popularity``
    without weights draws log-uniform ids over the vocab)."""
    for name in jeng.available_backends()["sampler"]:
        if name in ("tile", "auto"):
            continue
        eng = teng.resolve_engine(backend="fused", sampler=name)
        table = torch.randn(VOCAB, K)
        drawn = eng.sampler.sample(
            teng.SampleContext(table=table, pos_ids=torch.arange(5)), _gen(1), (HN,))
        assert drawn.ids.shape == (HN,) and drawn.embs.shape == (HN, K)
        assert int(drawn.ids.max()) < VOCAB


# --------------------------------------------------------------------------
# The CLI.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--backend", "simplex_bmm", "--update-impl", "dense", "--sampler", "uniform"],
    ["--backend", "mse_dot"], ["--sampler", "popularity"], ["--sampler", "in_batch"]])
def test_train_cli_runs_the_new_engines(extra, capsys):
    from repro_torch.launch import train
    train.main(["--mf", "--reduced", "--steps", "5", "--device", "cpu", *extra])
    out = capsys.readouterr().out.splitlines()
    engine = out[0].split("MF engine: ")[1].split()[0]
    assert [x for x in extra if not x.startswith("--")] == [
        p for p in engine.split("+") if p in extra]
    assert out[-1].startswith("done: 5 steps, final loss ")
    assert math.isfinite(float(out[-1].split()[-1]))
