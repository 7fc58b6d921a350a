"""The port's HEAT vocab head and its weighted CCL against the JAX package.

Inputs are made with numpy from a seed and given to both packages; the JAX
side's ``pallas`` backend runs its Pallas kernels in interpret mode, the
port's runs the kernels' plain versions on these CPU tensors.  The port
cannot reproduce JAX's threefry draws, so the head's negatives come from a
replay sampler registered for the test, loaded with the ids the reference's
sampler drew from the same key, and a tile refresh replays the reference's
new tile ids through ``samplers.sample_unique``.  Tolerance: 1e-5 absolute
in fp32, the ROADMAP's tolerance for fp32 results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import heat_head as jhead
from repro.core import losses as jlosses
from repro.core import samplers as jsam
from repro_torch.core import engine as teng
from repro_torch.core import heat_head as thead
from repro_torch.core import losses as tlosses
from repro_torch.core import samplers as tsam
from repro_torch.core import tiling
from repro_torch.kernels import ccl_similarity

ATOL = 1e-5
T, N_NEG, K, VOCAB = 24, 6, 16, 64


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _rows(t=T, n=N_NEG, k=K, seed=0, shared=True):
    r = np.random.default_rng(seed)
    negs = (n, k) if shared else (t, n, k)
    return (r.standard_normal((t, k)).astype(np.float32),
            r.standard_normal((t, k)).astype(np.float32),
            r.standard_normal(negs).astype(np.float32))


def _mask(t=T, seed=1):
    m = (np.random.default_rng(seed).random(t) < 0.7).astype(np.float32)
    m[0] = 0.0
    return m


@pytest.mark.parametrize("similarity", ["cosine", "dot"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shared", [True, False])
def test_ccl_loss_fused_w_matches_reference(shared, masked, similarity):
    u, p, negs = _rows(shared=shared)
    mask = _mask() if masked else None
    w_j = jlosses.loss_weights(None if mask is None else jnp.asarray(mask), T,
                               jnp.float32)
    want, want_g = jax.value_and_grad(
        lambda a, b, c, w: jlosses.ccl_loss_fused_w(a, b, c, w, 1.3, 0.1,
                                                    similarity),
        argnums=(0, 1, 2, 3))(u, p, negs, w_j)
    w_t = tlosses.loss_weights(None if mask is None else torch.as_tensor(mask),
                               T, torch.float32, "cpu")
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-7)
    leaves = [x.requires_grad_() for x in _t(u, p, negs, w_t.numpy())]
    loss = tlosses.ccl_loss_fused_w(*leaves, 1.3, 0.1, similarity)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want), atol=ATOL)
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    # ... and against plain autograd of the same weighted loss.
    auto = [x.detach().clone().requires_grad_() for x in leaves]
    ps, ns = tlosses._sims(tlosses.layout_stats(*auto[:3]), similarity)
    oracle = torch.sum(tlosses._ccl_rows(ps, ns, 1.3, 0.1) * auto[3])
    for g, o in zip(grads, torch.autograd.grad(oracle, auto)):
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=ATOL)


@pytest.mark.parametrize("backend", ["fused", "autodiff", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_engine_losses_take_the_shared_layout(backend, masked):
    u, p, negs = _rows(seed=2)
    mask = _mask(seed=3) if masked else None
    jfn = jeng.LOSS_IMPLS[backend]
    want, want_g = jax.value_and_grad(
        lambda a, b, c: jfn(a, b, c, mu=1.0, theta=0.0, similarity="cosine",
                            mask=None if mask is None else jnp.asarray(mask)),
        argnums=(0, 1, 2))(u, p, negs)
    leaves = [x.requires_grad_() for x in _t(u, p, negs)]
    loss = teng.LOSS_IMPLS[backend](
        *leaves, mu=1.0, theta=0.0, similarity="cosine",
        mask=None if mask is None else torch.as_tensor(mask))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want), atol=ATOL)
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_pallas_refuses_masked_per_example_negatives():
    u, p, negs = _t(*_rows(shared=False))
    with pytest.raises(ValueError, match="masked per-example"):
        teng.LOSS_IMPLS["pallas"](u, p, negs, mu=1.0, theta=0.0,
                                  similarity="cosine",
                                  mask=torch.ones(T))


def test_gather_rows_backward_sums_duplicates_in_order():
    table = torch.randn(10, 4, requires_grad=True)
    ids = torch.tensor([[3, 1, 3], [9, 3, 0]])
    g = torch.randn(2, 3, 4)
    (got,) = torch.autograd.grad(tiling.gather_rows(table, ids), table, g)
    want = torch.zeros(10, 4).index_add(0, ids.reshape(-1), g.reshape(-1, 4))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert torch.equal(tiling.gather_rows(table, ids), table[ids])


class ReplaySampler:
    """Returns the draw it was loaded with (ids, and tile slots or None),
    gathering the rows through the live table as the tile sampler does for
    an id-only tile."""

    name = "replay"
    ids = local = None

    def sample(self, state, gen, shape):
        assert tuple(self.ids.shape) == tuple(shape)
        return teng.NegSample(self.ids, tiling.gather_rows(state.table, self.ids),
                              state, local_idx=self.local)


@pytest.fixture
def replay():
    sampler = ReplaySampler()
    teng.register_sampler("replay")(sampler)
    yield sampler
    del teng.SAMPLERS["replay"]


def _head_inputs(seed=4, b=2, s=7, d=K):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, d)).astype(np.float32),
            r.integers(0, VOCAB, (b, s)).astype(np.int32),
            (0.1 * r.standard_normal((VOCAB, d))).astype(np.float32))


def _reference_head(hidden, targets, table, rng, cfg, tile, mask):
    """The reference head's loss, gradients (hidden, table) and new tile,
    and the negative ids its sampler drew and the refreshed tile ids."""
    r_neg, r_tile = jax.random.split(rng)
    drawn = jeng.SAMPLERS["tile" if tile is not None else "uniform"].sample(
        jeng.SampleContext(table=jnp.asarray(table), tile=tile), r_neg,
        (cfg.num_negatives,))

    def f(h, tb):
        return jhead.sampled_ccl_loss(h, targets, tb, rng, cfg, tile, mask)

    (loss, new_tile), grads = jax.value_and_grad(f, argnums=(0, 1),
                                                 has_aux=True)(hidden, table)
    return loss, grads, new_tile, drawn


@pytest.mark.parametrize("backend", ["fused", "autodiff", "pallas"])
@pytest.mark.parametrize("tiled,refresh", [(True, 3), (True, 1), (False, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_sampled_ccl_loss_matches_reference(replay, monkeypatch, backend,
                                            tiled, refresh, masked):
    hidden, targets, table = _head_inputs()
    jcfg = jhead.HeatHeadConfig(num_negatives=N_NEG, mu=1.2, theta=0.05,
                                tile_size=16 if tiled else 0,
                                refresh_interval=refresh, backend=backend,
                                sampler="auto")
    mask = _mask(targets.size, seed=5).reshape(targets.shape) if masked else None
    tile = None
    if tiled:
        tile = jsam.id_tile_init(jax.random.PRNGKey(9), VOCAB, 16)
        tile = tile._replace(step=jnp.asarray(1, jnp.int32))
    rng = jax.random.PRNGKey(11)
    loss, grads, new_tile, drawn = _reference_head(
        hidden, targets, table, rng, jcfg,
        tile, None if mask is None else jnp.asarray(mask))

    replay.ids = torch.as_tensor(np.array(drawn.ids), dtype=torch.int64)
    replay.local = (None if drawn.local_idx is None else
                    torch.as_tensor(np.array(drawn.local_idx),
                                    dtype=torch.int64))
    t_tile = None
    if tiled:
        t_tile = tsam.TileState(torch.as_tensor(np.array(tile.tile_ids),
                                                dtype=torch.int64), None, 1)
        refreshed = torch.as_tensor(np.array(new_tile.tile_ids),
                                    dtype=torch.int64)
        monkeypatch.setattr(tsam, "sample_unique",
                            lambda gen, num, n: refreshed)
    tcfg = thead.HeatHeadConfig(*jcfg._replace(sampler="replay"))
    h, tb = (x.requires_grad_() for x in _t(hidden, table))
    ccl_similarity.SHARED_STATS_LAUNCHES.reset()
    got, got_tile = thead.sampled_ccl_loss(
        h, torch.as_tensor(targets, dtype=torch.int64), tb, 11, tcfg, t_tile,
        None if mask is None else torch.as_tensor(mask))
    got_grads = torch.autograd.grad(got, (h, tb))
    np.testing.assert_allclose(got.item(), float(loss), atol=ATOL)
    for g, w in zip(got_grads, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert ccl_similarity.SHARED_STATS_LAUNCHES.count("cpu") == (
        backend == "pallas")
    if tiled:
        assert got_tile.step == int(new_tile.step)
        np.testing.assert_array_equal(got_tile.tile_ids.numpy(),
                                      np.asarray(new_tile.tile_ids))
        assert got_tile.tile_emb is None
    else:
        assert got_tile is None


def test_id_tile_refreshes_on_the_reference_schedule():
    gen = torch.Generator().manual_seed(0)
    tile = tsam.id_tile_init(gen, VOCAB, 16)
    jtile = jsam.id_tile_init(jax.random.PRNGKey(0), VOCAB, 16)
    assert tile.tile_emb is None and tile.step == 0
    assert torch.equal(tile.tile_ids, torch.sort(tile.tile_ids).values)
    assert len(set(tile.tile_ids.tolist())) == 16
    steps, jsteps = [], []
    for _ in range(7):
        ids = tile.tile_ids
        tile = tsam.tile_refresh(tile, gen, torch.zeros(VOCAB, 1), 3)
        jtile = jsam.tile_refresh(jtile, jax.random.PRNGKey(1),
                                  jnp.zeros((VOCAB, 1)), 3)
        steps.append(tile.step)
        jsteps.append(int(jtile.step))
        assert tile.tile_emb is None
        assert torch.equal(ids, tile.tile_ids) == (tile.step != 0)
    assert steps == jsteps == [1, 2, 0, 1, 2, 0, 1]


def test_full_softmax_loss_matches_reference():
    hidden, targets, table = _head_inputs(seed=6)
    mask = _mask(targets.size, seed=7).reshape(targets.shape)
    for m in (None, mask):
        want = jhead.full_softmax_loss(jnp.asarray(hidden), jnp.asarray(targets),
                                       jnp.asarray(table),
                                       None if m is None else jnp.asarray(m))
        got = thead.full_softmax_loss(
            *_t(hidden), torch.as_tensor(targets, dtype=torch.int64),
            *_t(table), None if m is None else torch.as_tensor(m))
        np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
