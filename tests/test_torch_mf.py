"""One HEAT MF training step in both packages, from the same state.

A reference ``MFState`` is carried into the port with
``convert.mf_state_from_numpy``.  The port cannot reproduce JAX's threefry
draws, so its negatives come from a replay sampler registered for the test,
which returns the ids (and tile slots) the reference sampler drew; a tile
refresh gets the reference's new tile ids the same way.  Loss, both tables,
and the tile must agree to 1e-5 (fp32), over backend x update x sampler and
both tile branches (slot-reduced when N1 <= B*n, per-sample otherwise).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import losses as jlosses
from repro.core import mf as jmf
from repro.core import samplers as jsam
from repro.train.checkpoint import _flatten_with_paths
from repro_torch import convert
from repro_torch.configs import heat_mf as tcfgs
from repro_torch.core import engine as teng
from repro_torch.core import losses as tlosses
from repro_torch.core import mf as tmf
from repro_torch.core import samplers as tsam

ATOL = 1e-5
B, N_NEG, USERS, ITEMS, K = 8, 4, 128, 256, 16


class ReplaySampler:
    """Returns the draw it was loaded with (ids, and tile slots or None)."""

    name = "replay"
    ids = local = None

    def sample(self, state, gen, shape):
        assert tuple(self.ids.shape) == tuple(shape)
        if self.local is None:
            return teng.NegSample(self.ids, state.table[self.ids], state)
        return teng.NegSample(self.ids, state.tile.tile_emb[self.local], state,
                              local_idx=self.local)


@pytest.fixture
def replay():
    sampler = ReplaySampler()
    teng.register_sampler("replay")(sampler)
    yield sampler
    del teng.SAMPLERS["replay"]


def _cfg(backend, update, sampler, tile_size, refresh=1000):
    return jmf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=K,
                        num_negatives=N_NEG, tile_size=tile_size,
                        refresh_interval=refresh, backend=backend,
                        update_impl=update, sampler=sampler)


def _tree(state):
    return {name: np.asarray(leaf) for name, leaf in _flatten_with_paths(state)}


def _batch(step):
    r = np.random.default_rng(100 + step)
    return (r.integers(0, USERS, B).astype(np.int32),
            r.integers(0, ITEMS, B).astype(np.int32))


def _reference_step(state, users, pos, rng, cfg):
    """The reference step, plus the draws the port must replay."""
    engine = jeng.resolve_engine(cfg)
    r_neg, r_tile = jax.random.split(rng)
    batch = jmf.Batch(jnp.asarray(users), jnp.asarray(pos))
    drawn = engine.sampler.sample(
        jeng.SampleContext(table=state.params.item_table, tile=state.tile,
                           pos_ids=batch.pos_ids), r_neg, (B, N_NEG))
    refresh_ids = None
    if state.tile is not None:
        refresh_ids = jsam.sample_unique(r_tile, ITEMS,
                                         state.tile.tile_ids.shape[0])
    new_state, loss = jmf.heat_train_step(state, batch, rng, cfg,
                                          engine=engine)
    return new_state, float(loss), drawn, refresh_ids


def _port_step(state, users, pos, cfg, drawn, refresh_ids, replay,
               monkeypatch):
    replay.ids = torch.as_tensor(np.array(drawn.ids)).long()
    replay.local = (None if drawn.local_idx is None
                    else torch.as_tensor(np.array(drawn.local_idx)).long())
    if refresh_ids is not None:
        ids = torch.as_tensor(np.array(refresh_ids)).long()
        monkeypatch.setattr(tsam, "sample_unique", lambda gen, num, n: ids)
    cfg = tmf.MFConfig(**dataclasses.asdict(cfg))
    engine = teng.resolve_engine(cfg, sampler="replay")
    batch = tmf.Batch(torch.as_tensor(users).long(), torch.as_tensor(pos).long())
    return tmf.heat_train_step(state, batch, 0, cfg, engine=engine)


def _assert_same(jstate, jloss, tstate, tloss):
    np.testing.assert_allclose(tloss.item(), jloss, atol=ATOL)
    want = _tree(jstate)
    got = convert.mf_state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for name in want:
        if name in ("tile/tile_ids", "tile/step", "step"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name], atol=ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("tile_size", [16, 64])          # <= B*n=32 and > B*n
@pytest.mark.parametrize("sampler", ["uniform", "tile"])
@pytest.mark.parametrize("update", ["scatter_add", "pallas"])
@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_heat_train_step_matches_reference(backend, update, sampler, tile_size,
                                           replay, monkeypatch):
    cfg = _cfg(backend, update, sampler, tile_size)
    jstate = jmf.init_mf(jax.random.PRNGKey(0), cfg)
    tstate = convert.mf_state_from_numpy(_tree(jstate))
    users, pos = _batch(0)
    jstate, jloss, drawn, refresh_ids = _reference_step(
        jstate, users, pos, jax.random.PRNGKey(1), cfg)
    tstate, tloss = _port_step(tstate, users, pos, cfg, drawn, refresh_ids,
                               replay, monkeypatch)
    _assert_same(jstate, jloss, tstate, tloss)


@pytest.mark.parametrize("backend,update,sampler,tile_size", [
    ("pallas", "pallas", "tile", 16),
    ("fused", "scatter_add", "auto", 64),
    ("pallas", "scatter_add", "uniform", 16),
])
def test_three_replayed_steps_with_refresh(backend, update, sampler, tile_size,
                                           replay, monkeypatch):
    """Three consecutive steps; refresh_interval=2 redraws the tile in the
    second step, so the third samples from the refreshed tile."""
    cfg = _cfg(backend, update, sampler, tile_size, refresh=2)
    jstate = jmf.init_mf(jax.random.PRNGKey(3), cfg)
    tstate = convert.mf_state_from_numpy(_tree(jstate))
    base = jax.random.PRNGKey(11)
    tile_ids = [np.asarray(jstate.tile.tile_ids)]
    for step in range(3):
        users, pos = _batch(step)
        jstate, jloss, drawn, refresh_ids = _reference_step(
            jstate, users, pos, jax.random.fold_in(base, step), cfg)
        tstate, tloss = _port_step(tstate, users, pos, cfg, drawn,
                                   refresh_ids, replay, monkeypatch)
        _assert_same(jstate, jloss, tstate, tloss)
        tile_ids.append(np.asarray(jstate.tile.tile_ids))
    assert not np.array_equal(tile_ids[1], tile_ids[2])     # refreshed once
    assert np.array_equal(tile_ids[2], tile_ids[3])


@pytest.mark.parametrize("similarity", ["cosine", "dot"])
@pytest.mark.parametrize("mu,theta", [(1.0, 0.0), (1.5, 0.2)])
def test_losses_match_reference(similarity, mu, theta):
    """``ccl_loss_fused`` (residual-reuse backward) and ``ccl_loss_autodiff``
    against the reference's custom-VJP loss: value and all three
    gradients."""
    r = np.random.default_rng(9)
    args = [r.standard_normal(s).astype(np.float32)
            for s in ((B, K), (B, K), (B, N_NEG, K))]
    want, want_g = jax.value_and_grad(
        lambda u, p, n: jlosses.ccl_loss_fused(u, p, n, mu, theta, similarity),
        argnums=(0, 1, 2))(*args)
    for loss_fn in (tlosses.ccl_loss_fused, tlosses.ccl_loss_autodiff):
        leaves = [torch.as_tensor(a).requires_grad_() for a in args]
        loss = loss_fn(*leaves, mu, theta, similarity)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want), atol=ATOL)
        for leaf, w in zip(leaves, want_g):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                       atol=ATOL)


def test_convert_round_trip():
    cfg = _cfg("fused", "scatter_add", "auto", 16)
    tree = _tree(jmf.init_mf(jax.random.PRNGKey(0), cfg))
    state = convert.mf_state_from_numpy(tree)
    assert state.tile.tile_ids.dtype == torch.int64
    back = convert.mf_state_to_numpy(state)
    assert sorted(back) == sorted(tree)
    for name in tree:
        np.testing.assert_array_equal(back[name], tree[name], err_msg=name)
        assert back[name].dtype == tree[name].dtype, name


def test_configs_match_reference():
    from repro.configs import heat_mf as jcfgs
    for name in ("AMAZON", "MF_100M", "MF_100M_PALLAS"):
        assert (dataclasses.asdict(getattr(tcfgs, name))
                == dataclasses.asdict(getattr(jcfgs, name))), name
    assert ([(f.name, f.default) for f in dataclasses.fields(tmf.MFConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jmf.MFConfig)])


@pytest.mark.parametrize("field,name,in_reference", [
    ("backend", "nope", False), ("backend", "simplex_bmm", True),
    ("update_impl", "dense", True), ("sampler", "popularity", True)])
def test_unported_names_raise_reference_error(field, name, in_reference):
    """Names the port lacks raise the reference's ValueError, listing what
    the port has; a name neither package has reads the same in both."""
    prefix = f"unknown {field} {name!r}; available: "
    with pytest.raises(ValueError) as ours:
        teng.resolve_engine(None, **{field: name})
    assert str(ours.value) == prefix + str(sorted(
        teng.available_backends()[field]))
    if not in_reference:
        with pytest.raises(ValueError) as theirs:
            jeng.resolve_engine(None, **{field: name})
        assert str(theirs.value).startswith(prefix)


def test_unported_config_features_raise():
    for over in (dict(table_format="int8"), dict(history_len=4)):
        cfg = dataclasses.replace(_cfg("fused", "scatter_add", "auto", 0),
                                  **over)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmf.init_mf(0, cfg, device="cpu")


def test_pallas_backend_refuses_dot_similarity():
    cfg = dataclasses.replace(_cfg("pallas", "pallas", "auto", 0),
                              similarity="dot")
    with pytest.raises(ValueError, match="cosine similarity only"):
        teng.resolve_engine(cfg)


def test_step_is_pure_in_seed_and_step():
    """Same state, batch and key -> the same bits; another key -> another
    draw."""
    cfg = _cfg("pallas", "pallas", "tile", 16, refresh=1)
    outs = []
    for key in (5, 5, 6):
        state = tmf.init_mf(0, cfg, device="cpu")
        batch = tmf.Batch(*(torch.as_tensor(x).long() for x in _batch(0)))
        state, loss = tmf.heat_train_step(state, batch, key, cfg)
        outs.append((loss, state))
    (l0, s0), (l1, s1), (l2, s2) = outs
    assert torch.equal(l0, l1)
    assert torch.equal(s0.params.item_table, s1.params.item_table)
    assert torch.equal(s0.tile.tile_ids, s1.tile.tile_ids)
    assert not torch.equal(s0.tile.tile_ids, s2.tile.tile_ids)
