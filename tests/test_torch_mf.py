"""One HEAT MF training step in both packages, from the same state.

A reference ``MFState`` is carried into the port with
``convert.mf_state_from_numpy``.  The port cannot reproduce JAX's threefry
draws, so its negatives come from a replay sampler registered for the test,
which returns the ids (and tile slots) the reference sampler drew; a tile
refresh gets the reference's new tile ids the same way, and an int8 step
gets the reference's stochastic-rounding noise (``jax.random.uniform`` of
its two rounding keys, recorded as the reference step draws it) through the
port's ``uniform_noise``.  Loss, fp32 tables, the tile, the aggregator and
its accumulator must agree to 1e-5; int8 tables to the tolerance of
``tests/test_torch_quantization.py`` (scales 1e-6 relative, dequantized rows
within one quantization step, payloads equal on 99.9% of elements), their
residuals within one residual quantization step.  The
matrix covers backend x update x sampler, both tile branches (slot-reduced
when N1 <= B*n, per-sample otherwise), both table formats and behavior
aggregation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import engine as jeng
from repro.core import losses as jlosses
from repro.core import mf as jmf
from repro.core import samplers as jsam
from repro.optim import quantization as jqz
from repro.train.checkpoint import _flatten_with_paths
from repro_torch import convert
from repro_torch.configs import heat_mf as tcfgs
from repro_torch.core import aggregation as tagg
from repro_torch.core import engine as teng
from repro_torch.core import losses as tlosses
from repro_torch.core import mf as tmf
from repro_torch.core import samplers as tsam
from repro_torch.optim import quantization as tqz

ATOL = 1e-5
B, N_NEG, USERS, ITEMS, K, H = 8, 4, 128, 256, 16, 3
INT8_LEAVES = ("q", "scale", "err", "err_scale")


class ReplaySampler:
    """Returns the draw it was loaded with (ids, and tile slots or None)."""

    name = "replay"
    ids = local = None

    def sample(self, state, gen, shape):
        assert tuple(self.ids.shape) == tuple(shape)
        if self.local is None:
            return teng.NegSample(self.ids, tqz.gather_rows(state.table, self.ids),
                                  state)
        return teng.NegSample(self.ids, state.tile.tile_emb[self.local], state,
                              local_idx=self.local)


@pytest.fixture
def replay():
    sampler = ReplaySampler()
    teng.register_sampler("replay")(sampler)
    yield sampler
    del teng.SAMPLERS["replay"]


def _cfg(backend, update, sampler, tile_size, refresh=1000, **kw):
    return jmf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=K,
                        num_negatives=N_NEG, tile_size=tile_size,
                        refresh_interval=refresh, backend=backend,
                        update_impl=update, sampler=sampler, **kw)


def _tree(state):
    return {name: np.asarray(leaf) for name, leaf in _flatten_with_paths(state)}


def _batch(step, history_len=0):
    """(users, positives, history ids, history mask) as numpy; padded
    history slots point at item 0, as the pipeline makes them."""
    r = np.random.default_rng(100 + step)
    users = r.integers(0, USERS, B).astype(np.int32)
    pos = r.integers(0, ITEMS, B).astype(np.int32)
    if not history_len:
        return users, pos, None, None
    mask = (r.random((B, history_len)) < 0.7).astype(np.float32)
    mask[0] = 0.0                                     # a user with no history
    hist = np.where(mask > 0, r.integers(0, ITEMS, (B, history_len)), 0)
    return users, pos, hist.astype(np.int32), mask


@pytest.fixture
def noise(monkeypatch):
    """Records the reference step's stochastic-rounding noise and replays it
    into the port's ``uniform_noise`` in the same order."""
    draws = []
    orig = jqz.stochastic_round

    def recording(x, rng):
        draws.append(np.array(jax.random.uniform(rng, x.shape, dtype=x.dtype)))
        return orig(x, rng)

    def replaying(gen, shape, device):
        u = draws.pop(0)
        assert tuple(shape) == u.shape
        return torch.as_tensor(u, device=device)

    monkeypatch.setattr(jqz, "stochastic_round", recording)
    monkeypatch.setattr(tqz, "uniform_noise", replaying)
    yield draws
    assert not draws, "a recorded draw was not replayed"


def _reference_step(state, batch_np, rng, cfg):
    """The reference step, plus the draws the port must replay."""
    engine = jeng.resolve_engine(cfg)
    r_neg, r_tile = jax.random.split(rng)
    batch = jmf.Batch(*(None if x is None else jnp.asarray(x) for x in batch_np))
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


def _port_step(state, batch_np, cfg, drawn, refresh_ids, replay,
               monkeypatch):
    replay.ids = torch.as_tensor(np.array(drawn.ids)).long()
    replay.local = (None if drawn.local_idx is None
                    else torch.as_tensor(np.array(drawn.local_idx)).long())
    if refresh_ids is not None:
        ids = torch.as_tensor(np.array(refresh_ids)).long()
        monkeypatch.setattr(tsam, "sample_unique", lambda gen, num, n: ids)
    cfg = tmf.MFConfig(**dataclasses.asdict(cfg))
    engine = teng.resolve_engine(cfg, sampler="replay")
    users, pos, hist, mask = batch_np
    batch = tmf.Batch(torch.as_tensor(users).long(), torch.as_tensor(pos).long(),
                      None if hist is None else torch.as_tensor(hist).long(),
                      None if mask is None else torch.as_tensor(mask))
    return tmf.heat_train_step(state, batch, 0, cfg, engine=engine)


def _assert_int8_close(got, want, prefix):
    """The int8 tolerance of tests/test_torch_quantization.py for the
    payload; the residual is the rounding error of the update, so it
    inherits the fp32 rounding differences of the two packages' gradients:
    the dequantized residuals agree within one residual quantization
    step."""
    t = {f: (got[f"{prefix}/{f}"], want[f"{prefix}/{f}"]) for f in INT8_LEAVES}
    np.testing.assert_allclose(*t["scale"], rtol=1e-6, err_msg=prefix)
    same = np.mean(t["q"][0] == t["q"][1])
    assert same >= 0.999, (prefix, same)
    deq = [q.astype(np.float32) * s for q, s in zip(t["q"], t["scale"])]
    assert np.all(np.abs(deq[0] - deq[1]) <= t["scale"][1] * (1 + 1e-6)), prefix
    res = [e.astype(np.float32) * s for e, s in zip(t["err"], t["err_scale"])]
    assert np.all(np.abs(res[0] - res[1]) <= 1.01 * t["err_scale"][1]), prefix


def _assert_same(jstate, jloss, tstate, tloss):
    np.testing.assert_allclose(tloss.item(), jloss, atol=ATOL)
    want = _tree(jstate)
    got = convert.mf_state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        if name in ("tile/tile_ids", "tile/step", "accum/count", "step"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        elif name.rsplit("/", 1)[-1] in INT8_LEAVES:
            if name.endswith("/q"):
                _assert_int8_close(got, want, name[:-2])
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
    batch = _batch(0)
    jstate, jloss, drawn, refresh_ids = _reference_step(
        jstate, batch, jax.random.PRNGKey(1), cfg)
    tstate, tloss = _port_step(tstate, batch, cfg, drawn, refresh_ids,
                               replay, monkeypatch)
    _assert_same(jstate, jloss, tstate, tloss)


@pytest.mark.parametrize("history_len", [0, H])
@pytest.mark.parametrize("sampler", ["uniform", "tile"])
@pytest.mark.parametrize("backend", ["fused", "pallas"])
@pytest.mark.parametrize("table_format", ["fp32", "int8"])
def test_step_matches_reference_over_format_and_history(
        table_format, backend, sampler, history_len, replay, noise,
        monkeypatch):
    """One replayed step over {fp32, int8} x {fused, pallas} x {uniform,
    tile} x history {0, 3}; int8 + pallas gathers through the gather-dequant
    kernel (its plain version here, Pallas interpret mode in the
    reference)."""
    update = "pallas" if backend == "pallas" else "scatter_add"
    cfg = _cfg(backend, update, sampler, 16, history_len=history_len,
               table_format=table_format)
    jstate = jmf.init_mf(jax.random.PRNGKey(0), cfg)
    tstate = convert.mf_state_from_numpy(_tree(jstate))
    batch = _batch(0, history_len)
    jstate, jloss, drawn, refresh_ids = _reference_step(
        jstate, batch, jax.random.PRNGKey(1), cfg)
    assert len(noise) == (2 if table_format == "int8" else 0)
    tstate, tloss = _port_step(tstate, batch, cfg, drawn, refresh_ids,
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
    _three_steps(_cfg(backend, update, sampler, tile_size, refresh=2),
                 replay, monkeypatch)


def _three_steps(cfg, replay, monkeypatch):
    jstate = jmf.init_mf(jax.random.PRNGKey(3), cfg)
    tstate = convert.mf_state_from_numpy(_tree(jstate))
    base = jax.random.PRNGKey(11)
    tile_ids = [np.asarray(jstate.tile.tile_ids)]
    for step in range(3):
        batch = _batch(step, cfg.history_len)
        jstate, jloss, drawn, refresh_ids = _reference_step(
            jstate, batch, jax.random.fold_in(base, step), cfg)
        tstate, tloss = _port_step(tstate, batch, cfg, drawn,
                                   refresh_ids, replay, monkeypatch)
        _assert_same(jstate, jloss, tstate, tloss)
        tile_ids.append(np.asarray(jstate.tile.tile_ids))
    assert not np.array_equal(tile_ids[1], tile_ids[2])     # refreshed once
    assert np.array_equal(tile_ids[2], tile_ids[3])


@pytest.mark.parametrize("backend,sampler", [("pallas", "tile"),
                                             ("fused", "uniform")])
def test_three_int8_steps_with_refresh(backend, sampler, replay, noise,
                                       monkeypatch):
    """Three consecutive int8 steps with history; the tile is redrawn from
    the requantized int8 table in the second step."""
    update = "pallas" if backend == "pallas" else "scatter_add"
    _three_steps(_cfg(backend, update, sampler, 16, refresh=2, history_len=H,
                      table_format="int8"), replay, monkeypatch)


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


@pytest.mark.parametrize("extra", [{}, dict(table_format="int8", history_len=H),
                                   dict(history_len=H,
                                        aggregation_kind="self_attn")])
def test_convert_round_trip(extra):
    cfg = _cfg("fused", "scatter_add", "auto", 16, **extra)
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


@pytest.mark.parametrize("field,name", [("backend", "nope")])
def test_unported_names_raise_reference_error(field, name):
    """A name neither package has raises the same ValueError in both,
    listing the registry (which is the reference's)."""
    prefix = f"unknown {field} {name!r}; available: "
    with pytest.raises(ValueError) as ours:
        teng.resolve_engine(None, **{field: name})
    assert str(ours.value) == prefix + str(sorted(
        teng.available_backends()[field]))
    with pytest.raises(ValueError) as theirs:
        jeng.resolve_engine(None, **{field: name})
    assert str(theirs.value) == str(ours.value)


#: every name of the reference's registries: 5 losses, 3 row updates and 5
#: samplers.
REFERENCE_NAMES = [(field, name)
                   for field, names in jeng.available_backends().items()
                   for name in names]


@pytest.mark.parametrize("field,name", REFERENCE_NAMES)
def test_every_reference_name_resolves_in_the_port(field, name):
    engine = teng.resolve_engine(None, **{field: name})
    attr = {"backend": "backend", "update_impl": "update_impl",
            "sampler": "sampler_name"}[field]
    assert getattr(engine, attr) == name
    assert engine.name.split("+")[("backend", "update_impl", "sampler").index(field)] == name


def test_registries_equal_the_reference():
    assert len(REFERENCE_NAMES) == 13
    assert teng.available_backends() == jeng.available_backends()


@pytest.mark.parametrize("entry", ["init_mf", "resolve_engine"])
def test_unknown_table_format_raises_reference_error(entry):
    """An unknown table_format raises the reference's ValueError, word for
    word, in both entry points."""
    cfg = _cfg("fused", "scatter_add", "auto", 0, table_format="int4")
    calls = {"init_mf": (lambda c: jmf.init_mf(jax.random.PRNGKey(0), c),
                         lambda c: tmf.init_mf(0, c, device="cpu")),
             "resolve_engine": (jeng.resolve_engine, teng.resolve_engine)}
    theirs, ours = calls[entry]
    with pytest.raises(ValueError) as want:
        theirs(cfg)
    with pytest.raises(ValueError) as got:
        ours(tmf.MFConfig(**dataclasses.asdict(cfg)))
    assert str(got.value) == str(want.value)
    assert "table_format" in str(got.value)


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
        batch = tmf.Batch(*(torch.as_tensor(x).long() for x in _batch(0)[:2]))
        state, loss = tmf.heat_train_step(state, batch, key, cfg)
        outs.append((loss, state))
    (l0, s0), (l1, s1), (l2, s2) = outs
    assert torch.equal(l0, l1)
    assert torch.equal(s0.params.item_table, s1.params.item_table)
    assert torch.equal(s0.tile.tile_ids, s1.tile.tile_ids)
    assert not torch.equal(s0.tile.tile_ids, s2.tile.tile_ids)


def _agg_inputs(kind, seed=0, b=6, h=4, k=8):
    r = np.random.default_rng(seed)
    user = r.standard_normal((b, k)).astype(np.float32)
    hist = r.standard_normal((b, h, k)).astype(np.float32)
    mask = (r.random((b, h)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 1.0
    w = (r.standard_normal((k, k)) / np.sqrt(k)).astype(np.float32)
    q = ((r.standard_normal((k, k)) / np.sqrt(k)).astype(np.float32)
         if kind != "avg" else None)
    return user, hist, mask, w, q


@pytest.mark.parametrize("kind", ["avg", "self_attn", "user_attn"])
def test_aggregate_and_gradients_match_reference(kind):
    """The fused user and its gradients with respect to the user row, the
    history rows and the aggregator weights, at 1e-5."""
    user, hist, mask, w, q = _agg_inputs(kind)
    cot = np.random.default_rng(1).standard_normal(user.shape).astype(np.float32)

    def jfn(params, u, hh):
        out = jagg.aggregate(params, u, hh, jnp.asarray(mask), gate=0.3, kind=kind)
        return jnp.sum(out * cot), out

    jparams = jagg.AggregatorParams(jnp.asarray(w),
                                    None if q is None else jnp.asarray(q))
    (_, want), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jparams, jnp.asarray(user), jnp.asarray(hist))
    leaves = [torch.as_tensor(x).requires_grad_() for x in (user, hist, w)]
    tq = None if q is None else torch.as_tensor(q).requires_grad_()
    out = tagg.aggregate(tagg.AggregatorParams(leaves[2], tq), leaves[0],
                         leaves[1], torch.as_tensor(mask), gate=0.3, kind=kind)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATOL)
    jp, ju, jh = jgrads
    for got, ref in ((leaves[0], ju), (leaves[1], jh), (leaves[2], jp.w)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=ATOL)
    if q is not None:
        np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jp.attn_q),
                                   atol=ATOL)


def _bits(t):
    """A float32 tensor's bits, so that signs of zero count."""
    return t.detach().contiguous().view(torch.int32)


def _plain_aggregate(params, user_emb, hist_emb, hist_mask, gate, kind):
    """``aggregate``'s formulas with autograd's own backward of each
    product (the ``avg`` pooling through the plain einsum)."""
    denom = hist_mask.sum(-1, keepdim=True).clamp_min(1.0)
    if kind == "avg":
        pooled = torch.einsum("bhk,bh->bk", hist_emb, hist_mask) / denom
    elif kind == "self_attn":
        scores = torch.einsum("bhk,kq,bjq->bhj", hist_emb, params.attn_q,
                              hist_emb)
        scores = torch.where(hist_mask[:, None, :] > 0, scores, -1e9)
        attn = torch.softmax(scores / np.sqrt(hist_emb.shape[-1]), dim=-1)
        ctx = torch.einsum("bhj,bjk->bhk", attn, hist_emb)
        pooled = torch.einsum("bhk,bh->bk", ctx, hist_mask) / denom
    else:
        scores = torch.einsum("bk,kq,bhq->bh", user_emb, params.attn_q,
                              hist_emb)
        scores = torch.where(hist_mask > 0, scores, -1e9)
        attn = torch.softmax(scores / np.sqrt(hist_emb.shape[-1]), dim=-1)
        pooled = torch.einsum("bh,bhk->bk", attn, hist_emb)
    return gate * user_emb + (1.0 - gate) * (pooled @ params.w)


@pytest.mark.parametrize("b,h,k", [(6, 4, 8), (5, 100, 128)])
@pytest.mark.parametrize("rows", ["mixed", "all_padding", "all_filled"])
def test_avg_history_gradient_is_row_major_with_the_plain_bits(rows, b, h, k):
    """The ``avg`` pooling's history gradient comes out row-major, so the
    row update's ``reshape(-1, K)`` is a view, and holds the bits of
    autograd through the plain einsum (signs of zero included), as do the
    output and the other gradients.  ``mixed`` has a row of padding only,
    a filled row and partly filled rows."""
    user, hist, mask, w, _ = _agg_inputs("avg", seed=4, b=b, h=h, k=k)
    if rows != "mixed":
        mask[:] = 0.0 if rows == "all_padding" else 1.0
    cot = torch.as_tensor(
        np.random.default_rng(5).standard_normal(user.shape).astype(np.float32))
    got, want = [], []
    for fn, out in ((tagg.aggregate, got), (_plain_aggregate, want)):
        leaves = [torch.as_tensor(x).requires_grad_() for x in (user, hist, w)]
        fused = fn(tagg.AggregatorParams(leaves[2]), leaves[0], leaves[1],
                   torch.as_tensor(mask), gate=0.3, kind="avg")
        out.extend([fused, *torch.autograd.grad((fused * cot).sum(), leaves)])
    g_hist = got[2]
    assert g_hist.is_contiguous()
    assert g_hist.reshape(-1, k).data_ptr() == g_hist.data_ptr()
    for name, a, e in zip(("out", "user", "hist", "w"), got, want):
        assert torch.equal(_bits(a), _bits(e)), name


@pytest.mark.parametrize("kind", ["avg", "self_attn", "user_attn"])
def test_loss_and_grads_give_the_plain_history_gradient(kind):
    """``loss_and_grads`` on an int8 model with history: every gradient
    and the loss hold the bits of autograd through the plain formulas, and
    the ``avg`` history gradient reaches the row update row-major."""
    cfg = tmf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=K,
                       num_negatives=N_NEG, history_len=H,
                       aggregation_kind=kind, table_format="int8")
    state = tmf.init_mf(0, cfg, device="cpu")
    users, pos, hist, mask = (torch.as_tensor(x) for x in _batch(0, H))
    negs = torch.as_tensor(
        np.random.default_rng(6).integers(0, ITEMS, (B, N_NEG)))
    p = state.params
    rows = [tqz.gather_rows(p.user_table, users.long()),
            tqz.gather_rows(p.item_table, pos.long()),
            tqz.gather_rows(p.item_table, negs),
            tqz.gather_rows(p.item_table, hist.long())]
    engine = teng.resolve_engine(cfg)
    loss, grads, agg_grads = tmf.loss_and_grads(rows, p.aggregator, mask, cfg,
                                                engine)
    leaves = [t.detach().requires_grad_() for t in rows]
    agg_leaves = [t.detach().requires_grad_() for t in p.aggregator
                  if t is not None]
    plain = _plain_aggregate(tagg.AggregatorParams(*agg_leaves), leaves[0],
                             leaves[3], mask, cfg.gate, kind)
    want_loss = engine.loss_fn(plain, leaves[1], leaves[2], mu=cfg.mu,
                               theta=cfg.theta, similarity=cfg.similarity)
    want = torch.autograd.grad(want_loss, leaves + agg_leaves)
    got = list(grads) + [g for g in agg_grads if g is not None]
    assert torch.equal(_bits(loss), _bits(want_loss))
    assert len(got) == len(want)
    for i, (a, e) in enumerate(zip(got, want)):
        assert torch.equal(_bits(a), _bits(e)), i
    if kind == "avg":
        assert grads[3].is_contiguous()


def test_aggregate_refuses_unknown_kind():
    user, hist, mask, w, _ = _agg_inputs("avg")
    with pytest.raises(ValueError, match="unknown aggregation kind"):
        tagg.aggregate(tagg.AggregatorParams(torch.as_tensor(w)),
                       torch.as_tensor(user), torch.as_tensor(hist),
                       torch.as_tensor(mask), kind="max")


@pytest.mark.parametrize("kind", ["avg", "user_attn"])
def test_maybe_flush_matches_reference_over_two_intervals(kind):
    """2 * flush_every steps of accumulate + maybe_flush from the same
    weights and gradients: weights and accumulator agree after every step,
    and the weights move exactly at the flushes."""
    flush_every, lr = 3, 0.2
    _, _, _, w, q = _agg_inputs(kind, seed=2)
    jp = jagg.AggregatorParams(jnp.asarray(w), None if q is None else jnp.asarray(q))
    tp = tagg.AggregatorParams(torch.as_tensor(w),
                               None if q is None else torch.as_tensor(q))
    ja, ta = jagg.accumulator_init(jp), tagg.accumulator_init(tp)
    r = np.random.default_rng(3)
    moved = []
    for _ in range(2 * flush_every):
        g = [r.standard_normal(w.shape).astype(np.float32) for _ in range(2)]
        jg = jagg.AggregatorParams(jnp.asarray(g[0]),
                                   None if q is None else jnp.asarray(g[1]))
        tg = tagg.AggregatorParams(torch.as_tensor(g[0]),
                                   None if q is None else torch.as_tensor(g[1]))
        before = tp.w
        jp, ja = jagg.maybe_flush(jagg.accumulate(ja, jg), jp, lr, flush_every)
        tp, ta = tagg.maybe_flush(tagg.accumulate(ta, tg), tp, lr, flush_every)
        moved.append(not torch.equal(before, tp.w))
        assert ta.count == int(ja.count)
        for got, want in zip(list(tp) + list(ta.grad_sum), list(jp) + list(ja.grad_sum)):
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert moved == [False, False, True] * 2


@pytest.mark.parametrize("kind", ["avg", "self_attn"])
def test_init_aggregator_shapes(kind):
    p = tagg.init_aggregator(torch.Generator().manual_seed(0), 8, kind)
    assert p.w.shape == (8, 8)
    assert (p.attn_q is None) == (kind == "avg")
    acc = tagg.accumulator_init(p)
    assert acc.count == 0 and torch.all(acc.grad_sum.w == 0)
    assert (acc.grad_sum.attn_q is None) == (kind == "avg")
