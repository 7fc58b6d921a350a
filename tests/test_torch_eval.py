"""Full-catalog evaluation in both packages: the dataset masks, the ranking
metrics, ``scores_all_items`` and the chunked ``topk_all_items``.

Inputs are made with numpy from a seed; a reference ``MFState`` is carried
into the port with ``convert.mf_state_from_numpy``.  Scores must agree to
1e-5 (the fp32 tolerance of the port's parity tests), metrics to 1e-6, and
top-k ids exactly, ties included: among equal scores the lowest item id
ranks first, as ``lax.top_k`` and ``np.argsort(-s, kind="stable")`` order
them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import metrics as jmet
from repro.core import mf as jmf
from repro.data import pipeline as jpipe
from repro.train.checkpoint import _flatten_with_paths
from repro_torch import convert
from repro_torch.core import metrics as tmet
from repro_torch.core import mf as tmf
from repro_torch.data import pipeline as tpipe

USERS, ITEMS, K = 32, 200, 16


def _states(table_format="fp32", seed=0):
    """A reference MF state and the same state in the port."""
    cfg = jmf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=K,
                       table_format=table_format)
    jstate = jmf.init_mf(jax.random.PRNGKey(seed), cfg)
    tree = {name: np.asarray(leaf) for name, leaf in _flatten_with_paths(jstate)}
    return jstate, convert.mf_state_from_numpy(tree)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------------------------------------
# Masks and metrics.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("users,items,seed", [(64, 300, 3), (40, 25, 0)])
def test_masks_match_reference(users, items, seed):
    jds = jpipe.synth_cf_dataset(users, items, seed=seed)
    tds = tpipe.synth_cf_dataset(users, items, seed=seed)
    for name in ("train_mask", "test_mask"):
        want, got = getattr(jds, name)(), getattr(tds, name)()
        assert got.dtype == bool and got.shape == (users, items)
        np.testing.assert_array_equal(got, want)


def _scores_and_masks(seed, b=9, i=40):
    """Scores on a coarse grid (ties common, -0.0 and +0.0 among them) and
    random train/test masks, with one user who has no test positive."""
    r = np.random.default_rng(seed)
    scores = np.round(r.standard_normal((b, i)), 1).astype(np.float32)
    train = r.random((b, i)) < 0.2
    test = (r.random((b, i)) < 0.15) & ~train
    test[0] = False
    return scores, train, test


@pytest.mark.parametrize("k", [1, 5, 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_reference(seed, k):
    scores, train, test = _scores_and_masks(seed)
    want_ids = jmet.topk_exclude_train(jnp.asarray(scores), jnp.asarray(train), k)
    got_ids = tmet.topk_exclude_train(torch.as_tensor(scores), torch.as_tensor(train), k)
    np.testing.assert_array_equal(_np(got_ids), np.asarray(want_ids))
    ids, tm = torch.as_tensor(np.array(want_ids)).long(), torch.as_tensor(test)
    for name in ("recall_at_k", "ndcg_at_k"):
        want = float(getattr(jmet, name)(want_ids, jnp.asarray(test)))
        got = getattr(tmet, name)(ids, tm)
        assert got.dim() == 0 and got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6, (name, float(got), want)
    want_m = jmet.evaluate_ranking(jnp.asarray(scores), jnp.asarray(train),
                                   jnp.asarray(test), k=k)
    got_m = tmet.evaluate_ranking(torch.as_tensor(scores), torch.as_tensor(train), tm, k=k)
    assert set(got_m) == set(want_m) == {f"recall@{k}", f"ndcg@{k}"}
    for key in want_m:
        assert abs(float(got_m[key]) - float(want_m[key])) <= 1e-6, key


def test_recall_hand_example():
    # user 0: test items {1, 3}; topk = [1, 2] -> recall 1/2
    # user 1: test items {0};    topk = [2, 3] -> recall 0
    test_mask = torch.tensor([[0, 1, 0, 1], [1, 0, 0, 0]], dtype=torch.bool)
    topk = torch.tensor([[1, 2], [2, 3]])
    np.testing.assert_allclose(float(tmet.recall_at_k(topk, test_mask)), (0.5 + 0.0) / 2)


def test_ndcg_hand_example():
    # hits at rank 1 only, 2 positives -> dcg = 1, idcg = 1 + 1/log2(3)
    test_mask = torch.tensor([[0, 1, 0, 1]], dtype=torch.bool)
    topk = torch.tensor([[1, 2]])
    want = 1.0 / (1.0 + 1.0 / np.log2(3.0))
    np.testing.assert_allclose(float(tmet.ndcg_at_k(topk, test_mask)), want, rtol=1e-5)


def test_topk_excludes_training_items():
    scores = torch.arange(8.0)[None, :]                 # best item = 7
    train_mask = torch.zeros((1, 8), dtype=torch.bool)
    train_mask[0, 7] = True
    ids = tmet.topk_exclude_train(scores, train_mask, 2)
    assert 7 not in ids.tolist()[0]
    assert ids.tolist() == [[6, 5]]


def test_evaluate_ranking_keys_and_ties():
    """All scores equal: only the tie rule (lowest id first) puts item 3 in
    the top 20."""
    test = torch.zeros((2, 30), dtype=torch.bool)
    test[0, 3] = True
    m = tmet.evaluate_ranking(torch.ones((2, 30)), torch.zeros((2, 30), dtype=torch.bool),
                              test, k=20)
    assert set(m) == {"recall@20", "ndcg@20"}
    assert float(m["recall@20"]) == 1.0


def test_stable_topk_ties_signed_zero_and_inf():
    """As ``lax.top_k``: ties go to the lower column, -0.0 ranks below +0.0
    (the floats' total order) and -inf last."""
    s = np.array([[0.0, -0.0, -np.inf, 1.0, -1.0, 0.0, -np.inf, 1.0, -0.0]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(s), 9)[1])
    got = tmet.stable_topk(torch.as_tensor(s), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [[3, 7, 0, 5, 1, 8, 4, 2, 6]]


# --------------------------------------------------------------------------
# Scores and the chunked top-k against the reference.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 48])
@pytest.mark.parametrize("similarity", ["cosine", "dot"])
@pytest.mark.parametrize("table_format", ["fp32", "int8"])
def test_scores_all_items_matches_reference(table_format, similarity, chunk):
    jstate, tstate = _states(table_format)
    users = np.array([0, 5, 7, 31, 2, 2, 19])
    want = jmf.scores_all_items(jstate.params, jnp.asarray(users), similarity,
                                item_chunk=chunk)
    got = tmf.scores_all_items(tstate.params, torch.as_tensor(users), similarity,
                               item_chunk=chunk)
    assert tuple(got.shape) == (len(users), ITEMS)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("table_format", ["fp32", "int8"])
@pytest.mark.parametrize("chunk", [None, 48, 9])
def test_topk_all_items_matches_reference(chunk, table_format):
    jstate, tstate = _states(table_format, seed=1)
    users = np.arange(6)
    excl = np.random.default_rng(0).integers(0, 2, (6, ITEMS)).astype(bool)
    want = jmf.topk_all_items(jstate.params, jnp.asarray(users), 10, item_chunk=chunk,
                              exclude_mask=jnp.asarray(excl))
    got = tmf.topk_all_items(tstate.params, torch.as_tensor(users), 10, item_chunk=chunk,
                             exclude_mask=torch.as_tensor(excl))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # ... and the port's own dense route, through the stable top-k
    scores = tmf.scores_all_items(tstate.params, torch.as_tensor(users), item_chunk=chunk)
    dense = tmet.stable_topk(torch.where(torch.as_tensor(excl), float("-inf"), scores), 10)
    np.testing.assert_array_equal(_np(got), _np(dense))


@pytest.mark.parametrize("chunk", [None, 48, 9, 500])
def test_topk_rows_with_few_unmasked_items(chunk):
    """Rows with fewer than k unmasked items: padded with id 0 on the
    chunked path, with the lowest masked ids on the dense path — id for id
    as the reference returns them."""
    jstate, tstate = _states(seed=2)
    users = np.arange(4)
    excl = np.zeros((4, ITEMS), bool)
    excl[0] = True                                   # nothing left
    excl[1, :] = True
    excl[1, [3, 77, 150]] = False                    # three left
    excl[2, 50:] = True                              # fifty left
    want = jmf.topk_all_items(jstate.params, jnp.asarray(users), 10, item_chunk=chunk,
                              exclude_mask=jnp.asarray(excl))
    got = tmf.topk_all_items(tstate.params, torch.as_tensor(users), 10, item_chunk=chunk,
                             exclude_mask=torch.as_tensor(excl))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert set(_np(got)[1, :3]) == {3, 77, 150}
    dense = chunk is None or chunk >= ITEMS
    assert _np(got)[0].tolist() == (list(range(10)) if dense else [0] * 10)


def test_topk_clamps_k_and_metrics_match_dense_route():
    """k above the catalog is clamped; Recall/NDCG from the chunked top-k
    equal those of the dense ``evaluate_ranking`` on ``scores_all_items``."""
    _, tstate = _states(seed=3)
    assert tuple(tmf.topk_all_items(tstate.params, torch.arange(3), ITEMS + 7,
                                    item_chunk=64).shape) == (3, ITEMS)
    ds = tpipe.synth_cf_dataset(USERS, ITEMS, seed=4)
    train, test = torch.as_tensor(ds.train_mask()), torch.as_tensor(ds.test_mask())
    users = torch.arange(USERS)
    ids = tmf.topk_all_items(tstate.params, users, 20, item_chunk=48, exclude_mask=train)
    dense = tmet.evaluate_ranking(tmf.scores_all_items(tstate.params, users), train, test)
    assert abs(float(tmet.recall_at_k(ids, test)) - float(dense["recall@20"])) <= 1e-6
    assert abs(float(tmet.ndcg_at_k(ids, test)) - float(dense["ndcg@20"])) <= 1e-6


@settings(max_examples=40, deadline=None)
@given(num_items=st.integers(3, 40), chunk=st.integers(1, 50),
       k=st.integers(1, 60), seed=st.integers(0, 10_000))
def test_topk_chunked_bit_identical_to_stable_argsort(num_items, chunk, k, seed):
    """The reference's draw space (tests/test_mf.py): integer embeddings
    scored with ``similarity="dot"`` give exact, frequent ties (and a planted
    duplicate item row one for sure); chunks that do not divide the catalog,
    chunks past it (the dense path) and k past it (the clamp)."""
    r = np.random.default_rng(seed)
    dim, n_users = 4, 5
    items = r.integers(-2, 3, (num_items, dim)).astype(np.float32)
    items[num_items // 2] = items[0]
    users = r.integers(-2, 3, (n_users, dim)).astype(np.float32)
    params = tmf.MFParams(torch.as_tensor(users), torch.as_tensor(items), None)
    want = np.argsort(-(users @ items.T), axis=1, kind="stable")[:, :min(k, num_items)]
    got = tmf.topk_all_items(params, torch.arange(n_users), k, similarity="dot",
                             item_chunk=chunk)
    assert tuple(got.shape) == (n_users, min(k, num_items))
    np.testing.assert_array_equal(_np(got), want)


def test_eval_state_from_a_port_config():
    """The port's own init gives a state the evaluation takes (fp32 and
    int8) and no gradient is recorded."""
    for fmt in ("fp32", "int8"):
        cfg = tmf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=K,
                           table_format=fmt)
        state = tmf.init_mf(0, dataclasses.replace(cfg), device="cpu")
        ids = tmf.topk_all_items(state.params, torch.arange(4), 5, item_chunk=33)
        assert tuple(ids.shape) == (4, 5) and not ids.requires_grad
        assert int(ids.min()) >= 0 and int(ids.max()) < ITEMS
