"""Top-k serving in both packages: the tile-pruned retrieval index
(``core/retrieval.py``), the request-batching server (``launch/server.py``)
and the int8 serving helpers of ``optim/quantization.py``.

The cases mirror ``tests/test_retrieval.py`` and ``tests/test_serving.py``
on the port, and hold it against the reference on the same inputs (made
with numpy from a seed, or a reference ``MFState`` carried over with
``convert``): member ids equal, centroids to 1e-5, top-k ids equal.  Where
the reference counts jit traces, the port counts distinct padded call
shapes (``trace_count``), which must stay 1.  Two cases are the port's own:
the server serves a snapshot of the tables, so training the source state in
place changes nothing served until the next refresh; and a refresh that
fails degrades the server (or raises, on request).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mf as jmf
from repro.core import retrieval as jret
from repro.launch.server import BatchingRecommender as JServer
from repro.optim import quantization as jqz
from repro.train.checkpoint import _flatten_with_paths
from repro_torch import convert
from repro_torch.core import mf
from repro_torch.core import retrieval
from repro_torch.data import pipeline
from repro_torch.launch.server import BatchingRecommender, RetraceError
from repro_torch.optim import quantization as qz
from repro_torch.train import trainer

NUM_USERS, NUM_ITEMS, DIM = 64, 500, 16   # 500 % 128 != 0: padded last tile


def _arrays(seed=0, num_items=NUM_ITEMS, clustered=False):
    r = np.random.default_rng(seed)
    if clustered:
        centers = r.normal(size=(8, DIM)).astype(np.float32)
        ic = r.integers(0, 8, num_items)
        uc = r.integers(0, 8, NUM_USERS)
        items = centers[ic] + 0.3 * r.normal(size=(num_items, DIM))
        users = centers[uc] + 0.3 * r.normal(size=(NUM_USERS, DIM))
    else:
        items = r.normal(size=(num_items, DIM))
        users = r.normal(size=(NUM_USERS, DIM))
    return users.astype(np.float32), items.astype(np.float32)


def _params(seed=0, **kw):
    """(port params, reference params) of the same tables."""
    users, items = _arrays(seed, **kw)
    return (mf.MFParams(torch.as_tensor(users), torch.as_tensor(items), None),
            jmf.MFParams(jnp.asarray(users), jnp.asarray(items), None))


def _recall(got, want):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                          for a, b in zip(np.asarray(got), np.asarray(want))]))


def _indexes(tp, jp, tile_rows=128):
    return (retrieval.build_retrieval_index(tp.item_table, tile_rows=tile_rows),
            jret.build_retrieval_index(jp.item_table, tile_rows=tile_rows))


# --------------------------------------------------------------------------
# Retrieval (tests/test_retrieval.py, port against reference).
# --------------------------------------------------------------------------

@pytest.mark.parametrize("clustered,tile_rows", [(False, 128), (True, 128), (True, 32)])
def test_index_partition_invariants(clustered, tile_rows):
    """member_ids is a fixed-size partition (every item once, -1 only in the
    trailing padding), centroids unit-norm, and both equal the reference's
    index of the same table."""
    tp, jp = _params(1, clustered=clustered)
    idx, jidx = _indexes(tp, jp, tile_rows)
    ids = idx.member_ids.numpy()
    tiles = -(-NUM_ITEMS // tile_rows)
    assert ids.shape == (tiles, tile_rows) and idx.member_ids.dtype == torch.int64
    assert sorted(ids[ids >= 0].tolist()) == list(range(NUM_ITEMS))
    assert (ids < 0).sum() == tiles * tile_rows - NUM_ITEMS
    assert (ids.reshape(-1)[:NUM_ITEMS] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(idx.centroids.numpy(), axis=1), 1.0,
                               atol=1e-5)
    np.testing.assert_array_equal(ids, np.asarray(jidx.member_ids))
    np.testing.assert_allclose(idx.centroids.numpy(), np.asarray(jidx.centroids),
                               atol=1e-5)


def test_full_expansion_parity_with_exact_topk():
    tp, jp = _params()
    idx, jidx = _indexes(tp, jp)
    users = torch.arange(32)
    want = mf.topk_all_items(tp, users, 10, item_chunk=96).numpy()
    got = retrieval.topk_pruned(tp, users, 10, idx, expand_tiles=idx.num_tiles).numpy()
    assert got.shape == want.shape
    for g, w in zip(got, want):
        assert set(g.tolist()) == set(w.tolist())
    assert _recall(got, want) == 1.0
    ref = jret.topk_pruned(jp, jnp.arange(32), 10, jidx, expand_tiles=jidx.num_tiles)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_full_expansion_parity_with_exclusion():
    tp, jp = _params(seed=3)
    idx, jidx = _indexes(tp, jp)
    excl = np.random.default_rng(0).integers(0, 2, (16, NUM_ITEMS)).astype(bool)
    users = torch.arange(16)
    want = mf.topk_all_items(tp, users, 8, item_chunk=64,
                             exclude_mask=torch.as_tensor(excl)).numpy()
    got = retrieval.topk_pruned(tp, users, 8, idx, expand_tiles=idx.num_tiles,
                                exclude_mask=torch.as_tensor(excl)).numpy()
    for g, w, e in zip(got, want, excl):
        assert set(g.tolist()) == set(w.tolist())
        assert not e[g].any()
    ref = jret.topk_pruned(jp, jnp.arange(16), 8, jidx, expand_tiles=jidx.num_tiles,
                           exclude_mask=jnp.asarray(excl))
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_partial_expansion_recall_on_clustered_embeddings():
    tp, jp = _params(seed=1, clustered=True)
    idx, jidx = _indexes(tp, jp, tile_rows=32)
    users = torch.arange(NUM_USERS)
    want = mf.topk_all_items(tp, users, 10)
    rec4 = retrieval.topk_pruned(tp, users, 10, idx, expand_tiles=4)
    rec_full = retrieval.topk_pruned(tp, users, 10, idx, expand_tiles=idx.num_tiles)
    assert _recall(rec4, want) >= 0.8
    assert _recall(rec_full, want) == 1.0
    np.testing.assert_array_equal(
        rec4.numpy(), np.asarray(jret.topk_pruned(jp, jnp.arange(NUM_USERS), 10, jidx,
                                                  expand_tiles=4)))


def test_k_clamp_and_padding_slots_return_minus_one():
    tp, jp = _params(seed=2, num_items=70)      # 70 items, 2 tiles of 64
    idx, jidx = _indexes(tp, jp, tile_rows=64)
    got = retrieval.topk_pruned(tp, torch.arange(5), 999, idx,
                                expand_tiles=idx.num_tiles).numpy()
    assert got.shape == (5, 2 * 64)
    for row in got:
        assert sorted(row[row >= 0].tolist()) == list(range(70))
        assert (row[70:] == -1).all()
    ref = jret.topk_pruned(jp, jnp.arange(5), 999, jidx, expand_tiles=jidx.num_tiles)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_topk_pruned_never_returns_padding_when_k_fits():
    tp, jp = _params()
    idx, _ = _indexes(tp, jp)
    got = retrieval.topk_pruned(tp, torch.arange(16), 10, idx, expand_tiles=2).numpy()
    assert (got >= 0).all() and (got < NUM_ITEMS).all()


def test_refresh_index_recenters_from_live_table():
    tp, jp = _params()
    idx, jidx = _indexes(tp, jp)
    new_table = tp.item_table + 0.5
    ref = retrieval.refresh_index(idx, new_table)
    assert torch.equal(ref.member_ids, idx.member_ids)
    tbl = new_table.numpy().astype(np.float64)
    ids = idx.member_ids.numpy()
    for t in range(idx.num_tiles):
        rows = tbl[ids[t][ids[t] >= 0]]
        rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
        want = rows.mean(axis=0)
        np.testing.assert_allclose(ref.centroids[t].numpy(), want / np.linalg.norm(want),
                                   atol=1e-5)
    assert not np.allclose(ref.centroids.numpy(), idx.centroids.numpy())
    jref = jret.refresh_index(jidx, jp.item_table + 0.5)
    np.testing.assert_allclose(ref.centroids.numpy(), np.asarray(jref.centroids),
                               atol=1e-5)


def test_build_refresh_agree_on_fresh_table():
    tp, jp = _params()
    idx, _ = _indexes(tp, jp)
    again = retrieval.refresh_index(idx, tp.item_table)
    assert torch.equal(again.centroids, idx.centroids)


def test_topk_pruned_is_shape_stable_and_deterministic():
    """One candidate layout for every request of a batch size: the same
    shapes for other users, the same ids on a repeat, and an int8 table
    served through the same path."""
    tp, jp = _params()
    idx, _ = _indexes(tp, jp)
    a = retrieval.topk_pruned(tp, torch.arange(8), 10, idx, expand_tiles=2)
    b = retrieval.topk_pruned(tp, torch.arange(8, 16), 10, idx, expand_tiles=2)
    assert a.shape == b.shape == (8, 10)
    assert torch.equal(a, retrieval.topk_pruned(tp, torch.arange(8), 10, idx,
                                                expand_tiles=2))
    q = mf.MFParams(tp.user_table, qz.quantize_table(tp.item_table), None)
    qidx = retrieval.build_retrieval_index(q.item_table, tile_rows=128)
    assert retrieval.topk_pruned(q, torch.arange(8), 10, qidx, expand_tiles=2).shape == (8, 10)


def test_bad_args_raise():
    tp, jp = _params()
    idx, _ = _indexes(tp, jp)
    with pytest.raises(ValueError):
        retrieval.topk_pruned(tp, torch.arange(4), 10, idx, expand_tiles=0)
    with pytest.raises(ValueError):
        retrieval.build_retrieval_index(tp.item_table, tile_rows=0)


# --------------------------------------------------------------------------
# The server (tests/test_serving.py, port against reference).
# --------------------------------------------------------------------------

USERS, ITEMS, K = 64, 200, 10


def _cfg():
    return jmf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=16,
                        num_negatives=8, lr=0.05)


def _states(seed=0):
    """(port state, reference state) of the same fresh model."""
    jstate = jmf.init_mf(jax.random.PRNGKey(seed), _cfg())
    tree = {n: np.asarray(x) for n, x in _flatten_with_paths(jstate)}
    return convert.mf_state_from_numpy(tree), jstate


def _direct(state, uid, *, index=None, expand_tiles=None, excl=None):
    uids = torch.as_tensor([uid])
    e = None if excl is None else excl[uids]
    if index is not None:
        out = retrieval.topk_pruned(state.params, uids, K, index,
                                    expand_tiles=expand_tiles, exclude_mask=e)
    else:
        out = mf.topk_all_items(state.params, uids, K, exclude_mask=e)
    return set(out[0].tolist())


@pytest.mark.parametrize("pruner", ["exact", "tile"])
def test_warmup_gives_one_call_shape_and_serving_keeps_it(pruner):
    state, _ = _states()
    index = (retrieval.build_retrieval_index(state.params.item_table, tile_rows=32)
             if pruner == "tile" else None)
    with BatchingRecommender(state, K, pruner=pruner, index=index, expand_tiles=3,
                             max_batch=8, max_wait_ms=1.0) as server:
        assert server.trace_count == 1
        for uid in (0, 5, 9):
            server.recommend(uid)
        server.recommend_many(np.arange(20))          # 3 calls, padded last chunk
        assert server.trace_count == 1
        assert server.stats["traces"] == 1


@pytest.mark.parametrize("pruner", ["exact", "tile"])
def test_batched_results_match_direct_and_reference(pruner):
    """Coalescing and padding are invisible: every answer equals the direct
    single-user top-k and the reference server's answer on the same
    tables."""
    state, jstate = _states()
    index = jindex = None
    if pruner == "tile":
        index = retrieval.build_retrieval_index(state.params.item_table, tile_rows=32)
        jindex = jret.build_retrieval_index(jstate.params.item_table, tile_rows=32)
    expand = index.num_tiles if index is not None else 8
    uids = [0, 3, 7, 11, 63]
    with BatchingRecommender(state, K, pruner=pruner, index=index, expand_tiles=expand,
                             max_batch=8, max_wait_ms=1.0) as server:
        got = server.recommend_many(uids)
    assert got.shape == (5, K)
    for uid, row in zip(uids, got):
        assert set(row.tolist()) == _direct(state, uid, index=index, expand_tiles=expand)
    with JServer(jstate, K, pruner=pruner, index=jindex, expand_tiles=expand,
                 max_batch=8, max_wait_ms=1.0) as jserver:
        want = jserver.recommend_many(uids)
    np.testing.assert_array_equal(got, want)


def test_concurrent_requests_are_coalesced():
    state, _ = _states()
    server = BatchingRecommender(state, K, max_batch=8, max_wait_ms=50.0)
    n, results = 32, {}
    lock = threading.Lock()

    def client(uid):
        out = server.recommend(uid)
        with lock:
            results[uid] = out

    threads = [threading.Thread(target=client, args=(uid,)) for uid in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    stats = server.stats
    server.stop()
    assert stats["requests_served"] == n
    assert stats["device_calls"] < n
    assert stats["traces"] == 1
    for uid in range(n):
        assert set(results[uid].tolist()) == _direct(state, uid)


def test_refresh_from_swaps_tables_without_a_new_shape():
    s1, _ = _states(0)
    s2, _ = _states(1)
    index = retrieval.build_retrieval_index(s1.params.item_table, tile_rows=32)
    with BatchingRecommender(s1, K, pruner="tile", index=index,
                             expand_tiles=index.num_tiles, max_batch=4,
                             max_wait_ms=1.0) as server:
        before = set(server.recommend(7).tolist())
        assert before == _direct(s1, 7, index=index, expand_tiles=index.num_tiles)
        assert server.refresh_from(s2)
        after = set(server.recommend(7).tolist())
        assert server.trace_count == 1
        want_index = retrieval.refresh_index(index, s2.params.item_table)
        assert after == _direct(s2, 7, index=want_index, expand_tiles=index.num_tiles)
        assert after != before
        assert server.health == {"status": "ok", "refreshes": 1, "refresh_failures": 0,
                                 "stale_refreshes": 0, "last_refresh_error": None}


def test_exclude_mask_filters_served_results():
    state, _ = _states()
    excl = torch.as_tensor(np.random.default_rng(0).integers(0, 2, (USERS, ITEMS))
                           .astype(bool))
    with BatchingRecommender(state, K, max_batch=4, max_wait_ms=1.0,
                             exclude_mask=excl) as server:
        for uid in (2, 40):
            got = server.recommend(uid)
            assert not excl[uid][got].any()
            assert set(got.tolist()) == _direct(state, uid, excl=excl)


def test_lazy_warmup_counts_the_first_call():
    state, _ = _states()
    with BatchingRecommender(state, K, max_batch=4, max_wait_ms=1.0,
                             warmup=False) as server:
        assert server.trace_count == 0
        server.recommend(1)
        assert server.trace_count == 1
        server.recommend(2)
        assert server.trace_count == 1


def test_constructor_validates_args():
    state, _ = _states()
    with pytest.raises(ValueError):
        BatchingRecommender(state, K, pruner="annoy")
    with pytest.raises(ValueError):
        BatchingRecommender(state, K, pruner="tile")


def test_a_second_call_shape_raises():
    state, _ = _states()
    with BatchingRecommender(state, K, max_batch=4, max_wait_ms=1.0) as server:
        with pytest.raises(RetraceError):
            server._call(np.zeros(5, np.int64))


def test_serving_a_snapshot_training_in_place_changes_nothing_served():
    """The port's step updates the tables in place: the server holds its own
    copy, so training the source state further leaves the answers as they
    were until the next refresh_from, which then serves the trained
    tables."""
    cfg = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=16, num_negatives=8,
                      lr=2.0, tile_size=32, refresh_interval=8)
    ds = pipeline.synth_cf_dataset(USERS, ITEMS, seed=1)
    state, _ = trainer.train_mf(cfg, ds, 4, batch_size=32, device="cpu",
                                steps_per_dispatch=4)
    users = np.arange(USERS)
    server = BatchingRecommender(state, K, max_batch=16, max_wait_ms=1.0)
    before = server.recommend_many(users)
    table_before = state.params.item_table.clone()
    dds = pipeline.device_cf_dataset(ds, "cpu")
    executor = trainer.EpochExecutor(mf.make_scan_body(
        cfg, lambda s: pipeline.cf_batch_device(dds, 0, s, 32), 0), 8)
    trained, _ = executor.run(state, 4, 8)
    assert trained.params.item_table is state.params.item_table      # in place
    assert not torch.equal(table_before, trained.params.item_table)
    np.testing.assert_array_equal(server.recommend_many(users), before)
    assert server.refresh_from(trained)
    after = server.recommend_many(users)
    want = mf.topk_all_items(trained.params, torch.as_tensor(users), K).numpy()
    np.testing.assert_array_equal(after, want)
    assert not np.array_equal(after, before)
    server.stop()


def test_a_failed_refresh_degrades_or_raises():
    s1, _ = _states(0)
    s2, _ = _states(1)
    logs = []
    with BatchingRecommender(s1, K, max_batch=4, max_wait_ms=1.0,
                             log=logs.append) as server:
        before = server.recommend_many([3, 9])
        bad = mf.MFState(mf.MFParams(s2.params.user_table[:10], s2.params.item_table,
                                     None), None, None, 0)
        assert not server.refresh_from(bad)
        h = server.health
        assert h["status"] == "degraded" and h["refresh_failures"] == 1
        assert h["stale_refreshes"] == 1 and h["last_refresh_error"].startswith("ValueError")
        assert len(logs) == 1 and "previous snapshot" in logs[0]
        np.testing.assert_array_equal(server.recommend_many([3, 9]), before)
        int8 = mf.MFState(mf.MFParams(qz.quantize_table(s2.params.user_table),
                                      s2.params.item_table, None), None, None, 0)
        with pytest.raises(ValueError, match="refusing the swap"):
            server.refresh_from(int8, on_error="raise")
        assert server.health["stale_refreshes"] == 1        # raise counts nothing
        with pytest.raises(ValueError):
            server.refresh_from(s2, on_error="ignore")
        assert server.refresh_from(s2)
        assert server.health["status"] == "ok" and server.health["refreshes"] == 1
        assert server.stats["traces"] == 1


# --------------------------------------------------------------------------
# The int8 serving helpers.
# --------------------------------------------------------------------------

def _tables(fmt, rows=37, k=8, seed=20):
    x = np.random.default_rng(seed).standard_normal((rows, k)).astype(np.float32)
    if fmt == "fp32":
        return torch.as_tensor(x), jnp.asarray(x)
    t = qz.quantize_table(torch.as_tensor(x))
    j = jqz.QuantizedTable(*(jnp.asarray(a.numpy()) for a in t))
    return t, j


def _leaves(t):
    return list(t) if isinstance(t, (qz.QuantizedTable, jqz.QuantizedTable)) else [t]


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_pad_rows_matches_reference(fmt):
    t, j = _tables(fmt)
    for pad in (0, 5):
        got, want = qz.pad_rows(t, pad), jqz.pad_rows(j, pad)
        assert (isinstance(got, qz.QuantizedTable)
                == isinstance(want, jqz.QuantizedTable) == (fmt == "int8"))
        for g, w in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        rows = qz.dequantize_table(got).numpy()
        assert rows.shape == (37 + pad, 8)
        np.testing.assert_array_equal(rows[37:], 0.0)


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_dynamic_slice_rows_matches_reference(fmt):
    t, j = _tables(fmt)
    for start, count in ((0, 5), (10, 8), (35, 5), (-3, 4), (-40, 4), (100, 37)):
        got = qz.dynamic_slice_rows(t, start, count)
        want = jqz.dynamic_slice_rows(j, start, count)
        assert got.shape == (count, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_table_spec_matches_reference_leaves():
    """The leaves' shapes and dtypes read as the reference's; the structure
    tells fp32 from int8 and a pair from a single table, as the
    reference's does."""
    specs = {}
    for fmt in ("fp32", "int8"):
        t, j = _tables(fmt)
        got, want = qz.table_spec((t, t)), jqz.table_spec((j, j))
        assert got[1] == want[1]
        hash(got)
        specs[fmt] = got
    assert specs["fp32"] != specs["int8"]
    t, _ = _tables("fp32")
    assert qz.table_spec((t, t)) != qz.table_spec(t)
    assert qz.table_spec((t, t)) != qz.table_spec((t, t[:5]))
    assert qz.table_spec((t, t)) == qz.table_spec((t.clone(), t + 1))


# --------------------------------------------------------------------------
# The serve CLI.
# --------------------------------------------------------------------------

def test_serve_cli_trains_serves_with_both_pruners_and_refreshes(capsys):
    """Both pruners serve; the last server is then refreshed by the
    reference's two warm-started streaming rounds (16 trained steps + 2 x
    25 streaming steps) with its call shape unchanged."""
    from repro_torch.launch import serve
    serve.main(["--mf", "--device", "cpu", "--train-steps", "16"])
    out = capsys.readouterr().out
    for pruner in ("exact", "tile"):
        assert f"[serve] {pruner}: 256 concurrent requests" in out
        assert f"[serve] {pruner}: top-10 for user" in out
    assert out.count("call shapes 1)") == 3
    assert ("[serve] tile: after 2 streaming rounds (512 live events, 66 "
            "total steps, health ok, call shapes 1)") in out
    assert "wait for ROADMAP.md A.3" not in out


def test_serve_cli_without_mf_names_the_roadmap_item(capsys):
    """Without ``--mf`` the launcher serves the LM, the audio family too
    (which once waited for its ROADMAP.md item, A.6): reduced whisper with
    zero frames prints the three lines; an unknown architecture is
    refused by name."""
    from repro_torch.launch import serve
    serve.main(["--arch", "whisper-medium", "--device", "cpu",
                "--decode-steps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith("prefill: 4x16 tokens in ")
    assert lines[2].startswith("generated ids[0]: ")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "no-such-model", "--device", "cpu"])
    assert "unknown architecture" in capsys.readouterr().err


def test_serve_cli_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--mf"])
