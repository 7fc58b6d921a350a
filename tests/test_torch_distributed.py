"""Sharded MF training over ``torch.distributed``: gloo ranks on the CPU,
started by ``launch/mesh.py::run_ranks`` (one ``spawn``ed process a rank, a
``FileStore`` under the test's temporary directory, one thread a rank).

The reference's own sharded tests (``tests/test_multidevice.py``) cannot run
on the installed jax, so the port is held to their stated contract and to
the reference's single-device step:

* one replayed step (the reference's ids, as in ``tests/test_torch_mf.py``)
  through the port's sharded step at data=2 and at (data=2, model=2), whole
  state and loss within 1e-5 of the reference's single-device
  ``heat_train_step``;
* sharded ``train_mf`` against the single-device port run, within 1e-5 at
  every step and in the final state: fused, autodiff and pallas at data=4,
  (data=2, model=2) with uniform and with tile negatives (the refresh reads
  the model-sharded table), ``self_attn`` history flushed every 3 steps, an
  uneven batch of 52 over 4 ranks, and at data=2 ``avg`` history written
  through to a tile;
* sharded against sharded, bit for bit: a crash mid-window resumed from the
  window-edge checkpoint, and every rank's gathered state;
* elastic checkpoints: saved by 2 ranks and trained on by 1, and the other
  way round;
* ``topk_pruned`` on sharded tables: ids bit-identical to the single-device
  call; ``compressed_psum`` over a pod axis of 2 within 0.05 of the exact
  sum, its error feedback carried across calls; the exchanges exact;
* the CLI's ``devices=`` and ``done:`` lines, and ``run_ranks`` failing fast
  with a rank's traceback.

The rank bodies below are module-level functions, so a spawned rank imports
this module by name; it imports no jax at module level (the reference runs
in the test process only).
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))   # for the ranks

from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import mf  # noqa: E402
from repro_torch.core import mf_distributed as mfd  # noqa: E402
from repro_torch.core import retrieval  # noqa: E402
from repro_torch.core import samplers as tsam  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import ccl_similarity, embedding_update  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_data_mesh,
    make_host_mesh,
    run_ranks,
)
from repro_torch.optim import compression  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
USERS, ITEMS, DIM, BATCH = 256, 512, 16, 64
ATOL = 1e-5
TIMEOUT = 240.0
#: one replayed step (the sizes of tests/test_torch_mf.py)
RB, RN, RU, RI, RK = 8, 4, 128, 256, 16
REPLAY_CASES = [("fused", "uniform", 0, 1000), ("fused", "tile", 16, 1000),
                ("pallas", "uniform", 16, 1000), ("pallas", "tile", 16, 1000),
                ("pallas", "tile", 64, 1000), ("fused", "tile", 16, 1)]
REPLAY_IDS = ["-".join(map(str, c)) for c in REPLAY_CASES]
#: data=4 runs of tests/test_multidevice.py's matrix
MATRIX = {"fused": dict(backend="fused"), "autodiff": dict(backend="autodiff"),
          "pallas": dict(backend="pallas", update_impl="pallas")}
TILE = dict(tile_size=32, refresh_interval=5)
SELF_ATTN = dict(backend="fused", history_len=4, aggregation_kind="self_attn",
                 flush_every=3)
#: history rows written through to the tile: refresh at step 5, flushes at 3
#: and 6
HIST_TILE = dict(backend="fused", history_len=4, aggregation_kind="avg",
                 flush_every=3, **TILE)
MESH22 = {"uniform": dict(backend="fused"),
          "tile": dict(backend="pallas", update_impl="pallas", **TILE)}
CRASH = dict(backend="fused", **TILE)


def _cfg(**kw):
    base = dict(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                num_negatives=8, lr=0.05)
    base.update(kw)
    return mf.MFConfig(**base)


def _ds():
    return pipeline.synth_cf_dataset(USERS, ITEMS, interactions_per_user=8)


def _tree(state) -> dict:
    return {n: (x.numpy().copy() if isinstance(x, torch.Tensor) else x)
            for n, x in ckpt.named_leaves(state)}


def _train(kw, mesh=None, *, steps=12, k=4, batch=BATCH, **tkw):
    """``train_mf`` on the CPU; the whole final state (gathered under a
    mesh) as numpy, and the losses."""
    cfg = _cfg(**kw)
    tkw.setdefault("log", lambda *_: None)
    state, losses = trainer.train_mf(cfg, _ds(), steps, batch_size=batch,
                                     steps_per_dispatch=k, mesh=mesh,
                                     device="cpu", **tkw)
    if mesh is not None:
        state = mfd.make_sharding_plan(cfg, mesh).gather_state(state)
    return _tree(state), losses


def _assert_close(got, want, atol=ATOL):
    tree, losses = got
    want_tree, want_losses = want
    np.testing.assert_allclose(losses, want_losses, atol=atol, rtol=0)
    assert sorted(tree) == sorted(want_tree)
    for name in want_tree:
        np.testing.assert_allclose(np.asarray(tree[name], np.float64),
                                   np.asarray(want_tree[name], np.float64),
                                   atol=atol, rtol=0, err_msg=name)


def _assert_same(got, want):
    (tree, losses), (want_tree, want_losses) = got, want
    assert losses == want_losses
    assert sorted(tree) == sorted(want_tree)
    for name in want_tree:
        np.testing.assert_array_equal(tree[name], want_tree[name],
                                      err_msg=name)


def _launches():
    counters = (ccl_similarity.STATS_LAUNCHES, ccl_similarity.BWD_LAUNCHES,
                embedding_update.GATHER_FMA_LAUNCHES)
    return {c.name: c.count("cpu") for c in counters}


def _reset_launches():
    for c in (ccl_similarity.STATS_LAUNCHES, ccl_similarity.BWD_LAUNCHES,
              embedding_update.GATHER_FMA_LAUNCHES):
        c.reset()


# ----------------------------------------------------------------------------
# The replayed step (the reference side runs in the test process)
# ----------------------------------------------------------------------------

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


def _reference_cases():
    """Each replay case: the reference's initial state, batch, draws, and
    its single-device step's state and loss."""
    import jax
    import jax.numpy as jnp

    from repro.core import engine as jeng
    from repro.core import mf as jmf
    from repro.core import samplers as jsam
    from repro.train.checkpoint import _flatten_with_paths

    def tree(state):
        return {n: np.asarray(x) for n, x in _flatten_with_paths(state)}

    cases = []
    for backend, sampler, tile, refresh in REPLAY_CASES:
        cfg = jmf.MFConfig(
            num_users=RU, num_items=RI, emb_dim=RK, num_negatives=RN,
            tile_size=tile, refresh_interval=refresh, backend=backend,
            update_impl="pallas" if backend == "pallas" else "scatter_add",
            sampler=sampler)
        state = jmf.init_mf(jax.random.PRNGKey(0), cfg)
        r = np.random.default_rng(100)
        users = r.integers(0, RU, RB).astype(np.int32)
        pos = r.integers(0, RI, RB).astype(np.int32)
        batch = jmf.Batch(jnp.asarray(users), jnp.asarray(pos))
        rng = jax.random.PRNGKey(1)
        r_neg, r_tile = jax.random.split(rng)
        engine = jeng.resolve_engine(cfg)
        drawn = engine.sampler.sample(
            jeng.SampleContext(table=state.params.item_table, tile=state.tile,
                               pos_ids=batch.pos_ids), r_neg, (RB, RN))
        refresh_ids = (np.asarray(jsam.sample_unique(r_tile, RI, tile))
                       if tile else None)
        new, loss = jmf.heat_train_step(state, batch, rng, cfg, engine=engine)
        cases.append(dict(
            cfg=dataclasses.asdict(cfg), init=tree(state), users=users,
            pos=pos, ids=np.asarray(drawn.ids),
            local=(None if drawn.local_idx is None
                   else np.asarray(drawn.local_idx)),
            refresh=refresh_ids, want=tree(new), loss=float(loss)))
    return cases


def _replay(cases, mesh) -> list:
    """Each case's step through the port's sharded step; the gathered state
    and the loss."""
    sampler = ReplaySampler()
    teng.register_sampler("replay")(sampler)
    orig = tsam.sample_unique
    out = []
    try:
        for c in cases:
            cfg = mf.MFConfig(**c["cfg"])
            plan = mfd.make_sharding_plan(cfg, mesh)
            state = plan.place_state(convert.mf_state_from_numpy(c["init"]))
            sampler.ids = torch.as_tensor(c["ids"]).long()
            sampler.local = (None if c["local"] is None
                             else torch.as_tensor(c["local"]).long())
            if c["refresh"] is not None:
                ids = torch.as_tensor(c["refresh"]).long()
                tsam.sample_unique = lambda gen, num, n, ids=ids: ids
            batch = mf.Batch(torch.as_tensor(c["users"]).long(),
                             torch.as_tensor(c["pos"]).long())
            new, loss = plan.train_step(
                state, batch, 0, cfg,
                engine=teng.resolve_engine(cfg, sampler="replay"))
            tsam.sample_unique = orig
            out.append((convert.mf_state_to_numpy(plan.gather_state(new)),
                        float(loss)))
    finally:
        tsam.sample_unique = orig
        del teng.SAMPLERS["replay"]
    return out


def _assert_replay(got, case):
    tree, loss = got
    np.testing.assert_allclose(loss, case["loss"], atol=ATOL)
    want = case["want"]
    assert sorted(tree) == sorted(want)
    for name in want:
        assert tree[name].dtype == want[name].dtype, name
        if name in ("tile/tile_ids", "tile/step", "step"):
            np.testing.assert_array_equal(tree[name], want[name], err_msg=name)
        else:
            np.testing.assert_allclose(tree[name], want[name], atol=ATOL,
                                       err_msg=name)


# ----------------------------------------------------------------------------
# Rank bodies
# ----------------------------------------------------------------------------

def _data4_rank(tmp: str) -> dict:
    """data=4: the backend matrix, self_attn, an uneven batch, a crash and
    resume, and the pallas run's launches on this rank."""
    mesh = make_data_mesh(4)
    out = {}
    for name, kw in MATRIX.items():
        if name == "pallas":
            _reset_launches()
        out[name] = _train(dict(kw, **TILE), mesh)
        if name == "pallas":
            out["launches"] = _launches()
    out["self_attn"] = _train(SELF_ATTN, mesh, steps=6, k=3)
    out["uneven"] = _train(dict(backend="fused"), mesh, steps=6, k=3,
                           batch=52)
    logs: list = []
    out["clean"] = _train(CRASH, mesh, steps=16, k=8,
                          ckpt_dir=os.path.join(tmp, "clean"), ckpt_every=4)
    out["crash"] = _train(CRASH, mesh, steps=16, k=8,
                          ckpt_dir=os.path.join(tmp, "crash"), ckpt_every=4,
                          fail_at_step=10, log=logs.append)
    out["logs"] = logs
    return out if dist.get_rank() == 0 else {"launches": out["launches"],
                                              "crash": out["crash"]}


def _mesh22_rank(cases, topk_users) -> dict:
    """(data=2, model=2): training with uniform and tile negatives, the
    replayed step, and tile-pruned top-k over the sharded tables."""
    mesh = make_host_mesh(2, 2)
    out = {name: _train(kw, mesh) for name, kw in MESH22.items()}
    out["replay"] = _replay(cases, mesh)
    cfg = _cfg(backend="fused")
    plan = mfd.make_sharding_plan(cfg, mesh)
    state = mf.init_mf(0, cfg, device="cpu")
    index = retrieval.build_retrieval_index(state.params.item_table,
                                            tile_rows=64)
    local = plan.place_state(state).params
    users = torch.as_tensor(topk_users)
    out["topk"] = [retrieval.topk_pruned(local, users, 10, index,
                                         expand_tiles=t, plan=plan).numpy()
                   for t in (3, index.num_tiles)]
    out["coords"] = mesh.coords
    out["own"] = (plan.users.own, plan.items.own)
    return out


def _data2_rank(cases, tmp: str) -> dict:
    """data=2: the replayed step, avg history through a tile, the
    exchanges, compressed_psum over a pod axis of 2, and checkpoints across
    world sizes."""
    mesh = make_data_mesh(2)
    rank = dist.get_rank()
    out = {"replay": _replay(cases, mesh),
           "hist_tile": _train(HIST_TILE, mesh, steps=6, k=3)}

    # The exchanges: parts of mixed dtypes in rank order; a sum over ranks
    # with the same bits on every rank; the owner-masked lookup exact.
    group = mesh.group("data")
    x = torch.arange(6, dtype=torch.int64).reshape(2, 3) + 10 * rank
    y = torch.full((5,), 0.1 * (rank + 1), dtype=torch.float32)
    z = torch.tensor([rank == 0, True])
    parts = shd.all_gather_parts([x, y, z], group)
    out["parts"] = [[p.numpy() for p in m] for m in parts]
    gen = torch.Generator().manual_seed(7)
    vals = torch.randn(3, 17, generator=gen) * (1 + rank) / 3
    out["sum"] = shd.sum_over([vals], group)[0].numpy()
    table = torch.randn(40, 5, generator=torch.Generator().manual_seed(8))
    rows = shd.RowShard(group, 40)
    ids = torch.tensor([[0, 19, 20, 39], [21, 18, 5, 33]])
    out["lookup"] = rows.lookup(rows.local(table).clone(), ids).numpy()
    out["gathered"] = rows.gather(rows.local(table).clone()).numpy()

    # compressed_psum over a pod axis of 2, three calls with feedback.
    pod = shd.Mesh({"pod": 2})
    g = torch.randn(2, 64, generator=torch.Generator().manual_seed(0))
    st = compression.compression_init(g[rank])
    totals, errors = [], []
    for _ in range(3):
        total, st = compression.compressed_psum(g[rank], st, pod.group("pod"))
        totals.append(total.numpy())
        errors.append(st.error.numpy())
    out["psum"] = (g.numpy(), totals, errors)

    # Elastic: a checkpoint saved by 1 rank, trained on by 2 to step 12;
    # then 2 ranks save at steps 4 and 8 for 1 rank to train on.
    out["from_w1"] = _train(CRASH, mesh, steps=12,
                            ckpt_dir=os.path.join(tmp, "w1"), ckpt_every=4)
    out["w2"] = _train(CRASH, mesh, steps=8,
                       ckpt_dir=os.path.join(tmp, "w2"), ckpt_every=4)
    return out


def _failing_rank(how: str) -> int:
    """Rank 1 fails (``raise`` or ``exit``) while rank 0 waits on it."""
    if dist.get_rank() == 1:
        if how == "raise":
            raise ValueError("rank one gives up")
        os._exit(3)
    dist.barrier()
    return 0


# ----------------------------------------------------------------------------
# Fixtures: one spawn each, shared by the tests that read it
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single():
    """The single-device port runs the sharded runs are held to."""
    out = {name: _train(dict(kw, **TILE)) for name, kw in MATRIX.items()}
    out["self_attn"] = _train(SELF_ATTN, steps=6, k=3)
    out["hist_tile"] = _train(HIST_TILE, steps=6, k=3)
    out["uneven"] = _train(dict(backend="fused"), steps=6, k=3, batch=52)
    out.update({f"mesh22-{n}": _train(kw) for n, kw in MESH22.items()})
    out["crash"] = _train(CRASH, steps=16, k=8)
    out["elastic"] = _train(CRASH, steps=12)
    return out


@pytest.fixture(scope="module")
def data4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data4")
    return run_ranks(_data4_rank, 4, args=(str(tmp),), threads=1,
                     timeout=TIMEOUT, store_dir=str(tmp))


@pytest.fixture(scope="module")
def cases():
    return _reference_cases()


@pytest.fixture(scope="module")
def mesh22(cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh22")
    return run_ranks(_mesh22_rank, 4, args=(cases, np.arange(BATCH)),
                     threads=1, timeout=TIMEOUT, store_dir=str(tmp))


@pytest.fixture(scope="module")
def data2(cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data2")
    # a single-device run saves at steps 4 and 8 for the 2 ranks to resume
    trainer.train_mf(_cfg(**CRASH), _ds(), 8, batch_size=BATCH,
                     steps_per_dispatch=4, device="cpu",
                     ckpt_dir=str(tmp / "w1"), ckpt_every=4,
                     log=lambda *_: None)
    return tmp, run_ranks(_data2_rank, 2, args=(cases, str(tmp)), threads=1,
                          timeout=TIMEOUT, store_dir=str(tmp))


# ----------------------------------------------------------------------------
# Tests
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MATRIX))
def test_data4_tracks_single_device(name, data4, single):
    """data=4 with tile negatives (refresh every 5 steps): every step's loss
    and the whole final state within 1e-5."""
    _assert_close(data4[0][name], single[name])


def test_data4_pallas_launches_each_kernel_per_step_on_every_rank(data4):
    """1/1/2 of ccl_stats/ccl_bwd/gather_fma a step on each rank (their
    plain versions here): the user shard's update and the item update."""
    for r in data4:
        assert r["launches"] == {"ccl_stats": 12, "ccl_bwd": 12,
                                 "gather_fma": 24}


def test_data4_self_attn_history_tracks_single_device(data4, single):
    """self_attn aggregation, flushed every 3 steps: the ranks' gradient
    shares summed on flush steps reproduce the single-device update."""
    _assert_close(data4[0]["self_attn"], single["self_attn"])


def test_data4_uneven_batch_tracks_single_device(data4, single):
    """A batch of 52 over 4 ranks (13 rows each)."""
    _assert_close(data4[0]["uneven"], single["uneven"])


def test_data4_crash_resume_is_bit_exact(data4, single):
    """A failure at step 10 (mid-window) restores the step-8 checkpoint on
    every rank; the final state equals the uninterrupted sharded run bit for
    bit, and the replayed losses' tail too."""
    r0 = data4[0]
    assert r0["logs"] == ["[mf] injected failure at step 10 -> restoring"]
    clean_tree, clean_losses = r0["clean"]
    crash_tree, crash_losses = r0["crash"]
    assert len(crash_losses) == 18                # steps 8 and 9 run twice
    assert crash_losses[8:10] == crash_losses[10:12]
    _assert_same((crash_tree, crash_losses[:8] + crash_losses[10:]),
                 (clean_tree, clean_losses))
    _assert_close((crash_tree, crash_losses[:8] + crash_losses[10:]),
                  single["crash"])
    for r in data4[1:]:
        _assert_same(r["crash"], r0["crash"])     # every rank gathers it


def test_data2_history_tile_tracks_single_device(data2, single):
    """avg history rows written through to the replicated tile, with a
    refresh and two flushes: every step's loss and the whole final state
    within 1e-5 on both ranks."""
    for r in data2[1]:
        _assert_close(r["hist_tile"], single["hist_tile"])


@pytest.mark.parametrize("name", list(MESH22))
def test_mesh22_tracks_single_device(name, mesh22, single):
    """(data=2, model=2): item rows split, so positive (and uniform) rows
    and the tile refresh come through the lookup over model."""
    for r in mesh22:
        _assert_close(r[name], single[f"mesh22-{name}"])


def test_mesh22_coordinates_and_row_shards(mesh22):
    assert [r["coords"] for r in mesh22] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    assert [r["own"] for r in mesh22] == [
        ((0, 128), (0, 256)), ((0, 128), (256, 512)),
        ((128, 256), (0, 256)), ((128, 256), (256, 512))]


@pytest.mark.parametrize("case", range(len(REPLAY_CASES)), ids=REPLAY_IDS)
@pytest.mark.parametrize("mesh", ["data2", "mesh22"])
def test_replayed_sharded_step_matches_reference(case, mesh, cases, data2,
                                                 mesh22):
    """The reference's single-device step and the port's sharded step on
    the same state, batch and draws: loss and whole state within 1e-5."""
    ranks = data2[1] if mesh == "data2" else mesh22
    for r in ranks:
        _assert_replay(r["replay"][case], cases[case])


def test_sharded_topk_pruned_ids_bit_identical(mesh22):
    cfg = _cfg(backend="fused")
    state = mf.init_mf(0, cfg, device="cpu")
    index = retrieval.build_retrieval_index(state.params.item_table,
                                            tile_rows=64)
    users = torch.arange(BATCH)
    want = retrieval.topk_pruned(state.params, users, 10, index,
                                 expand_tiles=3).numpy()
    exact = mf.topk_all_items(state.params, users, 10).numpy()
    for r in mesh22:
        got, full = r["topk"]
        np.testing.assert_array_equal(got, want)
        for g, w in zip(full, exact):
            assert set(g.tolist()) == set(w.tolist())


def test_exchanges_are_exact_and_rank_ordered(data2):
    ranks = data2[1]
    for r in ranks:
        for j, part in enumerate(r["parts"]):
            np.testing.assert_array_equal(
                part[0], np.arange(6).reshape(2, 3) + 10 * j)
            np.testing.assert_array_equal(
                part[1], np.full(5, np.float32(0.1 * (j + 1))))
            np.testing.assert_array_equal(part[2], [j == 0, True])
    np.testing.assert_array_equal(ranks[0]["sum"], ranks[1]["sum"])
    table = torch.randn(40, 5, generator=torch.Generator().manual_seed(8))
    ids = torch.tensor([[0, 19, 20, 39], [21, 18, 5, 33]])
    for r in ranks:
        np.testing.assert_array_equal(r["lookup"], table[ids].numpy())
        np.testing.assert_array_equal(r["gathered"], table.numpy())


def test_compressed_psum_over_a_pod_axis_of_two(data2):
    """Within 0.05 of the exact sum on every call (the bound of
    tests/test_distributed.py), the same bits on both ranks, and the error
    feedback carried: the residual changes between calls and the running
    mean of the compressed sums sits closer to the exact sum than one
    call."""
    ranks = data2[1]
    g, totals, errors = ranks[0]["psum"]
    exact = g.sum(0)
    for t in totals:
        assert np.abs(t - exact).max() < 0.05
    for r in ranks[1:]:
        for a, b in zip(r["psum"][1], totals):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(errors[0], errors[1])
    assert np.abs(np.mean(totals, axis=0) - exact).max() <= \
        np.abs(totals[0] - exact).max()


def test_checkpoint_from_one_rank_trains_on_two(data2, single):
    _assert_close((data2[1][0]["from_w1"][0], data2[1][0]["from_w1"][1]),
                  (single["elastic"][0], single["elastic"][1][8:]))


def test_checkpoint_from_two_ranks_trains_on_one(data2, single):
    tmp, ranks = data2
    saved_tree = ranks[0]["w2"][0]
    cfg = _cfg(**CRASH)
    restored, step, _ = ckpt.restore(str(tmp / "w2"),
                                     mf.init_mf(0, cfg, device="cpu"))
    assert step == 8
    _assert_same((_tree(restored), []), (saved_tree, []))
    state, losses = trainer.train_mf(cfg, _ds(), 12, batch_size=BATCH,
                                     steps_per_dispatch=4, device="cpu",
                                     ckpt_dir=str(tmp / "w2"), ckpt_every=4,
                                     log=lambda *_: None)
    _assert_close((_tree(state), losses),
                  (single["elastic"][0], single["elastic"][1][8:]))


def test_cli_mesh_host_data2_prints_devices_and_done(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mf",
         "--reduced", "--steps", "4", "--batch", "32",
         "--steps-per-dispatch", "2", "--mesh", "host", "--mesh-data", "2",
         "--dist-backend", "gloo", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=TIMEOUT,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "devices=2" in out.stdout
    assert "done: 4 steps" in out.stdout


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_run_ranks_fails_fast_with_the_rank_error(how, tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_ranks(_failing_rank, 2, args=(how,), threads=1, timeout=TIMEOUT,
                  store_dir=str(tmp_path))
    assert time.monotonic() - t0 < 30
    if how == "raise":
        assert "rank 1 of 2 failed" in str(err.value)
        assert "ValueError: rank one gives up" in str(err.value)
    else:
        assert "rank 1 exited with code 3" in str(err.value)
    shutil.rmtree(tmp_path, ignore_errors=True)
