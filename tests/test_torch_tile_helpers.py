"""The last tile helpers of ``core/samplers.py`` against the reference's:
``tile_sample``, ``tile_writeback``, ``tile_apply_global_grads`` and
``tile_apply_global_grads_mask``, on the same tile and the same ids (made
with numpy from a seed), duplicates and misses included.  The draws of
``tile_sample`` are each package's own (ROADMAP: the port cannot reproduce
threefry), so it is held to the reference's contract: the ids and rows are
the tile's at the drawn slots."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import samplers as jsamplers
from repro_torch.core import samplers
from repro_torch.core.mf import generator

N1, K, ITEMS = 64, 16, 1000


def _tiles(seed: int):
    r = np.random.default_rng(seed)
    ids = np.sort(r.choice(ITEMS, N1, replace=False)).astype(np.int64)
    emb = r.standard_normal((N1, K)).astype(np.float32)
    ours = samplers.TileState(torch.from_numpy(ids), torch.from_numpy(emb), 0)
    ref = jsamplers.TileState(jnp.asarray(ids, jnp.int32), jnp.asarray(emb),
                              jnp.zeros((), jnp.int32))
    return r, ids, ours, ref


def _updates(r, ids, n: int):
    """n global ids, half of them tile hits (with repeats), and grads."""
    hits = r.choice(ids, n // 2)
    misses = r.integers(0, ITEMS, n - n // 2)
    glob = r.permutation(np.concatenate([hits, misses])).astype(np.int64)
    return glob, r.standard_normal((n, K)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_sample_reads_the_tile_at_its_slots(seed):
    _, ids, ours, ref = _tiles(seed)
    g_ids, g_emb, local = samplers.tile_sample(ours, generator(seed, "cpu"),
                                               (32, 4))
    assert local.shape == (32, 4) and int(local.min()) >= 0 \
        and int(local.max()) < N1
    assert torch.equal(g_ids, ours.tile_ids[local])
    assert torch.equal(g_emb, ours.tile_emb[local])
    r_ids, r_emb, r_local = jsamplers.tile_sample(ref, jax.random.PRNGKey(seed),
                                                  (32, 4))
    r_local = np.asarray(r_local)
    np.testing.assert_array_equal(np.asarray(r_ids), ids[r_local])
    # the port's gather at the reference's slots gives the reference's rows
    again = ours.tile_emb[torch.from_numpy(r_local.astype(np.int64))]
    np.testing.assert_array_equal(again.numpy(), np.asarray(r_emb))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_writeback_last_write_wins_as_the_reference(seed):
    r, _, ours, ref = _tiles(seed)
    local = r.integers(0, N1, (24, 3)).astype(np.int64)   # many duplicates
    rows = r.standard_normal((24, 3, K)).astype(np.float32)
    got = samplers.tile_writeback(ours, torch.from_numpy(local),
                                  torch.from_numpy(rows))
    want = jsamplers.tile_writeback(ref, jnp.asarray(local, jnp.int32),
                                    jnp.asarray(rows))
    np.testing.assert_array_equal(got.tile_emb.numpy(),
                                  np.asarray(want.tile_emb))
    # last write wins, by position in the flattened update list
    flat_l, flat_r = local.reshape(-1), rows.reshape(-1, K)
    expect = ours.tile_emb.numpy().copy()
    for i, slot in enumerate(flat_l):
        expect[slot] = flat_r[i]
    np.testing.assert_array_equal(got.tile_emb.numpy(), expect)
    assert torch.equal(got.tile_ids, ours.tile_ids)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 40, 257])
def test_global_write_throughs_match_the_reference(seed, n):
    r, ids, ours, ref = _tiles(seed)
    glob, grads = _updates(r, ids, n)
    lr = 0.05
    got = samplers.tile_apply_global_grads(ours, torch.from_numpy(glob),
                                           torch.from_numpy(grads), lr)
    got_mask = samplers.tile_apply_global_grads_mask(
        ours, torch.from_numpy(glob), torch.from_numpy(grads), lr)
    jg = jnp.asarray(glob, jnp.int32)
    want = jsamplers.tile_apply_global_grads(ref, jg, jnp.asarray(grads), lr)
    want_mask = jsamplers.tile_apply_global_grads_mask(ref, jg,
                                                       jnp.asarray(grads), lr)
    for a in (got.tile_emb, got_mask.tile_emb):
        for b in (want.tile_emb, want_mask.tile_emb):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    # a miss changes nothing; a hit subtracts lr times its summed grads
    expect = ours.tile_emb.numpy().astype(np.float64)
    slot = {int(i): s for s, i in enumerate(ids)}
    for i, g in zip(glob, grads):
        if int(i) in slot:
            expect[slot[int(i)]] -= lr * g
    np.testing.assert_allclose(got.tile_emb.numpy(), expect, rtol=1e-5,
                               atol=1e-6)
    assert got.step == got_mask.step == ours.step
