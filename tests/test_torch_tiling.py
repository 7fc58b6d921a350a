"""The port's tile write-through and deterministic segment sum
(``repro_torch/core/tiling.py``) against the JAX package's
``repro/core/tiling.py``.

Inputs are made with numpy from a seed and given to both packages.  Most
update ids miss the tile, as in the MF step's write-through (a 1,024-row
tile of a table of many rows), where the reference drops the misses with
``.at[].add(mode="drop")``.  Tolerance: 1e-6 absolute in fp32 (both sum a
hit's duplicates in id order; the reference's scatter-add may pair them
differently).  The segment sum's kept sums are also held bit for bit against
the earlier form of the function, which summed the dropped entries as one
more segment and sliced it off.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import tiling


@pytest.fixture(scope="module")
def jtiling():
    """The JAX package's tiling module (imported in a fixture, not at module
    level)."""
    pytest.importorskip("jax")
    from repro.core import tiling as jt
    return jt


@pytest.fixture(scope="module")
def jnp():
    """``jax.numpy``, for handing the inputs to the reference."""
    return pytest.importorskip("jax.numpy")


def _write_through_case(seed, rows, n1, b, k, hit_frac):
    """A tile of ``n1`` distinct ids out of ``rows`` (unsorted), and ``b``
    update ids of which ``int(b * hit_frac)`` are drawn from the tile (with
    duplicates) and the rest from the rows outside it (misses)."""
    r = np.random.default_rng(seed)
    perm = r.permutation(rows).astype(np.int32)
    tile_ids, outside = perm[:n1], perm[n1:]
    n_hit = int(b * hit_frac)
    ids = np.concatenate([tile_ids[r.integers(0, n1, n_hit)],
                          outside[r.integers(0, rows - n1, b - n_hit)]])
    ids = ids[r.permutation(b)]
    tile_emb = r.standard_normal((n1, k)).astype(np.float32)
    grads = r.standard_normal((b, k)).astype(np.float32)
    return tile_ids, tile_emb, ids, grads


# (rows, n1, b, k, hit_frac): the MF step's shape cut down (a tile of 64 of
# 50,000 rows, 1,088 ids, a few percent hits), no hit at all, and a small
# tile that is hit often, with many duplicates.
CASES = [(50_000, 64, 1088, 16, 0.05), (10_000, 32, 500, 8, 0.0),
         (1000, 16, 300, 12, 0.5)]


@pytest.mark.parametrize("rows,n1,b,k,hit_frac", CASES)
def test_tile_write_through_matches_reference(jtiling, jnp, rows, n1, b, k,
                                             hit_frac):
    tile_ids, tile_emb, ids, grads = _write_through_case(3, rows, n1, b, k,
                                                         hit_frac)
    want = np.asarray(jtiling.tile_write_through(
        *(jnp.asarray(x) for x in (tile_ids, tile_emb, ids, grads)), 0.05))
    got = tiling.tile_write_through(
        *(torch.as_tensor(x) for x in (tile_ids, tile_emb)),
        torch.as_tensor(ids).long(), torch.as_tensor(grads), 0.05)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if hit_frac == 0.0:                  # every update missed: unchanged bits
        assert torch.equal(got, torch.as_tensor(tile_emb))


def test_segment_reduce_gets_only_kept_segments(monkeypatch):
    """The write-through hands ``segment_reduce`` exactly ``num_segments``
    lengths, which sum to the hits alone: the sorted tail of misses is not
    summed."""
    rows, n1, b, k = 50_000, 64, 1088, 16
    tile_ids, tile_emb, ids, grads = _write_through_case(4, rows, n1, b, k, 0.05)
    n_hits = int(b * 0.05)                               # most ids miss
    calls = []
    real = torch.segment_reduce

    def spy(values, reduce, **kw):
        calls.append((values.shape[0], kw["lengths"].clone()))
        return real(values, reduce, **kw)

    monkeypatch.setattr(torch, "segment_reduce", spy)
    tiling.tile_write_through(
        *(torch.as_tensor(x) for x in (tile_ids, tile_emb)),
        torch.as_tensor(ids).long(), torch.as_tensor(grads), 0.05)
    assert len(calls) == 1
    n_values, lengths = calls[0]
    assert n_values == b
    assert lengths.shape == (n1,)
    assert int(lengths.sum()) == n_hits


def _sorted_segment_sum_before(sidx, values, num_segments):
    """The earlier form of ``sorted_segment_sum``: the dropped entries were
    summed as segment ``num_segments`` and sliced off."""
    bounds = torch.searchsorted(
        sidx, torch.arange(num_segments + 2, dtype=sidx.dtype, device=sidx.device))
    sums = torch.segment_reduce(values, "sum", lengths=bounds.diff(), axis=0,
                                unsafe=True)
    return sums[:num_segments]


@pytest.mark.parametrize("m,num_segments,k,drop_frac", [
    (2000, 37, 8, 0.9), (500, 500, 3, 0.0), (300, 5, 16, 1.0), (1, 4, 2, 0.0),
    (0, 3, 4, 0.0)])
def test_segment_sum_kept_sums_unchanged_bit_for_bit(m, num_segments, k, drop_frac):
    """Every kept sum is the bits the earlier form gave, and equals a plain
    sequential sum in index order; dropped entries leave no trace."""
    r = np.random.default_rng(m + num_segments)
    idx = r.integers(0, num_segments, m)
    idx[r.random(m) < drop_frac] = num_segments            # dropped
    values = r.standard_normal((m, k)).astype(np.float32)
    idx_t, values_t = torch.as_tensor(idx), torch.as_tensor(values)
    got = tiling.segment_sum(idx_t, values_t, num_segments)
    order = torch.argsort(idx_t, stable=True)
    before = _sorted_segment_sum_before(idx_t[order], values_t[order], num_segments)
    assert got.shape == (num_segments, k)
    assert torch.equal(got, before)
    want = np.zeros((num_segments, k), np.float32)
    for i in range(m):                                      # index order
        if idx[i] < num_segments:
            want[idx[i]] += values[i]
    np.testing.assert_array_equal(got.numpy(), want)
