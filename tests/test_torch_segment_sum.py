"""The sorted segment sum (``kernels/segment_sum.py``, ``csrc/segment_sum.cu``).

The CPU tests hold the plain version to a plain sequential loop (runs of up
to ``PIECE``), to an fp64 sum (a run of 10 pieces), and to the sorted-copy
form; they check the dispatch on ``meta`` tensors and the launch counter.
The tests marked ``cuda`` hold the kernel to the plain version bit for bit
at the step's shapes and at the edges, and skip where there is no card; this
file imports no JAX, so on a machine with the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_segment_sum.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import tiling
from repro_torch.kernels import segment_sum as ss

C = ss.PIECE


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _sorted_case(lengths, k, *, dropped=0, seed=0):
    """Sorted ids with the given run length per segment (0: empty), then
    ``dropped`` positions of id ``len(lengths)``; a random permutation
    ``order`` and values (M, K) to read through it."""
    r = np.random.default_rng(seed)
    sidx = np.repeat(np.arange(len(lengths) + 1),
                     list(lengths) + [dropped]).astype(np.int64)
    m = sidx.shape[0]
    order = r.permutation(m).astype(np.int64)
    values = r.standard_normal((m, k)).astype(np.float32)
    return sidx, order, values


def _sequential(sidx, order, values, num_segments):
    """Each segment summed from +0 in sorted order, one fp32 add at a time."""
    out = np.zeros((num_segments, values.shape[1]), np.float32)
    for i, s in enumerate(sidx):
        if s < num_segments:
            out[s] = out[s] + values[order[i]]
    return out


def _piecewise(sidx, order, values, num_segments):
    """:func:`_sequential` over pieces of at most ``C`` positions from each
    run's start, then each run's pieces added in order."""
    out = np.zeros((num_segments, values.shape[1]), np.float32)
    for s in range(num_segments):
        pos = np.flatnonzero(sidx == s)
        for p0 in range(0, pos.shape[0], C):
            piece = np.zeros(values.shape[1], np.float32)
            for i in pos[p0:p0 + C]:
                piece = piece + values[order[i]]
            out[s] = piece if p0 == 0 else out[s] + piece
    return out


@pytest.mark.parametrize("lengths,dropped", [
    ([C], 0), ([C - 1, 1, 0, 7], 3), ([1] * 40, 0), ([0, 0, 5], 9), ([], 4),
    ([C, C, 0, C], 1)])
def test_plain_equals_sequential_loop_up_to_piece(lengths, dropped):
    sidx, order, values = _sorted_case(lengths, 5, dropped=dropped, seed=len(lengths))
    got = ss.sorted_segment_sum_plain(torch.as_tensor(sidx), torch.as_tensor(values),
                                      len(lengths), torch.as_tensor(order))
    assert got.shape == (len(lengths), 5)
    np.testing.assert_array_equal(got.numpy(), _sequential(sidx, order, values,
                                                           len(lengths)))


@pytest.mark.parametrize("lengths", [[10 * C], [3, 10 * C + 7, 0, C + 1, 2 * C]])
def test_plain_long_runs_in_pieces(lengths):
    """A run of 10 pieces and more: the pieces' order bit for bit, and the
    fp64 sum within fp32 rounding (the chain of at most C + runs / C adds)."""
    sidx, order, values = _sorted_case(lengths, 6, dropped=5, seed=7)
    got = ss.sorted_segment_sum_plain(torch.as_tensor(sidx), torch.as_tensor(values),
                                      len(lengths), torch.as_tensor(order)).numpy()
    np.testing.assert_array_equal(got, _piecewise(sidx, order, values, len(lengths)))
    kept = sidx < len(lengths)
    exact = np.zeros((len(lengths), 6))
    np.add.at(exact, sidx[kept], values[order[kept]].astype(np.float64))
    mag = np.zeros((len(lengths), 6))
    np.add.at(mag, sidx[kept], np.abs(values[order[kept]]).astype(np.float64))
    adds = C + max(lengths) // C + 1
    assert np.all(np.abs(got - exact) <= adds * 2.0 ** -24 * mag)


@pytest.mark.parametrize("m,num_segments,k,hot", [
    (5000, 40, 4, 0.0), (6000, 9, 3, 0.6), (3 * C + 2, 2, 2, 1.0), (0, 3, 4, 0.0)])
def test_segment_sum_through_permutation_equals_sorted_copy(m, num_segments, k, hot):
    """``segment_sum`` reads the values through the sort's permutation: the
    same bits as the sorted copy summed in place, long runs (``hot``: the
    share of the positions in segment 0) and dropped entries included."""
    r = np.random.default_rng(m + k)
    idx = r.integers(0, num_segments + 1, m)
    idx[r.random(m) < hot] = 0
    idx_t = torch.as_tensor(idx)
    values = torch.as_tensor(r.standard_normal((m, k)).astype(np.float32))
    got = tiling.segment_sum(idx_t, values, num_segments)
    order = torch.argsort(idx_t, stable=True)
    copied = tiling.sorted_segment_sum(idx_t[order], values[order], num_segments)
    assert got.shape == (num_segments, k)
    assert torch.equal(got, copied)


def test_meta_dispatch_returns_the_output_shape_and_counts():
    ss.SEGMENT_SUM_LAUNCHES.reset()
    sidx = torch.zeros(70, dtype=torch.int64, device="meta")
    out = tiling.sorted_segment_sum(sidx, torch.empty(90, 12, device="meta"), 33,
                                    order=torch.empty(70, dtype=torch.int64, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (33, 12)
    assert out.dtype == torch.float32
    assert tuple(tiling.segment_sum(sidx, torch.empty(70, 5, device="meta"), 4).shape) \
        == (4, 5)
    assert ss.SEGMENT_SUM_LAUNCHES.count("meta") == 2
    assert ss.SEGMENT_SUM_LAUNCHES.count("cpu") == 0
    assert ss.SEGMENT_SUM_LAUNCHES.count("cuda") == 0


def test_launch_counter_counts_cpu_dispatches_of_fp32_only():
    ss.SEGMENT_SUM_LAUNCHES.reset()
    idx = torch.tensor([2, 0, 2, 1])
    tiling.segment_sum(idx, torch.ones(4, 3), 3)
    tiling.sorted_segment_sum(torch.tensor([0, 1, 1]), torch.ones(3, 2), 2)
    assert ss.SEGMENT_SUM_LAUNCHES.count("cpu") == 2
    half = tiling.segment_sum(idx, torch.ones(4, 3, dtype=torch.bfloat16), 3)
    assert half.dtype == torch.bfloat16              # the library's in-order sum
    assert ss.SEGMENT_SUM_LAUNCHES.count("cpu") == 2
    assert ss.SEGMENT_SUM_LAUNCHES.count("meta") == 0
    torch.testing.assert_close(half.float(), torch.tensor([[1.0] * 3, [1.0] * 3,
                                                           [2.0] * 3]))


def test_sorted_segment_sum_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="expected sidx"):
        ss.sorted_segment_sum(torch.zeros(4, dtype=torch.int64), torch.ones(5, 2), 3)
    with pytest.raises(ValueError, match="expected sidx"):
        ss.sorted_segment_sum(torch.zeros(4, dtype=torch.int64), torch.ones(5, 2), 3,
                              order=torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("run", [C + 1, 3 * C])
def test_gather_fma_plain_sums_a_long_run_in_one_piece(run):
    """Kernel #6 (``gather_fma.cu``) sums each id's run in one pass, however
    long: its plain version keeps that order, not the pieces of #8."""
    from repro_torch.kernels import embedding_update
    r = np.random.default_rng(run)
    ids = np.concatenate([np.full(run, 3), r.integers(0, 8, 40)]).astype(np.int64)
    grads = r.standard_normal((ids.shape[0], 4)).astype(np.float32)
    table = r.standard_normal((8, 4)).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    got = embedding_update.gather_fma_rows_plain_(
        torch.as_tensor(table.copy()), torch.as_tensor(ids[order]),
        torch.as_tensor(order), torch.as_tensor(grads), 0.5)
    sums = _sequential(ids[order], order, grads, 8)
    want = table.copy()
    for s in np.unique(ids):
        want[s] = want[s] - np.float32(0.5) * sums[s]
    np.testing.assert_array_equal(got.numpy(), want)


def _host_engaged(sidx, num_segments):
    lengths = np.bincount(sidx[sidx < num_segments], minlength=num_segments)
    return int(np.maximum(0, -(-lengths // C) - 1).sum())


def _dedup_case(m, run, seed):
    """``_dedup``'s shape: one run of ``run`` positions (the padding's item
    0), then short runs, as segment indices of sorted ids; num_segments = m."""
    r = np.random.default_rng(seed)
    rest = np.cumsum(r.random(m - run) < 0.8) + 1
    sidx = np.concatenate([np.zeros(run, np.int64), rest]).astype(np.int64)
    return sidx, r.permutation(m).astype(np.int64), m


# (name, sorted ids, num_segments, K): _dedup's item update at batch 16,384
# (one run of 1.59M of 1,655,808 positions); the slot reduction at batch
# 65,536 (4,194,304 positions into 1,024 slots); runs of exactly C and C + 1
# (and 2C, 2C + 1); a dropped tail with empty segments at K = 130 (the scalar
# path); K = 4,096; num_segments past 2^21 with the last segment used; M = 0.
def _permuted(sidx, num_segments, seed):
    return sidx, np.random.default_rng(seed).permutation(sidx.shape[0]), num_segments


def _slots():
    r = np.random.default_rng(11)
    return _permuted(np.sort(r.integers(0, 1024, 4_194_304)).astype(np.int64), 1024, 12)


def _far():
    big_s = 2 ** 21 + 5
    r = np.random.default_rng(13)
    return _permuted(np.sort(np.concatenate([r.integers(0, big_s, 3000),
                                             [big_s - 1] * (C + 3), [big_s] * 50]))
                     .astype(np.int64), big_s, 14)


def _runs(lengths, dropped=0):
    return np.repeat(np.arange(len(lengths) + 1), list(lengths) + [dropped]).astype(np.int64)


def _cuda_cases():
    return {"dedup_1.6M_k128": (lambda: _dedup_case(1_655_808, 1_590_000, 3), 128),
            "slots_4.19M_k128": (_slots, 128),
            "runs_C_C+1": (lambda: _permuted(_runs([C, C + 1, 2 * C, 2 * C + 1, 3]), 5, 1),
                           64),
            "dropped_tail_k130": (lambda: _permuted(
                _runs([0, 40, 0, 3 * C + 5, 1, 0, 7, 0], 900), 8, 2), 130),
            "k4096": (lambda: _permuted(_runs([3, C + 9, 0, 2 * C]), 4, 3), 4096),
            "segments_past_2^21": (_far, 8),
            "m0": (lambda: _permuted(np.zeros(0, np.int64), 6, 4), 16)}


CUDA_CASES = _cuda_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_segment_sum_matches_plain_and_repeats(cuda, case):
    make, k = CUDA_CASES[case]
    sidx, order, num_segments = make()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    values = torch.randn(sidx.shape[0], k, generator=gen, device=cuda)
    sidx_d = torch.as_tensor(sidx, device=cuda)
    order_d = torch.as_tensor(np.asarray(order, np.int64), device=cuda)
    engaged = ss.engaged_pieces(cuda)
    ss.SEGMENT_SUM_LAUNCHES.reset()
    torch.cuda.synchronize()
    before = int(engaged.item())
    got = tiling.sorted_segment_sum(sidx_d, values, num_segments, order=order_d)
    again = tiling.sorted_segment_sum(sidx_d, values, num_segments, order=order_d)
    torch.cuda.synchronize()
    assert ss.SEGMENT_SUM_LAUNCHES.count("cuda") == 2
    assert int(engaged.item()) - before == 2 * _host_engaged(sidx, num_segments)
    assert torch.equal(got, again)                     # same bits every call
    want = ss.sorted_segment_sum_plain(sidx_d.cpu(), values.cpu(), num_segments,
                                       order_d.cpu())
    assert got.shape == want.shape == (num_segments, k)
    assert torch.equal(got.cpu(), want)
    # Without the permutation (values already sorted): the same bits.
    assert torch.equal(tiling.sorted_segment_sum(sidx_d, values[order_d], num_segments),
                       got)


@pytest.mark.cuda
def test_cuda_segment_sum_makes_no_host_sync(cuda):
    r = np.random.default_rng(2)
    idx = torch.as_tensor(np.where(r.random(50_000) < 0.9, 0, r.integers(0, 300, 50_000)),
                          device=cuda)
    values = torch.randn(50_000, 128, device=cuda)
    want = tiling.segment_sum(idx, values, 300)        # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tiling.segment_sum(idx, values, 300)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), tiling.segment_sum(idx.cpu(), values.cpu(), 300))
