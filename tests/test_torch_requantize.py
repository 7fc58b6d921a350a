"""The int8 update's requantize (``kernels/requantize_rows.py``,
``csrc/requantize_rows.cu``).

The CPU tests hold ``quantization.apply_updates``, which now runs the
requantize through ``requantize_rows_``, to the update as it was written
before the kernel (every lane requantized and scattered) bit for bit, show
that working the live segments alone stores the same bits, and check the
dispatch on ``meta`` tensors and the launch counter.  The tests marked
``cuda`` hold the kernel to the plain version run on the card (the card's
PyTorch rounds ``absmax / 127.0`` as a multiply by the reciprocal, the CPU's
as a division) bit for bit, count its segments, and check that it makes no
host sync; they skip where there is no card.  This file imports no JAX, so
on a machine with the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_requantize.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import requantize_rows as rq
from repro_torch.kernels.embedding_update import gather_dequant_rows_plain
from repro_torch.optim import quantization as qz

ROWS, LR = 64, 0.05


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _apply_updates_before(table, ids, grads, lr, gen):
    """``apply_updates`` as it was written before the requantize had a
    kernel: every lane requantized, every lane scattered."""
    ids = ids.reshape(-1)
    grads = grads.reshape(-1, grads.shape[-1]).to(torch.float32)
    if ids.shape[0] == 0:
        return table
    sids, seg, uids, g = qz._dedup(ids, grads)

    rows = qz.dequantize_rows(table, uids)
    resid = gather_dequant_rows_plain(table.err, table.err_scale, uids)
    new_rows = rows + resid - lr * g

    absmax = new_rows.abs().amax(dim=-1, keepdim=True)
    new_scale = (absmax / 127.0).clamp_min(qz.SCALE_FLOOR).to(torch.float32)
    q_new = qz.stochastic_round(new_rows / new_scale, gen).clamp(-127, 127) \
        .to(torch.int8)
    err = new_rows - q_new.to(torch.float32) * new_scale
    eq, escale = rq.row_quantize(err)

    for dst, src in ((table.q, q_new), (table.scale, new_scale),
                     (table.err, eq), (table.err_scale, escale)):
        dst.index_put_((sids,), src[seg])
    return table


def _live_segments_only(leaves, sids, seg, uids, reduced, noise, lr):
    """What the kernel computes: the same operations on the first
    ``seg[-1] + 1`` lanes (the live segments) only, each stored once."""
    q, scale, err, err_scale = leaves
    live = int(seg[-1]) + 1
    uids, reduced, noise = uids[:live], reduced[:live], noise[:live]
    new_rows = (gather_dequant_rows_plain(q, scale, uids)
                + gather_dequant_rows_plain(err, err_scale, uids) - lr * reduced)
    absmax = new_rows.abs().amax(dim=-1, keepdim=True)
    new_scale = (absmax / 127.0).clamp_min(rq.SCALE_FLOOR)
    q_new = torch.floor(new_rows / new_scale + noise).clamp(-127, 127).to(torch.int8)
    eq, escale = rq.row_quantize(new_rows - q_new.to(torch.float32) * new_scale)
    for dst, src in ((q, q_new), (scale, new_scale), (err, eq), (err_scale, escale)):
        dst[uids] = src


def _table(rows, k, seed, device="cpu"):
    """A table whose four leaves are all in use: random payloads and
    residuals, scales over four orders of magnitude."""
    r = np.random.default_rng(seed)
    q = r.integers(-127, 128, (rows, k)).astype(np.int8)
    err = r.integers(-127, 128, (rows, k)).astype(np.int8)
    scale = (r.random((rows, 1)) * 10.0 ** r.integers(-4, 0, (rows, 1))).astype(np.float32)
    err_scale = (scale * r.random((rows, 1)) / 127).astype(np.float32)
    return qz.QuantizedTable(*(torch.as_tensor(x, device=device)
                               for x in (q, scale, err, err_scale)))


def _clone(table):
    return qz.QuantizedTable(*(t.clone() for t in table))


def _ids(case, seed, rows=ROWS):
    """The update's ids: ``distinct`` ids; ``one_id`` one id 40 times;
    ``padding`` a long run of item 0 (the history's padding) beside a few
    live ids, shuffled; ``b1`` a single id."""
    r = np.random.default_rng(seed)
    if case == "distinct":
        ids = r.permutation(rows)[:40]
    elif case == "one_id":
        ids = np.full(40, 7)
    elif case == "padding":
        ids = r.permutation(np.concatenate([np.zeros(300, np.int64),
                                            r.integers(1, rows, 9)]))
    else:
        ids = np.array([rows - 1])
    return torch.as_tensor(ids.astype(np.int64))


CASES = ["distinct", "one_id", "padding", "b1"]


def _grads(n, k, seed, device="cpu"):
    g = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return torch.as_tensor(g, device=device)


def _assert_tables_equal(a, b):
    for f, x, y in zip(qz.QuantizedTable._fields, a, b):
        assert torch.equal(x, y), f


@pytest.mark.parametrize("k", [4, 128])
@pytest.mark.parametrize("case", CASES)
def test_apply_updates_equals_the_update_before_the_kernel(case, k):
    """Two consecutive updates (the first one's residual feeds the second)
    from the same generator seeds: the same bits in all four leaves."""
    ids = _ids(case, k)
    before = _table(ROWS, k, seed=k)
    after = _clone(before)
    for step in range(2):
        grads = _grads(ids.shape[0], k, seed=10 * step + k)
        _apply_updates_before(before, ids, grads, LR,
                              torch.Generator().manual_seed(step))
        got = qz.apply_updates(after, ids, grads, LR, torch.Generator().manual_seed(step))
        assert got is after                                 # in place
        _assert_tables_equal(after, before)


@pytest.mark.parametrize("k", [4, 128])
@pytest.mark.parametrize("case", CASES)
def test_live_segments_alone_store_the_same_bits(case, k):
    """The kernel's contract on the CPU: the plain version over every lane
    stores exactly what the same operations over the live segments alone
    store; the dead lanes' work (row 0 again, unused noise rows) is lost."""
    ids = _ids(case, k + 1)
    sids, seg, uids, reduced = qz._dedup(ids, _grads(ids.shape[0], k, seed=3))
    noise = qz.uniform_noise(torch.Generator().manual_seed(4), reduced.shape, "cpu")
    plain, live = _table(ROWS, k, seed=5), _table(ROWS, k, seed=5)
    rq.requantize_rows_plain_(*plain, sids, seg, uids, reduced, noise, LR)
    _live_segments_only(live, sids, seg, uids, reduced, noise, LR)
    _assert_tables_equal(plain, live)
    assert int(seg[-1]) + 1 == torch.unique(ids).numel()


@pytest.mark.parametrize("case", CASES)
def test_rows_not_named_stay_unchanged(case):
    ids = _ids(case, 7)
    table = _table(ROWS, 16, seed=8)
    start = _clone(table)
    qz.apply_updates(table, ids, _grads(ids.shape[0], 16, seed=9), LR,
                     torch.Generator().manual_seed(1))
    rest = torch.as_tensor(np.setdiff1d(np.arange(ROWS), ids.numpy()))
    for f, x, y in zip(qz.QuantizedTable._fields, table, start):
        assert torch.equal(x[rest], y[rest]), f
    assert not torch.equal(table.q[ids], start.q[ids])


def test_meta_dispatch_runs_nothing_and_counts():
    rq.REQUANTIZE_LAUNCHES.reset()
    b, k = 50, 8

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    leaves = (meta(ROWS, k, dtype=torch.int8), meta(ROWS, 1),
              meta(ROWS, k, dtype=torch.int8), meta(ROWS, 1))
    lanes = [meta(b, dtype=torch.int64) for _ in range(3)]
    assert rq.requantize_rows_(*leaves, *lanes, meta(b, k), meta(b, k), LR) is None
    assert all(t.device.type == "meta" for t in leaves)
    assert rq.REQUANTIZE_LAUNCHES.count("meta") == 1
    assert rq.REQUANTIZE_LAUNCHES.count("cpu") == 0
    assert rq.REQUANTIZE_LAUNCHES.count("cuda") == 0


def test_launch_counter_counts_cpu_dispatches():
    rq.REQUANTIZE_LAUNCHES.reset()
    table = _table(ROWS, 8, seed=2)
    gen = torch.Generator().manual_seed(0)
    qz.apply_updates(table, torch.tensor([3, 3, 5]), _grads(3, 8, seed=1), LR, gen)
    qz.apply_updates_many(table, [(torch.tensor([1]), _grads(1, 8, seed=2)),
                                  (torch.tensor([[0, 9]]), _grads(2, 8, seed=3)
                                   .reshape(1, 2, 8))], LR, gen)
    qz.apply_updates(table, torch.zeros(0, dtype=torch.int64), torch.zeros(0, 8), LR,
                     gen)                             # no lanes: no dispatch
    assert rq.REQUANTIZE_LAUNCHES.count("cpu") == 2
    assert rq.REQUANTIZE_LAUNCHES.count("cuda") == 0
    assert rq.REQUANTIZE_LAUNCHES.count("meta") == 0


def test_requantize_rejects_mismatched_shapes():
    table = _table(ROWS, 8, seed=2)
    lanes = [torch.zeros(5, dtype=torch.int64)] * 3
    with pytest.raises(ValueError, match="expected q"):
        rq.requantize_rows_(*table, *lanes, torch.zeros(5, 8), torch.zeros(5, 7), LR)
    with pytest.raises(ValueError, match="expected q"):
        rq.requantize_rows_(*table, *lanes[:2], torch.zeros(4, dtype=torch.int64),
                            torch.zeros(5, 8), torch.zeros(5, 8), LR)


# ---- on the card ------------------------------------------------------------

def _item_b16384(gen, dev):
    """The int8 item update of batch 16,384: 1,655,808 lanes (positives,
    the tile's 1,024 slots, 100 history columns), 1,589,248 of them the
    history padding's item 0, the rest drawn over 2M rows with repeats."""
    b, run = 1_655_808, 1_589_248
    live = torch.randint(1, 2_000_000, (50_000,), generator=gen, device=dev)
    rest = live[torch.randint(0, live.numel(), (b - run,), generator=gen, device=dev)]
    ids = torch.cat([torch.zeros(run, dtype=torch.int64, device=dev), rest])
    return ids[torch.randperm(b, generator=gen, device=dev)], 2_000_000


CUDA_CASES = [(c, k) for c in CASES for k in (4, 128)] + [("item_b16384", 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,k", CUDA_CASES)
def test_cuda_kernel_matches_plain_on_the_card(cuda, case, k):
    """The kernel against the plain version run on the card, bit for bit in
    all four leaves, twice from the same inputs; its segment count against
    the host's."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(len(case) + k)
    if case == "item_b16384":
        ids, rows = _item_b16384(gen, cuda)
    else:
        ids, rows = _ids(case, k).to(cuda), ROWS
    grads = torch.randn(ids.shape[0], k, generator=gen, device=cuda)
    sids, seg, uids, reduced = qz._dedup(ids, grads)
    noise = qz.uniform_noise(gen, reduced.shape, cuda)
    start = _table(rows, k, seed=k, device=cuda)
    plain = _clone(start)
    rq.requantize_rows_plain_(*plain, sids, seg, uids, reduced, noise, LR)
    counter = rq.requantized_rows(cuda)
    rq.REQUANTIZE_LAUNCHES.reset()
    torch.cuda.synchronize()
    before = int(counter.item())
    runs = []
    for _ in range(2):
        got = _clone(start)
        rq.requantize_rows_(*got, sids, seg, uids, reduced, noise, LR)
        runs.append(got)
    torch.cuda.synchronize()
    segments = int(torch.unique(ids).numel())
    assert rq.REQUANTIZE_LAUNCHES.count("cuda") == 2
    assert int(counter.item()) - before == 2 * segments
    for got in runs:
        _assert_tables_equal(got, plain)


@pytest.mark.cuda
def test_cuda_absmax_over_127_is_a_reciprocal_multiply(cuda):
    """What the kernel repeats: on the card ``x / 127.0`` is ``x`` times the
    fp32 reciprocal of 127, not a division (which the CPU computes, one ulp
    away on some values)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.rand(1 << 20, generator=gen, device=cuda) * 10.0 ** torch.randint(
        -6, 3, (1 << 20,), generator=gen, device=cuda)
    inv = torch.tensor(1.0) / torch.tensor(127.0)          # fp32, correctly rounded
    on_card = x / 127.0
    assert torch.equal(on_card, x * inv.to(cuda))
    assert not torch.equal(on_card.cpu(), x.cpu() / 127.0)


@pytest.mark.cuda
def test_cuda_update_makes_no_host_sync(cuda):
    """``apply_updates`` on the card inside ``sanitize()`` (the readback
    guard and the sync debug mode 'error'): the segment count stays on the
    card."""
    from repro_torch.analysis.sanitize import sanitize
    gen = torch.Generator(device=cuda)
    ids = torch.cat([torch.zeros(3000, dtype=torch.int64, device=cuda),
                     torch.randint(0, ROWS, (200,), device=cuda)])
    grads = torch.randn(ids.shape[0], 128, device=cuda)
    want = _table(ROWS, 128, seed=1, device=cuda)
    got = _clone(want)
    qz.apply_updates(want, ids, grads, LR, gen.manual_seed(3))     # builds the kernel
    torch.cuda.synchronize()
    with sanitize(rank_promotion=None):
        qz.apply_updates(got, ids, grads, LR, gen.manual_seed(3))
    _assert_tables_equal(got, want)
