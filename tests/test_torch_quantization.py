"""The port's int8 tables (``repro_torch.optim.quantization``) against the
reference's (``repro.optim.quantization``).

Inputs are made with numpy from a seed and given to both packages; the
reference's stochastic-rounding noise (``jax.random.uniform`` of its key, in
the shape of every lane) is replayed into the port's ``uniform_noise``.
Tolerances: bit for bit where all of the arithmetic is exact (integer
payloads, power-of-two scales and learning rate, dyadic gradients) and
wherever the reference itself asserts bit-exactness (the kernel gather);
on random inputs, scales to 1e-6 relative, dequantized rows within one
quantization step, and int8 payloads equal on at least 99.9% of elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.optim import quantization as jqz
from repro_torch.optim import quantization as tqz

PAYLOAD_AGREEMENT = 0.999
SCALE_RTOL = 1e-6


@pytest.fixture
def replay(monkeypatch):
    """Replays queued noise arrays into the port's ``uniform_noise``, in
    call order, checking each call's shape."""
    queue = []

    def noise(gen, shape, device):
        u = queue.pop(0)
        assert tuple(shape) == u.shape
        return torch.as_tensor(np.array(u), device=device)

    monkeypatch.setattr(tqz, "uniform_noise", noise)
    yield queue
    assert not queue, "a replayed draw was not used"


def _ref_noise(rng, lanes, k):
    return np.asarray(jax.random.uniform(rng, (lanes, k), dtype=jnp.float32))


def _port(jtable):
    return tqz.QuantizedTable(*(torch.as_tensor(np.array(t)) for t in jtable))


def _assert_bit_equal(ttable, jtable):
    for f, t, j in zip(tqz.QuantizedTable._fields, ttable, jtable):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f)


def _assert_close(ttable, jtable):
    """The stated tolerance for random inputs."""
    for f in ("scale", "err_scale"):
        np.testing.assert_allclose(getattr(ttable, f).numpy(),
                                   np.asarray(getattr(jtable, f)),
                                   rtol=SCALE_RTOL, err_msg=f)
    for f in ("q", "err"):
        same = np.mean(getattr(ttable, f).numpy() == np.asarray(getattr(jtable, f)))
        assert same >= PAYLOAD_AGREEMENT, (f, same)
    deq_t = tqz.dequantize_table(ttable).numpy()
    deq_j = np.asarray(jqz.dequantize_table(jtable))
    assert np.all(np.abs(deq_t - deq_j) <= np.asarray(jtable.scale) * (1 + 1e-6))


def _rand(seed, rows, cols, spread=True):
    r = np.random.default_rng(seed)
    x = r.standard_normal((rows, cols)).astype(np.float32)
    if spread:      # rows of very different magnitudes
        x *= r.choice(np.float32([1e-4, 1e-2, 1.0, 1e2]), (rows, 1))
    return x


@pytest.mark.parametrize("seed,rows,cols", [(0, 64, 16), (1, 31, 30), (2, 512, 32)])
def test_quantize_table_matches_reference(seed, rows, cols):
    x = _rand(seed, rows, cols)
    x[3] = 0.0                                          # an all-zero row
    got = tqz.quantize_table(torch.as_tensor(x))
    want = jqz.quantize_table(jnp.asarray(x))
    _assert_close(got, want)
    assert got.q.dtype == torch.int8 and got.scale.shape == (rows, 1)
    assert float(got.scale[3, 0]) == np.float32(tqz.SCALE_FLOOR)


def test_quantize_table_bit_exact_on_exact_inputs():
    """Rows of integers /128 with an absmax of 127/128: scale 1/128, and
    every division and rounding is exact."""
    r = np.random.default_rng(3)
    x = r.integers(-127, 128, (40, 16)).astype(np.float32)
    x[:, 0] = 127
    x /= 128
    got = tqz.quantize_table(torch.as_tensor(x))
    _assert_bit_equal(got, jqz.quantize_table(jnp.asarray(x)))
    assert torch.all(got.scale == 1 / 128)


def test_quantize_table_in_chunks_equals_whole(monkeypatch):
    x = torch.as_tensor(_rand(4, 100, 8))
    whole = tqz.quantize_table(x)
    monkeypatch.setattr(tqz, "QUANTIZE_CHUNK_ROWS", 7)
    for a, b in zip(whole, tqz.quantize_table(x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("ids_shape", [(9,), (4, 3)])
def test_gather_rows_matches_reference(use_kernel, ids_shape):
    """Both layouts, any ids shape; bit for bit, as the reference holds its
    own kernel gather to its plain one."""
    x = _rand(5, 48, 16)
    ids = np.random.default_rng(6).integers(0, 48, ids_shape).astype(np.int32)
    jt = jqz.quantize_table(jnp.asarray(x))
    tt = _port(jt)
    want = np.asarray(jqz.gather_rows(jt, jnp.asarray(ids), use_kernel=use_kernel))
    got = tqz.gather_rows(tt, torch.as_tensor(ids).long(), use_kernel=use_kernel)
    assert got.shape == ids_shape + (16,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tqz.dequantize_rows(tt, torch.as_tensor(ids).long()).numpy(), want)
    fp32 = torch.as_tensor(x)
    assert torch.equal(tqz.gather_rows(fp32, torch.as_tensor(ids).long(),
                                       use_kernel=use_kernel),
                       fp32[torch.as_tensor(ids).long()])


def test_dequantize_table_and_slices_match_reference():
    jt = jqz.quantize_table(jnp.asarray(_rand(7, 20, 8)))
    tt = _port(jt)
    np.testing.assert_array_equal(tqz.dequantize_table(tt).numpy(),
                                  np.asarray(jqz.dequantize_table(jt)))
    np.testing.assert_array_equal(tqz.slice_rows(tt, 4, 9).numpy(),
                                  np.asarray(jqz.slice_rows(jt, 4, 9)))


def test_accessors_match_reference():
    x = _rand(8, 256, 64)
    jt = jqz.quantize_table(jnp.asarray(x))
    tt = _port(jt)
    fp32 = torch.as_tensor(x)
    assert tqz.num_rows(tt) == tqz.num_rows(fp32) == jqz.num_rows(jt) == 256
    assert tqz.logical_dtype(tt) == tqz.logical_dtype(fp32) == torch.float32
    assert tt.shape == (256, 64) and tt.dtype == torch.float32
    assert tqz.table_nbytes(tt) == jqz.table_nbytes(jt)
    assert tqz.carry_nbytes(tt) == jqz.carry_nbytes(jt)
    assert tqz.table_nbytes(fp32) == jqz.table_nbytes(jnp.asarray(x))
    assert tqz.table_nbytes(tt) <= 0.5 * tqz.table_nbytes(fp32)
    assert tqz.table_nbytes(tt) < tqz.carry_nbytes(tt) < tqz.table_nbytes(fp32)
    for table, ref in ((tt, jt), (fp32, jnp.asarray(x))):
        np.testing.assert_allclose(float(tqz.max_row_norm(table)),
                                   float(jqz.max_row_norm(ref)), rtol=1e-6)
        assert bool(tqz.table_all_finite(table))
    bad = tt._replace(scale=tt.scale.clone())
    bad.scale[0, 0] = float("nan")
    assert not bool(tqz.table_all_finite(bad))


def test_zero_row_table():
    t = tqz.quantize_table(torch.zeros((0, 8)))
    assert t.shape == (0, 8) and tqz.num_rows(t) == 0
    assert tqz.table_nbytes(t) == 0
    assert tqz.dequantize_table(t).shape == (0, 8)
    assert bool(tqz.table_all_finite(t))


@settings(deadline=None, database=None, max_examples=10)
@given(rows=st.integers(1, 16), cols=st.integers(1, 32))
def test_all_zero_rows_hit_the_scale_floor(rows, cols):
    t = tqz.quantize_table(torch.zeros((rows, cols)))
    assert torch.all(t.scale == np.float32(tqz.SCALE_FLOOR))
    assert torch.all(t.q == 0) and torch.all(tqz.dequantize_table(t) == 0)


@settings(deadline=None, database=None, max_examples=10)
@given(frac_pct=st.integers(0, 100), base=st.integers(-5, 5))
def test_stochastic_round_unbiased(frac_pct, base):
    """Every draw is floor(x) or ceil(x), and the mean of many lands within
    a few standard errors of x."""
    x = torch.full((4000,), base + frac_pct / 100.0)
    gen = torch.Generator().manual_seed(frac_pct * 100 + base)
    draws = tqz.stochastic_round(x, gen).numpy()
    x0 = float(x[0])
    assert set(np.unique(draws)) <= {np.floor(x0), np.ceil(x0)}
    assert abs(draws.mean() - x0) < 5 * 0.5 / np.sqrt(draws.size) + 1e-6


def test_stochastic_round_exact_on_integers():
    x = torch.arange(-3.0, 4.0)
    assert torch.equal(tqz.stochastic_round(x, torch.Generator().manual_seed(0)), x)


def _exact_table(seed, rows=24, k=16):
    """Integer payloads /128 with an absmax of 127/128 in column 0 of every
    row, so each scale is 1/128 and stays so under small updates."""
    r = np.random.default_rng(seed)
    x = r.integers(-90, 91, (rows, k)).astype(np.float32)
    x[:, 0] = 127
    return x / 128


def _exact_groups(seed, rows=24, k=16):
    """Three groups with duplicates within and across them; integer
    gradients with column 0 zero (lr 1/128 keeps the absmax at 127/128)."""
    r = np.random.default_rng(seed)

    def grads(*shape):
        g = r.integers(-3, 4, shape + (k,)).astype(np.float32)
        g[..., 0] = 0
        return g

    return [(r.integers(0, 8, 6).astype(np.int32), grads(6)),
            (r.integers(0, 8, (2, 3)).astype(np.int32), grads(2, 3)),
            (np.array([0, 0, rows - 1, 5], np.int32), grads(4))]


def test_apply_updates_many_bit_exact_on_exact_inputs(replay):
    lr = 2.0 ** -7
    jt = jqz.quantize_table(jnp.asarray(_exact_table(0)))
    groups = _exact_groups(1)
    rng = jax.random.PRNGKey(11)
    want = jqz.apply_updates_many(
        jt, [tuple(map(jnp.asarray, g)) for g in groups], lr, rng)
    lanes = sum(i.size for i, _ in groups)
    replay.append(_ref_noise(rng, lanes, 16))
    tt = _port(jt)
    got = tqz.apply_updates_many(
        tt, [(torch.as_tensor(i).long(), torch.as_tensor(g)) for i, g in groups],
        lr, None)
    assert got is tt                                      # in place
    _assert_bit_equal(got, want)
    assert torch.all(got.scale == 1 / 128)               # the inputs stayed exact


def test_apply_updates_random_inputs_within_tolerance(replay):
    """Four consecutive updates of a random table (the residual feeds
    back), duplicates within each update."""
    r = np.random.default_rng(12)
    jt = jqz.quantize_table(jnp.asarray(_rand(12, 64, 32)))
    tt = _port(jt)
    for step in range(4):
        ids = r.integers(0, 40, 48).astype(np.int32)
        g = r.standard_normal((48, 32)).astype(np.float32)
        rng = jax.random.PRNGKey(100 + step)
        jt = jqz.apply_updates(jt, jnp.asarray(ids), jnp.asarray(g), 0.05, rng)
        replay.append(_ref_noise(rng, 48, 32))
        tqz.apply_updates(tt, torch.as_tensor(ids).long(), torch.as_tensor(g),
                          0.05, None)
        _assert_close(tt, jt)


def test_zero_gradient_rows_are_requantized(replay):
    """A touched row with a zero gradient is still requantized — its
    residual folded in and rounded stochastically — as in the reference
    (masked history slots point at row 0 with a zero gradient every
    step)."""
    r = np.random.default_rng(13)
    jt = jqz.quantize_table(jnp.asarray(_rand(13, 8, 16, spread=False)))
    tt = _port(jt)
    ids = np.array([0, 0, 3], np.int32)
    for step, g in enumerate((r.standard_normal((3, 16)).astype(np.float32),
                              np.zeros((3, 16), np.float32))):
        before = [t.clone() for t in tt]
        rng = jax.random.PRNGKey(5 + step)
        jt = jqz.apply_updates(jt, jnp.asarray(ids), jnp.asarray(g), 0.1, rng)
        replay.append(_ref_noise(rng, 3, 16))
        tqz.apply_updates(tt, torch.as_tensor(ids).long(), torch.as_tensor(g),
                          0.1, None)
        _assert_close(tt, jt)
    assert not all(torch.equal(a, b) for a, b in zip(before, tt))


def test_apply_updates_deterministic_and_duplicate_reducing():
    """Same inputs and generator seed -> the same bits; duplicate ids act as
    their summed gradient; untouched rows keep their bits."""
    x = torch.as_tensor(_rand(0, 12, 8, spread=False))
    ids = torch.tensor([3, 3, 7, 3])
    g = torch.as_tensor(_rand(1, 4, 8, spread=False)) * 0.1

    def run(ids, g):
        t = tqz.quantize_table(x)
        return tqz.apply_updates(t, ids, g, 0.1, torch.Generator().manual_seed(5))

    a, b = run(ids, g), run(ids, g)
    for la, lb in zip(a, b):
        assert torch.equal(la, lb)
    c = run(torch.tensor([3, 7]), torch.stack([g[0] + g[1] + g[3], g[2]]))
    rows = torch.tensor([3, 7])
    torch.testing.assert_close(tqz.dequantize_rows(a, rows),
                               tqz.dequantize_rows(c, rows), atol=2e-2, rtol=0)
    rest = torch.tensor([0, 1, 2, 4, 5, 6, 8, 9, 10, 11])
    assert torch.equal(a.q[rest], tqz.quantize_table(x).q[rest])


def test_apply_updates_many_matches_concat():
    x = torch.as_tensor(_rand(0, 10, 8, spread=False))
    g1 = (torch.tensor([1, 2]), torch.as_tensor(_rand(1, 2, 8, spread=False)))
    g2 = (torch.tensor([2, 5]), torch.as_tensor(_rand(2, 2, 8, spread=False)))
    a = tqz.apply_updates_many(tqz.quantize_table(x), [g1, g2], 0.1,
                               torch.Generator().manual_seed(9))
    b = tqz.apply_updates(tqz.quantize_table(x), torch.cat([g1[0], g2[0]]),
                          torch.cat([g1[1], g2[1]]), 0.1,
                          torch.Generator().manual_seed(9))
    for la, lb in zip(a, b):
        assert torch.equal(la, lb)


def test_error_feedback_preserves_small_updates():
    """Per-step |lr*g| far below the quantization step still accumulates:
    N tiny updates move the row by about N*lr*g (the reference's check)."""
    t = tqz.quantize_table(torch.ones((1, 16)))
    g = torch.ones((1, 16))
    lr, n = 1e-3, 200                      # step ~0.001 << scale ~0.008
    for i in range(n):
        t = tqz.apply_updates(t, torch.tensor([0]), g, lr,
                              torch.Generator().manual_seed(i))
    moved = float(tqz.dequantize_rows(t, torch.tensor([0])).mean())
    assert abs((1.0 - moved) - n * lr) < 0.25 * n * lr


def test_dedup_compacted_layout():
    """Segment j in lane j, summed in the ids' original order; lanes past
    the last segment hold zeros."""
    ids = torch.tensor([5, 2, 5, 9, 2, 5])
    g = torch.arange(6.0)[:, None].repeat(1, 2)
    sids, seg, uids, reduced = tqz._dedup(ids, g)
    assert sids.tolist() == [2, 2, 5, 5, 5, 9]
    assert seg.tolist() == [0, 0, 1, 1, 1, 2]
    assert uids[:3].tolist() == [2, 5, 9]
    assert reduced[:, 0].tolist() == [1 + 4, 0 + 2 + 5, 3, 0, 0, 0]
