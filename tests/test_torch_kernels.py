"""The port's kernel modules against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and given to both packages.  The JAX
side runs its Pallas kernels in interpret mode, as tests/test_kernels.py
does; the port's wrappers run their plain versions on these CPU tensors.
Tolerance: 1e-5 absolute in fp32 (the reference's own kernel-parity
tolerance).  The tests marked ``cuda`` hold each CUDA kernel against its
plain version on the card and skip where there is none; they import no JAX,
so on a machine with the card and no JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.losses import ccl_loss_fused
from repro_torch.kernels import (
    _build,
    ccl_similarity,
    embedding_update,
    flash_attention,
    ops,
    ref,
)

ATOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels (imported here, not at module level, so the
    ``cuda`` tests of this file also run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import ccl_similarity as jccl
    from repro.kernels import embedding_update as jeu
    from repro.kernels import flash_attention as jfa
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return types.SimpleNamespace(jax=jax, jnp=jnp, ccl=jccl, ops=jops, eu=jeu,
                                 fa=jfa, ref=jref)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _cf(b, n, k, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, k)).astype(np.float32),
            r.standard_normal((b, k)).astype(np.float32),
            r.standard_normal((b, n, k)).astype(np.float32))


def _t(*xs, device="cpu"):
    return [torch.as_tensor(np.array(x), device=device) for x in xs]


SHAPES = [(16, 8, 32), (13, 5, 32), (16, 8, 30), (1, 3, 8)]
# The per-example backward's edges: n not a multiple of the kernel's 4 warps
# or its 8-deep ring and above 64, K = 130 (not a multiple of 4), B = 1.
BWD_EDGES = [(1, 67, 130), (3, 70, 128), (2, 192, 36), (5, 5, 130)]


@pytest.mark.parametrize("b,n,k", SHAPES)
def test_ccl_stats_matches_pallas(jx, b, n, k):
    u, p, negs = _cf(b, n, k)
    want = jx.ccl.ccl_stats_pallas(u, p, negs, block_b=min(8, b),
                                   interpret=True)
    ccl_similarity.STATS_LAUNCHES.reset()
    got = ccl_similarity.ccl_stats(*_t(u, p, negs))
    assert ccl_similarity.STATS_LAUNCHES.count("cpu") == 1
    assert ccl_similarity.STATS_LAUNCHES.count() == 0
    oracle = ref.ccl_stats_ref(*_t(u, p, negs))
    for g, o, w in zip(got, oracle, want):
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("mu,theta", [(1.0, 0.0), (1.7, 0.4)])
@pytest.mark.parametrize("b,n,k", SHAPES + BWD_EDGES)
def test_ccl_bwd_matches_pallas(jx, b, n, k, mu, theta):
    u, p, negs = _cf(b, n, k, seed=1)
    stats = [np.asarray(s) for s in
             jx.ccl.ccl_stats_pallas(u, p, negs, block_b=b, interpret=True)]
    g = np.float32(0.37 / b)
    want = jx.ccl.ccl_bwd_pallas(u, p, negs, *stats, jx.jnp.asarray(g),
                                 mu=mu, theta=theta, block_b=b, interpret=True)
    got = ccl_similarity.ccl_bwd(*_t(u, p, negs, *stats),
                                 torch.tensor([g]), mu=mu, theta=theta)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("mu,theta", [(1.0, 0.0), (1.7, 0.4)])
@pytest.mark.parametrize("b,n,k", [(16, 5, 32), (13, 8, 16)])
def test_kernel_loss_matches_pallas_loss(jx, b, n, k, mu, theta):
    u, p, negs = _cf(b, n, k, seed=2)
    fn = jx.ops.make_ccl_loss_pallas(mu=mu, theta=theta, block_b=8,
                                     interpret=True)
    want_loss, want_grads = jx.jax.value_and_grad(fn, argnums=(0, 1, 2))(
        u, p, negs)
    leaves = [x.requires_grad_() for x in _t(u, p, negs)]
    loss = ops.make_ccl_loss_kernel(mu, theta)(*leaves)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    for leaf, w in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=ATOL)
    # ... and the port's own residual-reuse loss and its autograd oracle.
    fused = ccl_loss_fused(*_t(u, p, negs), mu, theta)
    np.testing.assert_allclose(fused.item(), float(want_loss), atol=ATOL)
    for a, w in zip(ref.ccl_grads_ref(*_t(u, p, negs), mu, theta), want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL)


def _groups(seed=3, rows=50, k=8):
    """Three groups with duplicate ids within and across groups."""
    r = np.random.default_rng(seed)
    table = r.standard_normal((rows, k)).astype(np.float32)
    groups = [(r.integers(0, 10, 12).astype(np.int32),
               r.standard_normal((12, k)).astype(np.float32)),
              (r.integers(0, 10, (3, 4)).astype(np.int32),
               r.standard_normal((3, 4, k)).astype(np.float32)),
              (np.array([0, 0, 49, 9], np.int32),
               r.standard_normal((4, k)).astype(np.float32))]
    return table, groups


def test_fused_rows_update_matches_pallas_single_launch(jx):
    table, groups = _groups()
    want = jx.ops.fused_rows_update(
        jx.jnp.asarray(table), [tuple(map(jx.jnp.asarray, g)) for g in groups],
        0.1, use_kernel=True, interpret=True)
    t_groups = [(torch.as_tensor(i).long(), torch.as_tensor(g))
                for i, g in groups]
    got = torch.as_tensor(table).clone()
    embedding_update.reset_launch_count()
    out = ops.fused_rows_update(got, t_groups, 0.1)
    assert out is got                                  # in place
    assert embedding_update.launch_count("cpu") == 1   # one dispatch per call
    assert embedding_update.launch_count() == 0        # no kernel on the CPU
    ops.fused_rows_update(got.clone(), t_groups, 0.1)
    assert embedding_update.launch_count("cpu") == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    oracle = torch.as_tensor(table)
    for ids, g in t_groups:
        oracle = ref.rows_update_ref(oracle, ids, g, 0.1)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=ATOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_sparse_row_update_matches_pallas(jx, use_kernel):
    table, groups = _groups(seed=4, rows=64, k=16)
    ids, grads = groups[0]
    want = jx.ops.sparse_row_update(jx.jnp.asarray(table), jx.jnp.asarray(ids),
                                    jx.jnp.asarray(grads), 0.05,
                                    use_kernel=True, interpret=True)
    got = ops.sparse_row_update(torch.as_tensor(table).clone(),
                                torch.as_tensor(ids).long(),
                                torch.as_tensor(grads), 0.05,
                                use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_row_update_cross_group_duplicates_bit_exact():
    """Exactly representable values (integer table/grads, lr 0.5): the
    update must equal the dense oracle bit for bit, as the reference's
    test_row_update_many_cross_group_duplicate_ids_bit_parity asserts."""
    table = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    r = np.random.default_rng(7)
    pos_ids = torch.tensor([3, 7, 3, 11, 60, 7])
    neg_ids = torch.as_tensor(r.integers(0, 64, (6, 4)))
    neg_ids[0, 0], neg_ids[2, 1], neg_ids[4, 2] = 3, 7, 11
    g_pos = torch.as_tensor(r.integers(-4, 5, (6, 16)), dtype=torch.float32)
    g_neg = torch.as_tensor(r.integers(-4, 5, (6, 4, 16)), dtype=torch.float32)
    want = table.clone()
    for ids, g in ((pos_ids, g_pos), (neg_ids, g_neg)):
        for i, gr in zip(ids.reshape(-1), g.reshape(-1, 16)):
            want[i] -= 0.5 * gr
    for use_kernel in (True, False):
        got = ops.fused_rows_update(table.clone(), [(pos_ids, g_pos),
                                                    (neg_ids, g_neg)], 0.5,
                                    use_kernel=use_kernel)
        assert torch.equal(got, want)


@settings(deadline=None, database=None, max_examples=25)
@given(rows=st.integers(1, 40), b=st.integers(1, 60), seed=st.integers(0, 999))
def test_sparse_row_update_property(rows, b, seed):
    """Any duplicate pattern: the sorted fixed-order update equals the
    scatter-add oracle."""
    r = np.random.default_rng(seed)
    table = torch.as_tensor(r.standard_normal((rows, 4)), dtype=torch.float32)
    ids = torch.as_tensor(r.integers(0, rows, b))
    grads = torch.as_tensor(r.standard_normal((b, 4)), dtype=torch.float32)
    got = ops.sparse_row_update(table.clone(), ids, grads, 0.3)
    want = ref.rows_update_ref(table, ids, grads, 0.3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_wrappers_reject_bad_shapes_and_devices():
    u, p, negs = _t(*_cf(4, 3, 8))
    with pytest.raises(ValueError):
        ccl_similarity.ccl_stats(u, p[:3], negs)
    # meta tensors (the dry run) get the kernel's outputs, empty on meta,
    # and run neither the kernel nor the plain version
    ccl_similarity.STATS_LAUNCHES.reset()
    out = ccl_similarity.ccl_stats(u.to("meta"), p.to("meta"), negs.to("meta"))
    assert [tuple(x.shape) for x in out] == [(4, 1)] * 3 + [(4, 3)] * 2
    assert all(x.device.type == "meta" for x in out)
    assert [ccl_similarity.STATS_LAUNCHES.count(d)
            for d in ("meta", "cpu", "cuda")] == [1, 0, 0]
    with pytest.raises(ValueError):
        ccl_similarity.ccl_stats(u.to("meta"), p[:3].to("meta"),
                                 negs.to("meta"))
    with pytest.raises(ValueError):
        embedding_update.gather_fma_rows_(torch.zeros(5, 8), torch.arange(3),
                                          torch.arange(3), torch.zeros(3, 4),
                                          0.1)


def _int8_table(rows, k, seed=0):
    """An int8 payload and per-row scales as quantize_table makes them."""
    r = np.random.default_rng(seed)
    q = r.integers(-127, 128, (rows, k)).astype(np.int8)
    scale = (r.random((rows, 1)) * 1e-2 + 1e-4).astype(np.float32)
    return q, scale


# (rows, B, K): the existing cases, then edges of the card's kernel (a warp a
# row, in 4-byte pieces when K % 4 == 0 and in bytes otherwise, 32 pieces a
# pass): K = 100, a multiple of 4 but not of 16 (25 pieces, lanes left
# idle); K = 24 with B = 33 (a last block of 8 warps with one row); K = 128
# at more ids; and K = 130, not a multiple of 4, so 130 byte pieces, five
# passes of the warp.
DEQUANT_SHAPES = [(64, 16, 16), (50, 13, 30), (512, 40, 64), (9, 1, 3),
                  (300, 40, 100), (70, 33, 24), (1000, 70, 128), (300, 40, 130)]


def _dequant_ids(rows, b, seed):
    """Random ids with a duplicate and, from B = 4, the table's last three
    rows."""
    ids = np.random.default_rng(seed).integers(0, rows, b)
    ids[0] = ids[-1]                                      # a duplicate
    if b >= 4:
        ids[1:4] = rows - 1 - np.arange(3)                # the last rows
    return ids


@pytest.mark.parametrize("rows,b,k", DEQUANT_SHAPES)
def test_gather_dequant_plain_matches_pallas(jx, rows, b, k):
    q, scale = _int8_table(rows, k)
    ids = _dequant_ids(rows, b, 1).astype(np.int32)
    want = jx.eu.gather_dequant_rows(jx.jnp.asarray(q), jx.jnp.asarray(scale),
                                     jx.jnp.asarray(ids), interpret=True)
    got = embedding_update.gather_dequant_rows(
        torch.as_tensor(q), torch.as_tensor(scale), torch.as_tensor(ids).long())
    assert got.dtype == torch.float32 and got.shape == (b, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_dequant_counts_dispatches():
    q, scale = (torch.as_tensor(a) for a in _int8_table(20, 8))
    ids = torch.tensor([3, 3, 19])
    embedding_update.GATHER_DEQUANT_LAUNCHES.reset()
    embedding_update.gather_dequant_rows(q, scale, ids)
    embedding_update.gather_dequant_rows(q, scale, ids[:1])
    assert embedding_update.GATHER_DEQUANT_LAUNCHES.count("cpu") == 2
    assert embedding_update.GATHER_DEQUANT_LAUNCHES.count() == 0
    embedding_update.gather_dequant_rows_plain(q, scale, ids)   # not counted
    assert embedding_update.GATHER_DEQUANT_LAUNCHES.count("cpu") == 2


@pytest.mark.parametrize("shapes", [((5, 8), (5, 2), (3,)), ((5, 8), (5, 1), (3, 1)),
                                    ((5,), (5, 1), (3,))])
def test_gather_dequant_rejects_bad_shapes(shapes):
    q, scale, ids = shapes
    with pytest.raises(ValueError):
        embedding_update.gather_dequant_rows(
            torch.zeros(q, dtype=torch.int8), torch.ones(scale),
            torch.zeros(ids, dtype=torch.int64))


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    """A library is named by its source's content hash, so an edited source
    is rebuilt instead of a stale library being loaded."""
    assert _build.sources() == ["ccl_bwd", "ccl_bwd_shared", "ccl_stats",
                                "ccl_stats_shared", "flash_attention",
                                "gather_dequant", "gather_fma", "requantize_rows",
                                "segment_sum"]
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("// v1\n")
    first = _build._target("k")
    (tmp_path / "k.cu").write_text("// v2\n")
    second = _build._target("k")
    assert first != second and first.parent == tmp_path / "build"
    assert _build.sources() == ["k"]


# --------------------------------------------------------------------------
# Step-shared layout (the LM HEAT head) and flash attention.
# --------------------------------------------------------------------------

def _shared(t, n, k, seed=0):
    """Hidden-like rows u (unit normal), table-like p and negs (0.1 scale)."""
    r = np.random.default_rng(seed)
    return (r.standard_normal((t, k)).astype(np.float32),
            (0.1 * r.standard_normal((t, k))).astype(np.float32),
            (0.1 * r.standard_normal((n, k))).astype(np.float32))


def _near_orthogonal(t, n, k, seed=0):
    """:func:`_shared`'s inputs with each row of u projected, in fp64, onto
    the orthogonal complement of the negatives before it is rounded to fp32:
    every u.n_j is then of order 1e-7 while its partial sums over K are of
    order 1."""
    u, p, negs = _shared(t, n, k, seed)
    basis, _ = np.linalg.qr(negs.astype(np.float64).T)          # (K, n)
    u64 = u.astype(np.float64)
    return (u64 - (u64 @ basis) @ basis.T).astype(np.float32), p, negs


def test_near_orthogonal_case_needs_fp64_sums():
    """The card case "orthogonal" of test_cuda_shared_ccl_kernels_match_plain
    guards the fp64 contract: on its inputs a sequential fp32 sum over K
    (each product and add rounded to fp32, as a SIMT loop would) breaks the
    kernel tolerance 1e-6 + 1e-5*|exact|, and the plain version (fp64 sums)
    meets it."""
    u, _, negs = _near_orthogonal(256, 64, 960, seed=7)
    exact = u.astype(np.float64) @ negs.astype(np.float64).T
    tol = 1e-6 + 1e-5 * np.abs(exact)
    assert np.abs(exact).max() < 1e-5                    # nearly orthogonal
    acc = np.zeros(exact.shape, np.float32)
    for kk in range(u.shape[1]):
        acc += u[:, kk:kk + 1] * negs[None, :, kk]
    assert (np.abs(acc - exact) > tol).any()
    un = ccl_similarity.ccl_stats_shared_plain(*_t(u, u, negs))[4]
    assert (np.abs(un.numpy() - exact) <= tol).all()


# (T, n, K, block_b of the reference kernel): T a multiple of the block and
# not, and T smaller than the block.
SHARED_SHAPES = [(16, 8, 32, 8), (13, 5, 32, 8), (300, 8, 16, 256),
                 (40, 3, 30, 16)]


@pytest.mark.parametrize("t,n,k,bb", SHARED_SHAPES)
def test_ccl_stats_shared_matches_pallas(jx, t, n, k, bb):
    u, p, negs = _shared(t, n, k)
    tp = -(-t // bb) * bb                       # the reference pads to blocks
    pad = ((0, tp - t), (0, 0))
    want = jx.ccl.ccl_stats_shared_pallas(np.pad(u, pad), np.pad(p, pad), negs,
                                          block_b=bb, interpret=True)
    ccl_similarity.SHARED_STATS_LAUNCHES.reset()
    got = ccl_similarity.ccl_stats_shared(*_t(u, p, negs))
    assert ccl_similarity.SHARED_STATS_LAUNCHES.count("cpu") == 1
    assert ccl_similarity.SHARED_STATS_LAUNCHES.count() == 0
    for g, w in zip(got, want):
        w = np.asarray(w)
        w = w if w.shape[0] == 1 else w[:t]         # nn is (1, n)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("mu,theta", [(1.0, 0.0), (1.7, 0.1)])
@pytest.mark.parametrize("t,n,k,bb", SHARED_SHAPES)
def test_ccl_bwd_shared_matches_pallas(jx, t, n, k, bb, mu, theta):
    u, p, negs = _shared(t, n, k, seed=1)
    r = np.random.default_rng(2)
    w = (r.random((t, 1)) / t).astype(np.float32)
    w[::3] = 0.0                                   # masked rows
    tp = -(-t // bb) * bb
    pad = ((0, tp - t), (0, 0))
    u_p, p_p, w_p = np.pad(u, pad), np.pad(p, pad), np.pad(w, pad)
    stats = [np.asarray(s) for s in jx.ccl.ccl_stats_shared_pallas(
        u_p, p_p, negs, block_b=bb, interpret=True)]
    g = np.float32(1.3)
    want = jx.ccl.ccl_bwd_shared_pallas(u_p, p_p, negs, *stats, w_p,
                                        jx.jnp.asarray(g), mu=mu, theta=theta,
                                        block_b=bb, interpret=True)
    cut = [s[:t] if s.shape[0] == tp else s for s in stats]
    ccl_similarity.SHARED_BWD_LAUNCHES.reset()
    got = ccl_similarity.ccl_bwd_shared(*_t(u, p, negs, *cut, w),
                                        torch.tensor([g]), mu=mu, theta=theta)
    assert ccl_similarity.SHARED_BWD_LAUNCHES.count("cpu") == 1
    for a, want_a in zip(got, (np.asarray(want[0])[:t], np.asarray(want[1])[:t],
                               np.asarray(want[2]))):
        np.testing.assert_allclose(a.numpy(), want_a, atol=ATOL)
    # Masked rows get exactly zero gradients.
    assert not got[0][::3].any() and not got[1][::3].any()


@pytest.mark.parametrize("mu,theta", [(1.0, 0.0), (1.7, 0.1)])
@pytest.mark.parametrize("t,n,k", [(16, 5, 32), (37, 8, 16)])
def test_shared_kernel_loss_matches_pallas_loss(jx, t, n, k, mu, theta):
    u, p, negs = _shared(t, n, k, seed=3)
    w = np.full((t,), 1.0 / t, np.float32)
    w[1] = 0.0
    fn = jx.ops.make_ccl_loss_shared_pallas(mu=mu, theta=theta, block_b=8,
                                            interpret=True)
    want_loss, want_grads = jx.jax.value_and_grad(fn, argnums=(0, 1, 2, 3))(
        u, p, negs, w)
    leaves = [x.requires_grad_() for x in _t(u, p, negs, w)]
    loss = ops.make_ccl_loss_shared_kernel(mu, theta)(*leaves)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    for leaf, want_g in zip(leaves, want_grads):
        assert leaf.grad.shape == tuple(np.shape(want_g))
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_g),
                                   atol=ATOL)


def _qkv(b, hq, hkv, s, d, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, hq, s, d)).astype(np.float32),
            r.standard_normal((b, hkv, s, d)).astype(np.float32),
            r.standard_normal((b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,s,d", [(2, 4, 2, 32, 16), (1, 3, 1, 16, 8),
                                          (1, 2, 2, 24, 8)])
def test_attention_matches_flash_pallas(jx, b, hq, hkv, s, d, causal):
    q, k, v = _qkv(b, hq, hkv, s, d)
    want = np.asarray(jx.fa.flash_attention(q, k, v, causal=causal, block_q=8,
                                            block_k=8, interpret=True))
    np.testing.assert_allclose(
        np.asarray(jx.ref.attention_ref(q, k, v, causal=causal)), want,
        atol=ATOL)
    flash_attention.FLASH_LAUNCHES.reset()
    for got in (ops.attention(*_t(q, k, v), causal=causal),
                ops.attention(*_t(q, k, v), causal=causal, use_kernel=False),
                ref.attention_ref(*_t(q, k, v), causal=causal)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert flash_attention.FLASH_LAUNCHES.count("cpu") == 1
    assert flash_attention.FLASH_LAUNCHES.count() == 0


def test_shared_and_flash_wrappers_reject_bad_shapes():
    u, p, negs = _t(*_shared(4, 3, 8))
    with pytest.raises(ValueError):
        ccl_similarity.ccl_stats_shared(u, p[:3], negs)
    with pytest.raises(ValueError):
        ccl_similarity.ccl_stats_shared(u, p, negs[:, :4])
    out = ccl_similarity.ccl_stats_shared(u.to("meta"), p.to("meta"),
                                          negs.to("meta"))
    assert [tuple(x.shape) for x in out] == [(4, 1)] * 3 + [(1, 3), (4, 3)]
    with pytest.raises(ValueError):
        ccl_similarity.ccl_stats_shared(u.to("meta"), p.to("meta"),
                                        negs[:, :4].to("meta"))
    q, k, v = _t(*_qkv(1, 3, 2, 8, 4))
    with pytest.raises(ValueError):                # Hq not a multiple of Hkv
        flash_attention.flash_attention(q, k, v)
    q, k, v = _t(*_qkv(1, 2, 1, 8, 4))
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, k[:, :, :4], v[:, :, :4])


# --------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version.
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k", SHAPES + [(1024, 64, 128)])
def test_cuda_ccl_kernels_match_plain(cuda, b, n, k):
    u, p, negs = _t(*_cf(b, n, k, seed=5), device=cuda)
    ccl_similarity.STATS_LAUNCHES.reset()
    ccl_similarity.BWD_LAUNCHES.reset()
    stats = ccl_similarity.ccl_stats(u, p, negs)
    for a, w in zip(stats, ccl_similarity.ccl_stats_plain(u, p, negs)):
        torch.testing.assert_close(a, w, atol=ATOL, rtol=1e-5)
    g = torch.tensor([0.37 / b], device=cuda)
    got = ccl_similarity.ccl_bwd(u, p, negs, *stats, g, mu=1.3, theta=0.1)
    want = ccl_similarity.ccl_bwd_plain(u, p, negs, *stats, g, mu=1.3,
                                        theta=0.1)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=ATOL, rtol=1e-5)
    torch.cuda.synchronize()
    assert ccl_similarity.STATS_LAUNCHES.count() == 1
    assert ccl_similarity.BWD_LAUNCHES.count() == 1


def _row_update_ids(r, rows, b, case):
    """The ids of a row-update case: ``"dup"`` draws from the first
    ``min(rows, b // 2)`` rows (duplicates); ``"run"`` also gives row 7 a
    run of 100 equal ids (longer than a warp); ``"last"`` draws from the
    table's last 64 rows."""
    if case == "last":
        return rows - 1 - r.integers(0, 64, b)
    ids = r.integers(0, min(rows, b // 2), b)
    if case == "run":
        ids[r.permutation(b)[:100]] = 7
    return ids


# (rows, B, K, ids): the existing cases; a run of more than 32 equal ids;
# K % 4 != 0 (the scalar path) and K = 256 (two float4 per lane); a table of
# more than 2^31 bytes (4,195,328 x 128 fp32, 2.15 GB) updated at its last
# rows, so 64-bit row offsets are needed.
@pytest.mark.cuda
@pytest.mark.parametrize("rows,b,k,case", [(50, 40, 8, "dup"),
                                           (400_000, 2048, 128, "dup"),
                                           (1000, 300, 128, "run"),
                                           (5000, 512, 100, "run"),
                                           (5000, 512, 256, "run"),
                                           (2 ** 31 // 512 + 1024, 2048, 128,
                                            "last")])
def test_cuda_gather_fma_matches_plain_and_repeats(cuda, rows, b, k, case):
    r = np.random.default_rng(6)
    if rows * k * 4 > 2 ** 31:              # 537M values: drawn on the card
        gen = torch.Generator(device=cuda)
        gen.manual_seed(6)
        table = torch.randn(rows, k, generator=gen, device=cuda)
    else:
        table = torch.as_tensor(r.standard_normal((rows, k)),
                                dtype=torch.float32, device=cuda)
    ids = torch.as_tensor(_row_update_ids(r, rows, b, case), device=cuda)
    grads = torch.as_tensor(r.standard_normal((b, k)), dtype=torch.float32,
                            device=cuda)
    embedding_update.reset_launch_count()
    got = ops.sparse_row_update(table.clone(), ids, grads, 0.05)
    again = ops.sparse_row_update(table.clone(), ids, grads, 0.05)
    want = ops.sparse_row_update(table.clone(), ids, grads, 0.05,
                                 use_kernel=False)
    torch.cuda.synchronize()
    assert embedding_update.launch_count() == 2
    assert torch.equal(got, again)                     # same bits every run
    torch.testing.assert_close(got, want, atol=ATOL, rtol=1e-5)
    torch.testing.assert_close(got, ref.rows_update_ref(table, ids, grads, 0.05),
                               atol=ATOL, rtol=1e-5)


# Beyond the CPU cases: the MF step's 1,024 and 16,384 ids; at 700 ids,
# K = 100 (25 4-byte pieces), K = 256 (64 4-byte pieces, two passes of the
# warp) and K = 130 (130 byte pieces, five passes); and a table of more than
# 2^31 bytes (16,778,240 x 128 int8, 2.15 GB) read at its last rows, so
# 64-bit row offsets are needed.
@pytest.mark.cuda
@pytest.mark.parametrize("rows,b,k", DEQUANT_SHAPES + [(400_000, 1024, 128),
                                                       (400_000, 16384, 128),
                                                       (5000, 700, 100),
                                                       (5000, 700, 256),
                                                       (5000, 700, 130),
                                                       (2 ** 31 // 128 + 1024, 2048,
                                                        128)])
def test_cuda_gather_dequant_matches_plain(cuda, rows, b, k):
    if rows * k > 2 ** 31:                  # 2.15 GB: drawn on the card
        gen = torch.Generator(device=cuda)
        gen.manual_seed(2)
        q = torch.randint(-127, 128, (rows, k), generator=gen, device=cuda,
                          dtype=torch.int8)
        scale = torch.rand(rows, 1, generator=gen, device=cuda) * 1e-2 + 1e-4
        ids = torch.as_tensor(rows - 1 - np.random.default_rng(2).integers(0, 64, b),
                              device=cuda)
    else:
        q, scale = (torch.as_tensor(a, device=cuda) for a in _int8_table(rows, k))
        ids = torch.as_tensor(_dequant_ids(rows, b, 2), device=cuda)
    embedding_update.GATHER_DEQUANT_LAUNCHES.reset()
    got = embedding_update.gather_dequant_rows(q, scale, ids)
    torch.cuda.synchronize()
    assert embedding_update.GATHER_DEQUANT_LAUNCHES.count() == 1
    assert torch.equal(got, embedding_update.gather_dequant_rows_plain(q, scale, ids))


# (T, n, K, rows): the existing shapes; n > 64 (two negative blocks, the
# second ragged); a ragged K (4-byte copies); and the head's shape with u's
# rows made nearly orthogonal to the negatives, where only an fp64 sum meets
# the tolerance (test_near_orthogonal_case_needs_fp64_sums).
@pytest.mark.cuda
@pytest.mark.parametrize("t,n,k,rows", [(13, 5, 32, "normal"),
                                        (300, 8, 30, "normal"),
                                        (1000, 64, 64, "normal"),
                                        (8184, 64, 960, "normal"),
                                        (1000, 130, 96, "normal"),
                                        (8184, 64, 962, "normal"),
                                        (8184, 64, 960, "orthogonal")])
def test_cuda_shared_ccl_kernels_match_plain(cuda, t, n, k, rows):
    make = _near_orthogonal if rows == "orthogonal" else _shared
    u, p, negs = _t(*make(t, n, k, seed=7), device=cuda)
    w = torch.full((t, 1), 1.0 / t, device=cuda)
    w[::5] = 0.0
    ccl_similarity.SHARED_STATS_LAUNCHES.reset()
    ccl_similarity.SHARED_BWD_LAUNCHES.reset()
    stats = ccl_similarity.ccl_stats_shared(u, p, negs)
    again = ccl_similarity.ccl_stats_shared(u, p, negs)
    for a, b_, want in zip(stats, again,
                           ccl_similarity.ccl_stats_shared_plain(u, p, negs)):
        assert torch.equal(a, b_)                       # same bits every run
        torch.testing.assert_close(a, want, atol=1e-6, rtol=1e-5)
    g = torch.tensor([float(t)], device=cuda)           # per-row weight x g = 1
    args = (u, p, negs, *stats, w, g)
    got = ccl_similarity.ccl_bwd_shared(*args, mu=1.3, theta=0.1)
    again = ccl_similarity.ccl_bwd_shared(*args, mu=1.3, theta=0.1)
    want = ccl_similarity.ccl_bwd_shared_plain(*args, mu=1.3, theta=0.1)
    for a, b_, want_a in zip(got, again, want):
        assert torch.equal(a, b_)
        torch.testing.assert_close(a, want_a, atol=1e-6, rtol=1e-5)
    assert not got[0][::5].any() and not got[1][::5].any()
    torch.cuda.synchronize()
    assert ccl_similarity.SHARED_STATS_LAUNCHES.count() == 2
    assert ccl_similarity.SHARED_BWD_LAUNCHES.count() == 2


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,s,d", [(1, 2, 1, 64, 32), (2, 6, 2, 128, 64),
                                          (1, 4, 4, 192, 128),
                                          (8, 15, 5, 1024, 64)])
def test_cuda_flash_attention_matches_plain(cuda, b, hq, hkv, s, d, causal):
    q, k, v = _t(*_qkv(b, hq, hkv, s, d, seed=8), device=cuda)
    flash_attention.FLASH_LAUNCHES.reset()
    got = ops.attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.FLASH_LAUNCHES.count() == 1
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):                     # S % 64 != 0
        flash_attention.flash_attention(q[:, :, :40], k[:, :, :40],
                                        v[:, :, :40])


# The redesigned shared backward's edges: T not a multiple of its 32-row
# chunks or of its slabs, K not a multiple of its 64- or 32-column tiles,
# n below one 16-wide MMA tile, at one tile group (64) and at the most the
# kernel takes (192, its 32-column layout); rows with w = 0; two calls
# compared bit for bit.
@pytest.mark.cuda
@pytest.mark.parametrize("t,n,k", [(1007, 8, 100), (1007, 8, 960),
                                   (1007, 64, 100), (8183, 64, 960),
                                   (1007, 192, 100), (1007, 192, 960),
                                   (45, 5, 962)])
def test_cuda_ccl_bwd_shared_edges_repeat(cuda, t, n, k):
    u, p, negs = _t(*_shared(t, n, k, seed=9), device=cuda)
    w = torch.full((t, 1), 1.0 / t, device=cuda)
    w[::7] = 0.0
    w[-1] = 0.0                                         # the ragged last row
    stats = ccl_similarity.ccl_stats_shared_plain(u, p, negs)
    g = torch.tensor([float(t)], device=cuda)
    args = (u, p, negs, *stats, w, g)
    ccl_similarity.SHARED_BWD_LAUNCHES.reset()
    got = ccl_similarity.ccl_bwd_shared(*args, mu=1.3, theta=0.05)
    again = ccl_similarity.ccl_bwd_shared(*args, mu=1.3, theta=0.05)
    want = ccl_similarity.ccl_bwd_shared_plain(*args, mu=1.3, theta=0.05)
    torch.cuda.synchronize()
    assert ccl_similarity.SHARED_BWD_LAUNCHES.count() == 2
    for a, b_, want_a in zip(got, again, want):
        assert a.shape == want_a.shape
        assert torch.equal(a, b_)                       # same bits every run
        torch.testing.assert_close(a, want_a, atol=1e-6, rtol=1e-5)
    for x in got[:2]:
        assert not x[::7].any() and not x[-1].any()


# The redesigned flash kernel's edges: every head width it takes, causal and
# full, one key tile (S = 64) and sixteen (S = 1,024), with GQA; two calls
# compared bit for bit.
@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 1024])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_flash_attention_edges_repeat(cuda, d, s, causal):
    q, k, v = _t(*_qkv(2, 6, 2, s, d, seed=10), device=cuda)
    flash_attention.FLASH_LAUNCHES.reset()
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    again = flash_attention.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.FLASH_LAUNCHES.count() == 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


# The redesigned per-example backward's edges: B = 1 and a ragged B, n below
# one warp per negative, at 64, not a multiple of the 4 warps or the 8-deep
# ring, 192, and the wrapper's most, 4,096 (past 48 KB of shared memory); K
# not a multiple of 4 (the scalar path), 128 (one float4 panel) and 130;
# theta = 0.05 so that some masks are 0; two calls compared bit for bit; and
# the negatives one float off 16-byte alignment (the scalar path at K = 128).
@pytest.mark.cuda
@pytest.mark.parametrize("k", [30, 128, 130])
@pytest.mark.parametrize("n", [5, 64, 67, 192, 4096])
@pytest.mark.parametrize("b", [1, 37])
def test_cuda_ccl_bwd_edges_repeat(cuda, b, n, k):
    u, p, negs = _t(*_cf(b, n, k, seed=11), device=cuda)
    stats = ccl_similarity.ccl_stats_plain(u, p, negs)
    g = torch.tensor([0.37 / b], device=cuda)
    theta = 0.05
    cos = stats[4] * torch.rsqrt(stats[0] + 1e-12) * torch.rsqrt(stats[3] + 1e-12)
    if b * n >= 64:
        assert bool((cos > theta).any()) and bool((cos <= theta).any())
    shifted = torch.empty(negs.numel() + 1, device=cuda)[1:].view(negs.shape)
    shifted.copy_(negs)                                 # 4 bytes off alignment
    ccl_similarity.BWD_LAUNCHES.reset()
    got = ccl_similarity.ccl_bwd(u, p, negs, *stats, g, mu=1.3, theta=theta)
    again = ccl_similarity.ccl_bwd(u, p, negs, *stats, g, mu=1.3, theta=theta)
    unaligned = ccl_similarity.ccl_bwd(u, p, shifted, *stats, g, mu=1.3, theta=theta)
    want = ccl_similarity.ccl_bwd_plain(u, p, negs, *stats, g, mu=1.3, theta=theta)
    torch.cuda.synchronize()
    assert ccl_similarity.BWD_LAUNCHES.count() == 3
    for a, b_, c, want_a in zip(got, again, unaligned, want):
        assert a.shape == want_a.shape
        assert torch.equal(a, b_)                       # same bits every run
        torch.testing.assert_close(a, want_a, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(c, want_a, atol=1e-6, rtol=1e-5)


# The redesigned per-example stats kernel's edges: B = 1 and a ragged B; n
# below one 16-negative warp group, at 64, not a multiple of 16, 192 and the
# backward's most, 4,096; K not a multiple of 4 (the scalar path), 128 (one
# float4 panel) and 130 (five scalar panels); two calls compared bit for
# bit; and the negatives one float off 16-byte alignment (the scalar path at
# K = 128).  The inputs are 0.1 x unit normal, the scale of the MF tables
# (init std 0.1) at which chip_smoke.py holds the kernel to 1e-6 +
# 1e-5*|plain|: at unit scale an fp32 sum of 128 products near 11 is off by
# about 1e-5 in any order, so a near-zero u.n_j could not meet 1e-6.
@pytest.mark.cuda
@pytest.mark.parametrize("k", [30, 128, 130])
@pytest.mark.parametrize("n", [5, 64, 67, 192, 4096])
@pytest.mark.parametrize("b", [1, 37])
def test_cuda_ccl_stats_edges_repeat(cuda, b, n, k):
    u, p, negs = (0.1 * x for x in _t(*_cf(b, n, k, seed=13), device=cuda))
    shifted = torch.empty(negs.numel() + 1, device=cuda)[1:].view(negs.shape)
    shifted.copy_(negs)                                 # 4 bytes off alignment
    ccl_similarity.STATS_LAUNCHES.reset()
    got = ccl_similarity.ccl_stats(u, p, negs)
    again = ccl_similarity.ccl_stats(u, p, negs)
    unaligned = ccl_similarity.ccl_stats(u, p, shifted)
    want = ccl_similarity.ccl_stats_plain(u, p, negs)
    torch.cuda.synchronize()
    assert ccl_similarity.STATS_LAUNCHES.count() == 3
    for a, b_, c, want_a in zip(got, again, unaligned, want):
        assert a.shape == want_a.shape
        assert torch.equal(a, b_)                       # same bits every run
        torch.testing.assert_close(a, want_a, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(c, want_a, atol=1e-6, rtol=1e-5)


# The chunked top-k on the card, where cuBLAS picks the product's algorithm
# by shape: integer embeddings scored with similarity="dot" are exact in any
# order and tie often (a duplicated item row ties for sure), so the ids must
# equal numpy's stable argsort, at chunks that do not divide the catalog
# and on the dense path.
@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [997, 4096, None])
def test_cuda_topk_ties_match_stable_argsort(cuda, chunk):
    from repro_torch.core import mf
    r = np.random.default_rng(21)
    items = r.integers(-2, 3, (10_007, 8)).astype(np.float32)
    items[5000] = items[3]
    users = r.integers(-2, 3, (64, 8)).astype(np.float32)
    params = mf.MFParams(*_t(users, items, device=cuda), None)
    want = np.argsort(-(users @ items.T), axis=1, kind="stable")[:, :50]
    got = mf.topk_all_items(params, torch.arange(64, device=cuda), 50,
                            similarity="dot", item_chunk=chunk)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)


# A streaming round on the card (the ring, the recency sampler, the tile
# negatives and the live server refresh) trains through the kernels of the
# MF step: one stats, one backward and two gather-FMA launches a step, and a
# crash resumes bit for bit.
@pytest.mark.cuda
def test_cuda_streaming_round_launches_the_mf_kernels(cuda, tmp_path):
    from repro_torch.core import mf
    from repro_torch.stream.service import StreamingConfig, StreamingTrainer
    from repro_torch.stream.sources import SyntheticStream
    cfg = mf.MFConfig(num_users=300, num_items=500, emb_dim=32,
                      num_negatives=16, tile_size=64, refresh_interval=8,
                      backend="pallas", update_impl="pallas")

    def service(name, **kw):
        return StreamingTrainer(
            cfg, SyntheticStream(300, 500, seed=0, user_drift=0.01),
            StreamingConfig(capacity=8, micro_batch=128, steps_per_round=8,
                            batch_size=64, ckpt_dir=str(tmp_path / name),
                            ckpt_every=2, **kw), device=cuda,
            log=lambda *_: None)

    counters = (ccl_similarity.STATS_LAUNCHES, ccl_similarity.BWD_LAUNCHES,
                embedding_update.GATHER_FMA_LAUNCHES)
    for c in counters:
        c.reset()
    clean = service("clean")
    assert clean.run(rounds=5) == 5
    torch.cuda.synchronize()
    assert [c.count() for c in counters] == [40, 40, 80]
    crashed = service("crashed", fail_at_event=3 * 128 + 5)
    assert crashed.run(rounds=5) == 5 and crashed.restarts == 1
    for a, b in ((clean.state.params.user_table, crashed.state.params.user_table),
                 (clean.state.params.item_table, crashed.state.params.item_table),
                 (clean.data.train_pos, crashed.data.train_pos),
                 (clean.data.item_weights, crashed.data.item_weights)):
        assert torch.equal(a, b)
    assert clean.loss_history() == crashed.loss_history()
