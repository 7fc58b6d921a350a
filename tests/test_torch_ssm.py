"""The port's Mamba2 mixer (``models/ssm.py``) and M-RoPE
(``models/layers.py``) against the JAX package, function by function.

Inputs are made with numpy from a seed, at the reduced configs' widths
(d=64, d_inner 128, heads of 16, state 16) and at ``ssm_groups`` 1 and 2
(with two groups the order of ``jnp.repeat`` over the heads shows).
Tolerance: 1e-5 absolute for fp32 results, the ROADMAP's tolerance, or
1e-5 of the largest element where stated.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import layers, lm, ssm
from repro_torch.models.params import tree_items

ATOL = 1e-5
B, S = 2, 19


def _x(shape, seed=0, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cfgs(groups=1):
    jc = dataclasses.replace(jget_config("mamba2-370m").reduced(), ssm_groups=groups)
    tc = dataclasses.replace(get_config("mamba2-370m").reduced(), ssm_groups=groups)
    return jc, tc


def _mamba_params(tc, seed=0) -> dict:
    """One unstacked mixer's parameters at the reference's init scales,
    drawn with numpy; ``a_log`` and ``dt_bias`` drawn too (the reference
    starts them at zero) so every term of the recurrence varies by head."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in tree_items(ssm.mamba_defs(tc, 0)):
        a = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "scaled_fan_in":
            a /= np.sqrt(d.shape[-2])
        elif d.init == "normal":
            a *= d.scale
        else:
            a *= 0.3
            if d.init == "ones":
                a += 1.0
        out[name] = a
    return out


def _ssd_inputs(b=B, s=S, h=4, p=8, n=16, seed=0):
    """xdt, dA, B, C of the scan with dt = softplus(N(0, 1)) and A = -1."""
    r = np.random.default_rng(seed)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    xdt = r.standard_normal((b, s, h, p)).astype(np.float32) * dt[..., None]
    bb = 0.25 * r.standard_normal((b, s, h, n)).astype(np.float32)
    cc = 0.25 * r.standard_normal((b, s, h, n)).astype(np.float32)
    return xdt, -dt, bb, cc


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _scale_tol(want) -> float:
    return ATOL * max(1.0, float(np.abs(want).max()))


# --------------------------------------------------------------------------
# The mixer's pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cw,s", [(4, 19), (4, 2), (2, 7)])
def test_causal_conv_matches_reference(cw, s):
    u, w = _x((B, s, 24), 0), _x((cw, 24), 1)
    np.testing.assert_allclose(ssm._causal_conv(*_t(u, w)).numpy(),
                               np.asarray(jssm._causal_conv(u, w)), atol=ATOL)


@pytest.mark.parametrize("s,chunk", [(16, 8), (19, 8), (5, 8), (24, 6)])
def test_ssd_chunked_matches_reference(s, chunk):
    """The output and the final state, with S a multiple of the chunk and
    not (the zero-padded tail), and with S shorter than one chunk."""
    args = _ssd_inputs(s=s)
    want_y, want_state = jssm._ssd_chunked(*args, chunk)
    y, state = ssm._ssd_chunked(*_t(*args), chunk)
    assert y.shape == tuple(want_y.shape) and state.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), atol=ATOL)


def _ssd_loss_grads(args, chunk):
    """Gradients of sum(y^2) + sum(state), scaled by 1e-3, with respect to
    every input of the scan, in both packages."""
    def jloss(*a):
        y, st = jssm._ssd_chunked(*a, chunk)
        return (jnp.sum(y ** 2) + jnp.sum(st)) * 1e-3
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in args))
    leaves = [t.requires_grad_() for t in _t(*args)]
    y, st = ssm._ssd_chunked(*leaves, chunk)
    got = torch.autograd.grad(((y ** 2).sum() + st.sum()) * 1e-3, leaves)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_ssd_gradient_matches_reference_at_chunk_8():
    want, got = _ssd_loss_grads(_ssd_inputs(s=S), 8)
    for w, g, name in zip(want, got, ("xdt", "dA", "B", "C")):
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=name)


def test_ssd_chunk_256_gradient_is_finite_where_the_reference_overflows():
    """ROADMAP.md C.7.  At the configs' chunk of 256 on S = 512 the sum of
    |dt * A| above the diagonal passes 88: the reference's
    ``where(mask, exp(diff), 0)`` is finite forward, but its backward
    multiplies the zero cotangent by ``inf``, so its gradient with respect
    to dA is not finite; the port masks before the ``exp``.  The forward
    agrees with the reference's within 1e-5 of the largest output
    (measured: 3.0e-5 absolute at outputs up to 3.57; both are about 2e-5
    from the exact float64 recurrence at this chunk, the cumulative sums of
    up to 180 carrying absolute rounding into the decays), and the port's
    gradient equals its own and the reference's at chunk 64, the same
    function in other chunks (measured: 1.7e-7)."""
    args = _ssd_inputs(b=1, s=512)
    want_y, _ = jssm._ssd_chunked(*args, 256)
    y, _ = ssm._ssd_chunked(*_t(*args), 256)
    assert np.abs(y.numpy() - np.asarray(want_y)).max() <= _scale_tol(want_y)

    want, got = _ssd_loss_grads(args, 256)
    assert not np.isfinite(want[1]).all()              # the reference's dA
    assert all(np.isfinite(g).all() for g in got)
    want64, got64 = _ssd_loss_grads(args, 64)
    assert all(np.isfinite(w).all() for w in want64)
    for g, g64, w64, name in zip(got, got64, want64, ("xdt", "dA", "B", "C")):
        np.testing.assert_allclose(g, g64, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(g, w64, atol=ATOL, err_msg=name)


def test_broadcast_groups_is_jnp_repeat_not_tensor_repeat():
    t = _x((B, 3, 2 * 5), 0)
    want = np.asarray(jssm._broadcast_groups(jnp.asarray(t), 6, 2, 5))
    got = ssm._broadcast_groups(torch.as_tensor(t), 6, 2, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    tiled = torch.as_tensor(t).reshape(B, 3, 2, 5).repeat(1, 1, 3, 1)
    assert not torch.equal(got, tiled)      # group 0 feeds heads 0-2, not 0, 2, 4


def test_mamba_cache_init_and_defs():
    _, tc = _cfgs(groups=2)
    c = ssm.mamba_cache_init(tc, 3, dtype=torch.bfloat16)
    d_in = tc.ssm_expand * tc.d_model
    assert c.conv.shape == (3, tc.conv_width - 1, d_in + 2 * 2 * tc.ssm_state)
    assert c.conv.dtype == torch.bfloat16 and c.state.dtype == torch.float32
    assert c.state.shape == (3, d_in // tc.ssm_head_dim, tc.ssm_state,
                             tc.ssm_head_dim)
    assert not c.conv.any() and not c.state.any()
    jc, _ = _cfgs(groups=2)
    jc_ = jssm.mamba_cache_init(jc, 3)
    assert (c.conv.shape, c.state.shape) == (jc_.conv.shape, jc_.state.shape)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_apply_matches_reference(groups):
    """Output, the final conv window and the final state, at S = 19 (not a
    multiple of the chunk of 8)."""
    jc, tc = _cfgs(groups)
    p = _mamba_params(tc)
    x = _x((B, S, tc.d_model), 5)
    want, want_c = jssm.mamba_apply(p, x, jc)
    got, got_c = ssm.mamba_apply({k: torch.as_tensor(v) for k, v in p.items()},
                                 torch.as_tensor(x), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_c.conv.numpy(), np.asarray(want_c.conv), atol=ATOL)
    np.testing.assert_allclose(got_c.state.numpy(), np.asarray(want_c.state),
                               atol=ATOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_decode_fed_the_reference_cache_matches(groups):
    """The reference's prefill cache into the port's one-token step: the
    output and the advanced window and state; the cache passed in is not
    written."""
    jc, tc = _cfgs(groups)
    p = _mamba_params(tc, seed=1)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    x = _x((B, S + 1, tc.d_model), 6)
    _, jcache = jssm.mamba_apply(p, x[:, :S], jc)
    want, want_c = jssm.mamba_decode(p, x[:, S:], jcache, jc)
    cache = ssm.MambaCache(*_t(np.array(jcache.conv), np.array(jcache.state)))
    before = [t.clone() for t in cache]
    got, got_c = ssm.mamba_decode(tp, torch.as_tensor(x[:, S:]), cache, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_c.conv.numpy(), np.asarray(want_c.conv), atol=ATOL)
    np.testing.assert_allclose(got_c.state.numpy(), np.asarray(want_c.state),
                               atol=ATOL)
    assert all(torch.equal(a, b) for a, b in zip(cache, before))
    # The recurrence continues the scan: decoding token S equals the scan
    # of S + 1 tokens.
    full, full_c = ssm.mamba_apply(tp, torch.as_tensor(x), tc)
    np.testing.assert_allclose(got.numpy(), full[:, S:].numpy(), atol=ATOL)
    np.testing.assert_allclose(got_c.state.numpy(), full_c.state.numpy(), atol=ATOL)


# --------------------------------------------------------------------------
# M-RoPE and the patch positions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 64, 128])
def test_mrope_matches_reference(hd):
    assert layers._mrope_sections(hd) == jlayers._mrope_sections(hd)
    if hd == 128:
        assert layers._mrope_sections(hd) == (16, 24, 24)
    r = np.random.default_rng(hd)
    pos3 = r.integers(0, 300, (B, 7, 3)).astype(np.int32)
    pos2 = r.integers(0, 300, (B, 7)).astype(np.int32)
    for pos in (pos3, pos2):
        want = jlayers.rope_cos_sin(jnp.asarray(pos), hd, 1e4, "mrope")
        got = layers.rope_cos_sin(torch.as_tensor(pos), hd, 1e4, mode="mrope")
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    # Equal components are the standard rotation.
    same = layers.rope_cos_sin(torch.as_tensor(pos2), hd, 1e4, mode="mrope")
    std = layers.rope_cos_sin(torch.as_tensor(pos2), hd, 1e4)
    assert all(torch.equal(a, b) for a, b in zip(same, std))
    with pytest.raises(ValueError, match="unknown rope mode"):
        layers.rope_cos_sin(torch.as_tensor(pos2), hd, 1e4, mode="yarn")


@pytest.mark.parametrize("seq,start", [(12, 0), (8, 0), (1, 13), (3, 5)])
def test_positions_with_patches_match_reference(seq, start):
    """qwen2-vl reduced (8 patches on a 2 x 2 grid's side of 2): patches at
    (0, row, col), text at (j, j, j) from 8 on; a call no longer than the
    patches (a decode step) at (pos, pos, pos)."""
    jc = jget_config("qwen2-vl-2b").reduced()
    tc = get_config("qwen2-vl-2b").reduced()
    want = np.asarray(jlm._positions(jc, B, seq, start))
    got = lm._positions(tc, B, seq, "cpu", start)
    np.testing.assert_array_equal(got.numpy(), want)
    if seq == 12:
        assert got[0, 3].tolist() == [0, 1, 1] and got[0, 8].tolist() == [8, 8, 8]
    smollm = get_config("smollm-360m").reduced()
    assert lm._positions(smollm, B, seq, "cpu", start).shape == (B, seq)
