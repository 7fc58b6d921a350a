"""Fused CCL similarity statistics and their analytic backward (paper §4.3 +
§4.4), as hand-written CUDA kernels for Hopper with a plain PyTorch version
of each beside it, for both negative layouts: per-example ``(B, n, K)``
negatives (the MF step) and step-shared ``(n, K)`` negatives (the LM HEAT
head).

``ccl_stats`` computes, in one pass over the embeddings,

    uu = ||u||^2, pp = ||p||^2, up = u.p  (B, 1);   nn_j = ||n_j||^2, un_j = u.n_j  (B, n)

and ``ccl_bwd`` evaluates the Eq. 4/5 gradients from those cached statistics
without recomputing a dot product.  They replace the TPU kernels
``src/repro/kernels/ccl_similarity.py::ccl_stats_pallas`` and
``::ccl_bwd_pallas``.  ``ccl_stats_shared`` and ``ccl_bwd_shared`` do the
same for the shared layout (with per-row weights ``w`` in the backward,
whose ``dn`` sums over every row) and replace ``::ccl_stats_shared_pallas``
and ``::ccl_bwd_shared_pallas``.  The kernel sources (``csrc/ccl_stats.cu``,
``csrc/ccl_bwd.cu``, ``csrc/ccl_stats_shared.cu``, ``csrc/ccl_bwd_shared.cu``)
say what bounds each on the card and how the design meets it.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises; a ``meta`` tensor (the dry run) gets the kernel's outputs,
empty on ``meta`` with its shapes and dtypes, and runs nothing.  Each wrapper counts its dispatches (``STATS_LAUNCHES``,
``BWD_LAUNCHES``, ``SHARED_STATS_LAUNCHES``, ``SHARED_BWD_LAUNCHES``; see :class:`repro_torch.kernels._build.LaunchCounter`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

STATS_LAUNCHES = _build.LaunchCounter("ccl_stats")
BWD_LAUNCHES = _build.LaunchCounter("ccl_bwd")
SHARED_STATS_LAUNCHES = _build.LaunchCounter("ccl_stats_shared")
SHARED_BWD_LAUNCHES = _build.LaunchCounter("ccl_bwd_shared")

_P = ctypes.c_void_p
_STATS_ARGS = [_P] * 8 + [ctypes.c_int] * 4 + [_P]
_BWD_ARGS = [_P] * 12 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [_P]
_SHARED_STATS_ARGS = [_P] * 8 + [ctypes.c_int] * 3 + [_P]
_SHARED_BWD_ARGS = [_P] * 14 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [_P]
#: most shared negatives the backward kernel takes (its shared memory).
SHARED_MAX_N = 192
EPS = 1e-12


def ccl_stats_plain(user, pos, negs):
    """Plain version of :func:`ccl_stats`: the same per-row reductions, with
    the batched GEMV ``un`` written as a broadcast multiply and a sum."""
    u, p, n = user.float(), pos.float(), negs.float()
    uu = (u * u).sum(-1, keepdim=True)
    pp = (p * p).sum(-1, keepdim=True)
    up = (u * p).sum(-1, keepdim=True)
    nn = (n * n).sum(-1)
    un = (n * u[:, None, :]).sum(-1)
    return uu, pp, up, nn, un


def ccl_bwd_plain(user, pos, negs, uu, pp, up, nn, un, g, *, mu: float,
                  theta: float):
    """Plain version of :func:`ccl_bwd`, in the reference kernel's order of
    operations (``src/repro/kernels/ccl_similarity.py::_bwd_kernel``)."""
    u, p, negs = user.float(), pos.float(), negs.float()
    uue, ppe, nne = uu + EPS, pp + EPS, nn + EPS
    inv_u, inv_p, inv_nn = torch.rsqrt(uue), torch.rsqrt(ppe), torch.rsqrt(nne)
    g = g.reshape(())
    neg_sim = un * inv_u * inv_nn
    d_ps = -g
    d_ns = (g * mu * (1.0 / negs.shape[1])) * (neg_sim > theta).float()
    wp = d_ps * inv_u * inv_p                               # (B, 1)
    wn = d_ns * inv_u * inv_nn                              # (B, n)
    coeff_u = (wp * up + (wn * un).sum(-1, keepdim=True)) / uue
    wn_negs = (wn[..., None] * negs).sum(1)                 # (B, K)
    du = wp * p + wn_negs - coeff_u * u
    dp = wp * u - (wp * up / ppe) * p
    dn = wn[..., None] * u[:, None, :] - (wn * un / nne)[..., None] * negs
    return du, dp, dn


def _shapes(user, pos, negs) -> tuple[int, int, int]:
    if user.dim() != 2 or pos.shape != user.shape or negs.dim() != 3 \
            or negs.shape[0] != user.shape[0] or negs.shape[2] != user.shape[1]:
        raise ValueError(f"expected user/pos (B, K) and negs (B, n, K), got "
                         f"{tuple(user.shape)}, {tuple(pos.shape)}, "
                         f"{tuple(negs.shape)}")
    return user.shape[0], negs.shape[1], user.shape[1]


def _device_type(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: no kernel or plain version for {t.device}")
    return t.device.type


def ccl_stats(user, pos, negs):
    """user (B, K), pos (B, K), negs (B, n, K) -> uu, pp, up (B, 1) and
    nn, un (B, n), fp32."""
    b, n, k = _shapes(user, pos, negs)
    kind = _device_type(user, "ccl_stats")
    if kind == "cpu":
        STATS_LAUNCHES.bump("cpu")
        return ccl_stats_plain(user, pos, negs)
    if kind == "meta":
        STATS_LAUNCHES.bump("meta")
        return tuple(torch.empty(shape, device="meta")
                     for shape in ((b, 1),) * 3 + ((b, n),) * 2)
    _build.check_operands("ccl_stats", user.device,
                          [(t, torch.float32) for t in (user, pos, negs)])
    if k > 12_288:
        raise ValueError(f"ccl_stats: K={k} exceeds the largest K the kernel "
                         "takes, 12,288")
    uu, pp, up = (torch.empty((b, 1), device=user.device) for _ in range(3))
    nn, un = (torch.empty((b, n), device=user.device) for _ in range(2))
    vec = int(k % 4 == 0 and user.data_ptr() % 16 == 0
              and negs.data_ptr() % 16 == 0)
    fn = _build.bind("ccl_stats", "ccl_stats", _STATS_ARGS)
    with torch.cuda.device(user.device):
        err = fn(user.data_ptr(), pos.data_ptr(), negs.data_ptr(),
                 uu.data_ptr(), pp.data_ptr(), up.data_ptr(), nn.data_ptr(),
                 un.data_ptr(), b, n, k, vec, _build.stream_of(user))
    _build.check(err, "ccl_stats")
    STATS_LAUNCHES.bump("cuda")
    return uu, pp, up, nn, un


def ccl_bwd(user, pos, negs, uu, pp, up, nn, un, g, *, mu: float,
            theta: float):
    """Fused Eq. 4/5 backward.  ``g``: the scalar cotangent of the mean loss,
    already divided by B, as a one-element fp32 tensor on the inputs' device.
    Returns du (B, K), dp (B, K), dn (B, n, K)."""
    b, n, k = _shapes(user, pos, negs)
    kind = _device_type(user, "ccl_bwd")
    if kind == "cpu":
        BWD_LAUNCHES.bump("cpu")
        return ccl_bwd_plain(user, pos, negs, uu, pp, up, nn, un, g, mu=mu,
                             theta=theta)
    if kind == "meta":
        BWD_LAUNCHES.bump("meta")
        return tuple(torch.empty(x.shape, device="meta")
                     for x in (user, pos, negs))
    _build.check_operands(
        "ccl_bwd", user.device,
        [(t, torch.float32) for t in (user, pos, negs, uu, pp, up, nn, un, g)])
    if g.numel() != 1 or uu.shape != (b, 1) or nn.shape != (b, n) \
            or un.shape != (b, n) or pp.shape != (b, 1) or up.shape != (b, 1):
        raise ValueError("ccl_bwd: stats must be (B, 1) x3 and (B, n) x2, "
                         "and g one element")
    if n > 4096:
        raise ValueError(f"ccl_bwd: n={n} exceeds the kernel's shared memory")
    du, dp = torch.empty_like(user), torch.empty_like(pos)
    dn = torch.empty_like(negs)
    fn = _build.bind("ccl_bwd", "ccl_bwd", _BWD_ARGS)
    with torch.cuda.device(user.device):
        err = fn(user.data_ptr(), pos.data_ptr(), negs.data_ptr(),
                 uu.data_ptr(), pp.data_ptr(), up.data_ptr(), nn.data_ptr(),
                 un.data_ptr(), g.data_ptr(), du.data_ptr(), dp.data_ptr(),
                 dn.data_ptr(), b, n, k, float(mu), float(theta),
                 _build.stream_of(user))
    _build.check(err, "ccl_bwd")
    BWD_LAUNCHES.bump("cuda")
    return du, dp, dn


def ccl_stats_shared_plain(user, pos, negs):
    """Plain version of :func:`ccl_stats_shared`: every sum over K in fp64,
    rounded to fp32 once, as the kernel does (``csrc/ccl_stats_shared.cu``
    says why)."""
    u, p, n = user.double(), pos.double(), negs.double()
    uu = (u * u).sum(-1, keepdim=True)
    pp = (p * p).sum(-1, keepdim=True)
    up = (u * p).sum(-1, keepdim=True)
    nn = (n * n).sum(-1)[None, :]
    return tuple(x.float() for x in (uu, pp, up, nn, u @ n.T))


def ccl_bwd_shared_plain(user, pos, negs, uu, pp, up, nn, un, w, g, *,
                         mu: float, theta: float):
    """Plain version of :func:`ccl_bwd_shared`, in the reference kernel's
    order of operations (``src/repro/kernels/ccl_similarity.py::
    _bwd_shared_kernel``); ``dn``'s two sums over the rows in fp64, rounded
    to fp32 once, as the kernel does."""
    u, p, negs = user.float(), pos.float(), negs.float()
    uue, ppe = uu + EPS, pp + EPS
    inv_u, inv_p = torch.rsqrt(uue), torch.rsqrt(ppe)
    inv_nn = torch.rsqrt(nn + EPS)                          # (1, n)
    g = g.reshape(())
    pos_sim = up * inv_u * inv_p                            # (T, 1)
    neg_sim = un * inv_u * inv_nn                           # (T, n)
    d_ps = -g * w
    d_ns = (g * mu * (1.0 / negs.shape[0])) * w * (neg_sim > theta).float()
    u_hat = u * inv_u
    p_hat = p * inv_p
    wn = d_ns * inv_nn
    coeff = d_ps * pos_sim + (d_ns * neg_sim).sum(-1, keepdim=True)
    du = inv_u * (d_ps * p_hat - coeff * u_hat) + inv_u * (wn @ negs)
    dp = (d_ps * inv_p) * (u_hat - pos_sim * p_hat)
    wn64 = wn.double()
    col = (wn64 * neg_sim.double()).sum(0)                  # (n,)
    dn = (wn64.T @ u_hat.double()
          - (col * inv_nn[0].double())[:, None] * negs.double())
    return du, dp, dn.float()


def _shared_shapes(user, pos, negs) -> tuple[int, int, int]:
    if user.dim() != 2 or pos.shape != user.shape or negs.dim() != 2 \
            or negs.shape[1] != user.shape[1]:
        raise ValueError(f"expected user/pos (T, K) and negs (n, K), got "
                         f"{tuple(user.shape)}, {tuple(pos.shape)}, "
                         f"{tuple(negs.shape)}")
    return user.shape[0], negs.shape[0], user.shape[1]


def ccl_stats_shared(user, pos, negs):
    """user (T, K), pos (T, K), negs (n, K) shared by every row -> uu, pp,
    up (T, 1), nn (1, n) and un (T, n), fp32."""
    t, n, k = _shared_shapes(user, pos, negs)
    kind = _device_type(user, "ccl_stats_shared")
    if kind == "cpu":
        SHARED_STATS_LAUNCHES.bump("cpu")
        return ccl_stats_shared_plain(user, pos, negs)
    if kind == "meta":
        SHARED_STATS_LAUNCHES.bump("meta")
        return tuple(torch.empty(shape, device="meta")
                     for shape in ((t, 1),) * 3 + ((1, n), (t, n)))
    _build.check_operands("ccl_stats_shared", user.device,
                          [(x, torch.float32) for x in (user, pos, negs)])
    uu, pp, up = (torch.empty((t, 1), device=user.device) for _ in range(3))
    nn = torch.empty((1, n), device=user.device)
    un = torch.empty((t, n), device=user.device)
    fn = _build.bind("ccl_stats_shared", "ccl_stats_shared", _SHARED_STATS_ARGS)
    with torch.cuda.device(user.device):
        err = fn(user.data_ptr(), pos.data_ptr(), negs.data_ptr(),
                 uu.data_ptr(), pp.data_ptr(), up.data_ptr(), nn.data_ptr(),
                 un.data_ptr(), t, n, k, _build.stream_of(user))
    _build.check(err, "ccl_stats_shared")
    SHARED_STATS_LAUNCHES.bump("cuda")
    return uu, pp, up, nn, un


def _shared_bwd_scratch_bytes(t: int, n: int, k: int) -> int:
    """Scratch bytes of the shared backward kernel at (T, n, K) on the
    current device (``ccl_bwd_shared_scratch_bytes`` in its source)."""
    fn = getattr(_build.library("ccl_bwd_shared"), "ccl_bwd_shared_scratch_bytes")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_size_t
    return int(fn(t, n, k))


def ccl_bwd_shared(user, pos, negs, uu, pp, up, nn, un, w, g, *, mu: float,
                   theta: float):
    """Weighted Eq. 4/5 backward for the shared layout.  ``w`` (T, 1): the
    normalized row weights (0 on masked rows); ``g``: the raw scalar
    cotangent of the weighted-sum loss, a one-element fp32 tensor on the
    inputs' device.  Returns du (T, K), dp (T, K) and dn (n, K), ``dn``
    summed over every row in a fixed order (no atomics)."""
    t, n, k = _shared_shapes(user, pos, negs)
    kind = _device_type(user, "ccl_bwd_shared")
    if kind == "cpu":
        SHARED_BWD_LAUNCHES.bump("cpu")
        return ccl_bwd_shared_plain(user, pos, negs, uu, pp, up, nn, un, w, g,
                                    mu=mu, theta=theta)
    if kind == "meta":
        SHARED_BWD_LAUNCHES.bump("meta")
        return tuple(torch.empty(x.shape, device="meta")
                     for x in (user, pos, negs))
    _build.check_operands(
        "ccl_bwd_shared", user.device,
        [(x, torch.float32)
         for x in (user, pos, negs, uu, pp, up, nn, un, w, g)])
    if g.numel() != 1 or any(x.shape != (t, 1) for x in (uu, pp, up, w)) \
            or nn.shape != (1, n) or un.shape != (t, n):
        raise ValueError("ccl_bwd_shared: uu, pp, up, w must be (T, 1), nn "
                         "(1, n), un (T, n), and g one element")
    if n > SHARED_MAX_N:
        raise ValueError(f"ccl_bwd_shared: n={n} exceeds the kernel's shared "
                         f"memory (at most {SHARED_MAX_N})")
    du, dp = torch.empty_like(user), torch.empty_like(pos)
    dn = torch.empty_like(negs)
    fn = _build.bind("ccl_bwd_shared", "ccl_bwd_shared", _SHARED_BWD_ARGS)
    with torch.cuda.device(user.device):
        # The kernel's row scalars, fp64 wn, column sums and per-slab dn
        # partials, laid out by the C side for this device's SM count.
        nbytes = _shared_bwd_scratch_bytes(t, n, k)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=user.device)
        err = fn(user.data_ptr(), pos.data_ptr(), negs.data_ptr(),
                 uu.data_ptr(), pp.data_ptr(), up.data_ptr(), nn.data_ptr(),
                 un.data_ptr(), w.data_ptr(), g.data_ptr(), du.data_ptr(),
                 dp.data_ptr(), dn.data_ptr(), scratch.data_ptr(), t, n, k,
                 float(mu), float(theta), _build.stream_of(user))
    _build.check(err, "ccl_bwd_shared")
    SHARED_BWD_LAUNCHES.bump("cuda")
    return du, dp, dn
