"""Public wrappers around the CUDA kernels: the kernel CCL losses as
autograd Functions (per-example and step-shared negatives), the sparse row
updates, and the attention dispatcher.

Every wrapper below dispatches on the tensors it is given: CPU tensors run
the kernels' plain versions, CUDA tensors launch the kernels (or raise).
``use_kernel=False`` selects the plain path on any device; it is what the
``scatter_add`` row-update backend runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ccl_similarity import (
    ccl_bwd,
    ccl_bwd_shared,
    ccl_stats,
    ccl_stats_shared,
)
from repro_torch.kernels.embedding_update import (
    gather_fma_rows_,
    gather_fma_rows_plain_,
)
from repro_torch.kernels.flash_attention import flash_attention

EPS = 1e-12


class CCLKernelLoss(torch.autograd.Function):
    """Mean CCL loss (cosine) with the stats kernel forward and the analytic
    backward kernel.  Cosine, relu and mean are formed from the statistics
    as ``src/repro/kernels/ops.py::_ccl_fwd`` does; the kernels handle any
    B, so nothing is padded."""

    @staticmethod
    def forward(ctx, user, pos, negs, mu: float, theta: float):
        uu, pp, up, nn, un = ccl_stats(user, pos, negs)
        inv_u = torch.rsqrt(uu + EPS)
        pos_sim = (up * inv_u * torch.rsqrt(pp + EPS))[:, 0]
        neg_sim = un * inv_u * torch.rsqrt(nn + EPS)
        neg_part = torch.clamp_min(neg_sim - theta, 0.0)
        loss = torch.mean((1.0 - pos_sim)
                          + (mu / negs.shape[1]) * neg_part.sum(-1))
        ctx.save_for_backward(user, pos, negs, uu, pp, up, nn, un)
        ctx.mu, ctx.theta = mu, theta
        return loss.to(user.dtype)

    @staticmethod
    def backward(ctx, g):
        user, pos, negs, uu, pp, up, nn, un = ctx.saved_tensors
        g_row = (g / user.shape[0]).float().reshape(1)
        du, dp, dn = ccl_bwd(user, pos, negs, uu, pp, up, nn, un, g_row,
                             mu=ctx.mu, theta=ctx.theta)
        return du, dp, dn, None, None


def make_ccl_loss_kernel(mu: float = 1.0, theta: float = 0.0):
    """``fn(user (B, K), pos (B, K), negs (B, n, K)) -> scalar`` mean CCL
    loss through the kernels; gradients reach all three inputs through the
    backward kernel (residual reuse, §4.4)."""
    mu, theta = float(mu), float(theta)

    def fn(user, pos, negs):
        return CCLKernelLoss.apply(user, pos, negs, mu, theta)

    return fn


class CCLSharedKernelLoss(torch.autograd.Function):
    """Weighted CCL over T rows against n step-shared negatives: the shared
    stats kernel forward and the shared backward kernel
    (``src/repro/kernels/ops.py::make_ccl_loss_shared_pallas``).  The loss
    is ``sum_t w_t * L_t``; the kernels handle any T, so nothing is padded."""

    @staticmethod
    def forward(ctx, user, pos, negs, w, mu: float, theta: float):
        t, n = user.shape[0], negs.shape[0]
        uu, pp, up, nn, un = ccl_stats_shared(user, pos, negs)
        inv_u = torch.rsqrt(uu + EPS)
        pos_sim = (up * inv_u * torch.rsqrt(pp + EPS))[:, 0]
        neg_sim = un * inv_u * torch.rsqrt(nn + EPS)            # (T, n)
        rows = ((1.0 - pos_sim) + (mu / n)
                * torch.clamp_min(neg_sim - theta, 0.0).sum(-1))
        loss = torch.sum(rows * w.reshape(t))
        w2 = w.reshape(t, 1).float()
        ctx.save_for_backward(user, pos, negs, uu, pp, up, nn, un, w2, rows)
        ctx.mu, ctx.theta, ctx.w_shape = mu, theta, w.shape
        return loss.to(user.dtype)

    @staticmethod
    def backward(ctx, g):
        user, pos, negs, uu, pp, up, nn, un, w2, rows = ctx.saved_tensors
        du, dp, dn = ccl_bwd_shared(user, pos, negs, uu, pp, up, nn, un, w2,
                                    g.float().reshape(1), mu=ctx.mu,
                                    theta=ctx.theta)
        dw = (g * rows).to(user.dtype).reshape(ctx.w_shape)
        return du, dp, dn.to(negs.dtype), dw, None, None


def make_ccl_loss_shared_kernel(mu: float = 1.0, theta: float = 0.0):
    """``fn(user (T, K), pos (T, K), negs (n, K), w (T,)) -> scalar``: the
    weighted CCL of ``core.losses.ccl_loss_fused_w`` for step-shared
    negatives, with the shared stats kernel forward and the shared backward
    kernel.  ``w`` must already be normalized (``core.losses.loss_weights``);
    gradients reach all four inputs, ``w``'s as ``g * rows``."""
    mu, theta = float(mu), float(theta)

    def fn(user, pos, negs, w):
        return CCLSharedKernelLoss.apply(user, pos, negs, w, mu, theta)

    return fn


def sparse_row_update(table, ids, grads, lr: float, *,
                      use_kernel: bool = True):
    """In place ``table[ids] -= lr * grads`` with scatter-add semantics.

    ids (any shape) may hold duplicates; a stable sort puts each id's rows
    in one run, and the update sums every run in that fixed order before
    one write per unique row, so the result is the same bits on every run.
    Returns ``table``."""
    ids = ids.reshape(-1)
    grads = grads.reshape(-1, grads.shape[-1])
    order = torch.argsort(ids, stable=True)
    update = gather_fma_rows_ if use_kernel else gather_fma_rows_plain_
    return update(table, ids[order], order, grads, lr)


def fused_rows_update(table, groups, lr: float, *, use_kernel: bool = True):
    """Single-launch row update for one step's gradient groups.

    ``groups`` is a list of ``(ids, grads)`` pairs addressing the same table
    (HEAT's pos/neg item gradients).  They are concatenated, so ids shared
    across groups are pre-reduced together and the step runs ONE sort and ONE
    kernel launch, as ``src/repro/kernels/ops.py::fused_rows_update`` does."""
    ids = torch.cat([i.reshape(-1) for i, _ in groups])
    grads = torch.cat([g.reshape(-1, g.shape[-1]) for _, g in groups])
    return sparse_row_update(table, ids, grads, lr, use_kernel=use_kernel)


def attention(q, k, v, *, causal: bool = True, use_kernel: bool = True,
              scale=None):
    """Attention through the flash kernel (its plain version on CPU
    tensors), or ``ref.attention_ref`` when ``use_kernel=False`` — the
    dispatcher of ``src/repro/kernels/ops.py::attention``.  q (B, Hq, S, D),
    k/v (B, Hkv, S, D)."""
    if not use_kernel:
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)
