"""Cosine Contrastive Loss (CCL, SimpleX Eq. 3) with HEAT's aggressive data
reuse (paper §4.4), as a ``torch.autograd.Function``.

Operator-level autograd recomputes ``sum(S_u^2)``, ``sum(T_i^2)`` and
``sum(S_u T_i)`` when it backpropagates through the cosine similarity, though
the forward already produced them.  :class:`CCLFused` saves the normalized
user and positive rows, the raw negatives, the inverse norms and both
similarities, and its backward is the closed-form Eq. 4/5 contraction in
normalized form: nothing is recomputed.  Paper Eq. 5 is printed with a sign
that contradicts Eq. 4; the backward uses the correct sign, as the reference
``src/repro/core/losses.py`` does.

:class:`CCLFusedW` (``ccl_loss_fused_w``) is the weighted form for both
negative layouts: per-example ``(B, n, K)`` and the LM head's step-shared
``(n, K)``, with per-row weights ``w`` (:func:`loss_weights`) so masked rows
drop out of the loss and the backward, and the gradient of ``w`` returned
too.  :func:`ccl_loss_autodiff` keeps the plain-autograd version as the
oracle, for both layouts and masks.  The baselines go through plain
autograd: :func:`ccl_loss_simplex_bmm` (SimpleX's concat -> normalize -> bmm,
paper §3.2), :func:`mse_loss_dot` (dot product and MSE on the positive, the
CuMF_SGD class) and :func:`bpr_loss`.
"""
from __future__ import annotations

import torch

from repro_torch.core.similarity import (
    cosine_from_stats,
    cosine_from_stats_with_norms,
    dot_from_stats,
    layout_stats,
    pair_stats,
    simplex_bmm_similarity,
    simplex_bmm_similarity_shared,
)


def _ccl_rows(pos_sim, neg_sim, mu: float, theta: float):
    """Per-row Eq. 3 losses: (1 - x_ui) + mu/|N| * sum_j relu(x_uj - theta)."""
    neg_part = torch.clamp_min(neg_sim - theta, 0.0)
    return (1.0 - pos_sim) + (mu / neg_sim.shape[-1]) * neg_part.sum(-1)


def loss_weights(mask, rows: int, dtype, device) -> torch.Tensor:
    """Normalized per-row weights of the loss contract: ``mask=None`` ->
    ``1/rows`` each (a plain mean); a mask (any shape with ``rows``
    elements) -> ``m / max(sum(m), 1)``, so masked rows count nothing."""
    if mask is None:
        return torch.full((rows,), 1.0 / rows, dtype=dtype, device=device)
    m = mask.reshape(rows).to(dtype)
    return m / torch.clamp_min(torch.sum(m), 1.0)


def _sims(res, similarity: str):
    if similarity == "cosine":
        return cosine_from_stats(res)
    if similarity == "dot":
        return dot_from_stats(res)
    raise ValueError(f"unknown similarity {similarity!r}")


class CCLFused(torch.autograd.Function):
    """Mean CCL over (user, positive, n negatives) rows with the analytic
    Eq. 4/5 backward from saved residuals (``src/repro/core/losses.py``
    ``_ccl_fwd``/``_ccl_bwd``)."""

    @staticmethod
    def forward(ctx, user, pos, negs, mu: float, theta: float,
                similarity: str):
        if similarity not in ("cosine", "dot"):
            raise ValueError(f"unknown similarity {similarity!r}")
        res = pair_stats(user, pos, negs)
        ctx.mu, ctx.theta, ctx.similarity = mu, theta, similarity
        if similarity == "dot":
            pos_sim, neg_sim = dot_from_stats(res)
            ctx.save_for_backward(user, pos, negs, neg_sim)
            return _ccl_rows(pos_sim, neg_sim, mu, theta).mean()
        pos_sim, neg_sim, inv_u, inv_p, inv_n = cosine_from_stats_with_norms(res)
        # The (B, n, K) negatives stay raw (a normalized copy would be one
        # more pass over the largest tensor); inv_n folds their norm in.
        u_hat = user * inv_u[:, None]
        p_hat = pos * inv_p[:, None]
        ctx.save_for_backward(u_hat, p_hat, negs, inv_u, inv_p, inv_n,
                              pos_sim, neg_sim)
        return _ccl_rows(pos_sim, neg_sim, ctx.mu, ctx.theta).mean()

    @staticmethod
    def backward(ctx, g):
        mu, theta = ctx.mu, ctx.theta
        if ctx.similarity == "dot":
            user, pos, negs, neg_sim = ctx.saved_tensors
            batch, n = neg_sim.shape
            d_ps = (-g / batch) * torch.ones(batch, dtype=user.dtype,
                                             device=user.device)
            d_ns = (g * mu / (n * batch)) * (neg_sim > theta).to(user.dtype)
            grad_u = d_ps[:, None] * pos + torch.einsum("bn,bnk->bk", d_ns, negs)
            grad_p = d_ps[:, None] * user
            grad_n = d_ns[:, :, None] * user[:, None, :]
            return grad_u, grad_p, grad_n, None, None, None
        u_hat, p_hat, negs, inv_u, inv_p, inv_n, pos_sim, neg_sim = \
            ctx.saved_tensors
        batch, n = neg_sim.shape
        d_ps = (-g / batch) * torch.ones(batch, dtype=u_hat.dtype,
                                         device=u_hat.device)
        d_ns = (g * mu / (n * batch)) * (neg_sim > theta).to(u_hat.dtype)
        # Eq. 4: d cos(u,i)/du = (i_hat - cos * u_hat) / ||u||; the negatives'
        # i_hat is folded into the contraction coefficient (raw negs * inv_n).
        wn = d_ns * inv_n                                         # (B, n)
        coeff = d_ps * pos_sim + torch.sum(d_ns * neg_sim, dim=-1)
        grad_u = (inv_u[:, None] * (d_ps[:, None] * p_hat - coeff[:, None] * u_hat)
                  + torch.einsum("bn,bnk->bk", wn * inv_u[:, None], negs))
        # Eq. 5 (sign corrected): d cos(u,i)/di = (u_hat - cos * i_hat) / ||i||
        grad_p = (d_ps * inv_p)[:, None] * (u_hat - pos_sim[:, None] * p_hat)
        grad_n = (wn[:, :, None] * u_hat[:, None, :]
                  - (wn * neg_sim * inv_n)[:, :, None] * negs)
        return grad_u, grad_p, grad_n, None, None, None


def ccl_loss_fused(user, pos, negs, mu: float = 1.0, theta: float = 0.0,
                   similarity: str = "cosine"):
    """CCL loss over user (B, K), pos (B, K), negs (B, n, K) -> scalar mean,
    with the residual-reuse backward of :class:`CCLFused`."""
    return CCLFused.apply(user, pos, negs, float(mu), float(theta), similarity)


class CCLFusedW(torch.autograd.Function):
    """Weighted CCL ``sum_t w_t * L_t`` for per-example (B, n, K) or shared
    (n, K) negatives, with the analytic backward from saved residuals
    (``src/repro/core/losses.py`` ``_ccl_w_fwd``/``_ccl_w_bwd``); the
    shared negatives' gradient sums every row's Eq. 5 contribution, and the
    gradient of ``w`` is ``g`` times the row losses."""

    @staticmethod
    def forward(ctx, user, pos, negs, w, mu: float, theta: float,
                similarity: str):
        if similarity not in ("cosine", "dot"):
            raise ValueError(f"unknown similarity {similarity!r}")
        res = layout_stats(user, pos, negs)
        ctx.mu, ctx.theta, ctx.similarity = mu, theta, similarity
        if similarity == "dot":
            ps, ns = dot_from_stats(res)
            ctx.save_for_backward(user, pos, negs, ps, ns, w)
            return torch.sum(_ccl_rows(ps, ns, mu, theta) * w)
        ps, ns, inv_u, inv_p, inv_n = cosine_from_stats_with_norms(res)
        u_hat = user * inv_u[:, None]
        p_hat = pos * inv_p[:, None]
        ctx.save_for_backward(u_hat, p_hat, negs, inv_u, inv_p, inv_n, ps, ns,
                              w)
        return torch.sum(_ccl_rows(ps, ns, mu, theta) * w)

    @staticmethod
    def backward(ctx, g):
        mu, theta = ctx.mu, ctx.theta
        shared = ctx.saved_tensors[2].dim() == 2
        if ctx.similarity == "dot":
            user, pos, negs, ps, ns, w = ctx.saved_tensors
            n = ns.shape[-1]
            d_ps = -g * w
            d_ns = (g * mu / n) * w[:, None] * (ns > theta).to(user.dtype)
            grad_p = d_ps[:, None] * user
            if shared:
                grad_u = d_ps[:, None] * pos + d_ns @ negs
                grad_n = d_ns.T @ user
            else:
                grad_u = d_ps[:, None] * pos + torch.einsum("bn,bnk->bk", d_ns,
                                                            negs)
                grad_n = d_ns[:, :, None] * user[:, None, :]
            return (grad_u, grad_p, grad_n, g * _ccl_rows(ps, ns, mu, theta),
                    None, None, None)
        u_hat, p_hat, negs, inv_u, inv_p, inv_n, ps, ns, w = ctx.saved_tensors
        n = ns.shape[-1]
        d_ps = -g * w
        d_ns = (g * mu / n) * w[:, None] * (ns > theta).to(u_hat.dtype)
        wn = d_ns * inv_n
        coeff = d_ps * ps + torch.sum(d_ns * ns, dim=-1)
        grad_u = inv_u[:, None] * (d_ps[:, None] * p_hat - coeff[:, None] * u_hat)
        if shared:
            grad_u = grad_u + inv_u[:, None] * (wn @ negs)
            grad_n = (wn.T @ u_hat
                      - (torch.sum(wn * ns, dim=0) * inv_n)[:, None] * negs)
        else:
            grad_u = grad_u + torch.einsum("bn,bnk->bk", wn * inv_u[:, None],
                                           negs)
            grad_n = (wn[:, :, None] * u_hat[:, None, :]
                      - (wn * ns * inv_n)[:, :, None] * negs)
        grad_p = (d_ps * inv_p)[:, None] * (u_hat - ps[:, None] * p_hat)
        return (grad_u, grad_p, grad_n, g * _ccl_rows(ps, ns, mu, theta),
                None, None, None)


def ccl_loss_fused_w(user, pos, negs, w, mu: float = 1.0, theta: float = 0.0,
                     similarity: str = "cosine"):
    """Weighted CCL ``sum_t w_t * L_t``; ``negs`` (B, n, K) or shared
    (n, K); ``w`` (B,) already normalized (:func:`loss_weights`).  With
    ``w = 1/B`` it equals :func:`ccl_loss_fused`."""
    return CCLFusedW.apply(user, pos, negs, w, float(mu), float(theta),
                           similarity)


def ccl_loss_autodiff(user, pos, negs, mu: float = 1.0, theta: float = 0.0,
                      similarity: str = "cosine", mask=None):
    """Same math through plain autograd (no residual reuse): the baseline and
    the oracle, for both negative layouts and an optional per-row mask."""
    ps, ns = _sims(layout_stats(user, pos, negs), similarity)
    if mask is None and negs.dim() == 3:
        return _ccl_rows(ps, ns, mu, theta).mean()
    w = loss_weights(mask, user.shape[0], user.dtype, user.device)
    return torch.sum(_ccl_rows(ps, ns, mu, theta) * w)


def ccl_loss_simplex_bmm(user, pos, negs, mu: float = 1.0, theta: float = 0.0,
                         mask=None):
    """CCL over the SimpleX concat -> normalize -> bmm similarities (paper
    §3.2) through plain autograd: the baseline HEAT is measured against.
    ``negs`` (B, n, K) or step-shared (n, K); an optional per-row mask."""
    if negs.dim() == 2:
        ps, ns = simplex_bmm_similarity_shared(user, pos, negs)
    else:
        ps, ns = simplex_bmm_similarity(user, pos, negs)
    rows = _ccl_rows(ps, ns, mu, theta)
    if mask is None:
        return rows.mean()
    return torch.sum(rows * loss_weights(mask, user.shape[0], user.dtype,
                                         user.device))


def mse_loss_dot(user, pos, rating: float = 1.0, mask=None):
    """The CuMF_SGD-class baseline: dot-product prediction and squared error
    against ``rating`` on the positive alone (negatives unused)."""
    err = (rating - torch.sum(user * pos, dim=-1)) ** 2
    if mask is None:
        return err.mean()
    return torch.sum(loss_weights(mask, user.shape[0], user.dtype,
                                  user.device) * err)


def bpr_loss(user, pos, negs):
    """BPR (related work, §6): ``-mean log sigmoid(u.p - u.n_j)`` over the
    (B, n) pairs of per-example negatives."""
    up = torch.sum(user * pos, dim=-1)
    un = torch.einsum("bk,bnk->bn", user, negs)
    return -torch.mean(torch.nn.functional.logsigmoid(up[:, None] - un))
