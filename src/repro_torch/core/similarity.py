"""Fused similarity computation (paper §4.3), for both negative layouts.

One pass over the embeddings yields every dot and norm the cosine CCL loss
and its analytic backward need,

    u . p,  u . n_j,  ||u||^2,  ||p||^2,  ||n_j||^2,

without a concatenated or normalized copy.  This is the plain PyTorch form;
``repro_torch.kernels.ccl_similarity`` implements the same contract as a CUDA
kernel.  :func:`shared_pair_stats` is the same pass for the step-shared
``(n, K)`` negatives of the LM head, and :func:`layout_stats` dispatches on
the negatives' rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1e-12


class SimilarityResiduals(NamedTuple):
    """The paper's three reusable quantities (§4.4), per user-item pair:
    ``uu`` = sum(S_u^2), ``pp``/``nn`` = sum(T_i^2), ``up``/``un`` =
    sum(S_u T_i)."""

    uu: torch.Tensor   # (B,)
    pp: torch.Tensor   # (B,)
    up: torch.Tensor   # (B,)
    nn: torch.Tensor   # (B, n)
    un: torch.Tensor   # (B, n)


def pair_stats(user, pos, negs) -> SimilarityResiduals:
    """user (B, K), pos (B, K), negs (B, n, K) -> every dot/norm for the
    cosine similarities, in one fused pass."""
    return SimilarityResiduals(
        uu=torch.sum(user * user, dim=-1),
        pp=torch.sum(pos * pos, dim=-1),
        up=torch.sum(user * pos, dim=-1),
        nn=torch.sum(negs * negs, dim=-1),
        un=torch.einsum("bk,bnk->bn", user, negs))


def shared_pair_stats(user, pos, negs) -> SimilarityResiduals:
    """The same pass for step-shared negatives: user (T, K), pos (T, K),
    negs (n, K) shared by every row -> ``nn`` (n,) and ``un`` (T, n); the
    cosine formulas broadcast ``inv_n`` over rows."""
    return SimilarityResiduals(
        uu=torch.sum(user * user, dim=-1),
        pp=torch.sum(pos * pos, dim=-1),
        up=torch.sum(user * pos, dim=-1),
        nn=torch.sum(negs * negs, dim=-1),
        un=user @ negs.T)


def layout_stats(user, pos, negs) -> SimilarityResiduals:
    """Dispatch on the negatives' rank: (B, n, K) -> :func:`pair_stats`,
    (n, K) -> :func:`shared_pair_stats`."""
    return pair_stats(user, pos, negs) if negs.dim() == 3 \
        else shared_pair_stats(user, pos, negs)


def cosine_from_stats_with_norms(res: SimilarityResiduals):
    """(pos_sim (B,), neg_sim (B, n), inv_u (B,), inv_p (B,), inv_n (B, n))
    from cached stats — the one definition of the cosine formula."""
    inv_u = torch.rsqrt(res.uu + EPS)
    inv_p = torch.rsqrt(res.pp + EPS)
    inv_n = torch.rsqrt(res.nn + EPS)
    pos_sim = res.up * inv_u * inv_p
    neg_sim = res.un * inv_u[:, None] * inv_n
    return pos_sim, neg_sim, inv_u, inv_p, inv_n


def cosine_from_stats(res: SimilarityResiduals):
    """(pos_sim (B,), neg_sim (B, n)) from cached stats."""
    pos_sim, neg_sim, _, _, _ = cosine_from_stats_with_norms(res)
    return pos_sim, neg_sim


def dot_from_stats(res: SimilarityResiduals):
    """The (user-pos, user-neg) dot products out of cached residuals."""
    return res.up, res.un
