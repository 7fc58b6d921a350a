"""Fused similarity computation (paper §4.3), for both negative layouts.

One pass over the embeddings yields every dot and norm the cosine CCL loss
and its analytic backward need,

    u . p,  u . n_j,  ||u||^2,  ||p||^2,  ||n_j||^2,

without a concatenated or normalized copy.  This is the plain PyTorch form;
``repro_torch.kernels.ccl_similarity`` implements the same contract as a CUDA
kernel.  :func:`shared_pair_stats` is the same pass for the step-shared
``(n, K)`` negatives of the LM head, and :func:`layout_stats` dispatches on
the negatives' rank.

:func:`simplex_bmm_similarity` (and its shared-layout form) is the SimpleX
baseline of paper §3.2 that HEAT is measured against: concat -> normalize ->
bmm, materializing the candidate block and the normalized copies on
purpose, as the profiled PyTorch implementation does.
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


def cosine_similarity(user, pos, negs):
    """The fused path: one stats pass, then cosine; returns ``(pos_sim (B,),
    neg_sim (B, n), residuals)``."""
    res = pair_stats(user, pos, negs)
    pos_sim, neg_sim = cosine_from_stats(res)
    return pos_sim, neg_sim, res


def _normalize(x):
    """Rows over their L2 norms, the norms clipped below at :data:`EPS`."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(EPS)


def simplex_bmm_similarity(user, pos, negs):
    """The SimpleX concat -> normalize -> bmm baseline (paper §3.2): user
    (B, K), pos (B, K), negs (B, n, K) -> ``(pos_sim (B,), neg_sim (B, n))``.
    The (B, 1 + n, K) candidate block and both normalized copies are
    materialized on purpose: they are the baseline's cost."""
    cand = torch.cat([pos[:, None, :], negs], dim=1)          # (B, 1+n, K)
    u_n = _normalize(user)
    c_n = _normalize(cand)
    sims = torch.bmm(c_n, u_n[:, :, None])[..., 0]            # (B, 1+n)
    return sims[:, 0], sims[:, 1:]


def simplex_bmm_similarity_shared(user, pos, negs):
    """The SimpleX normalize-then-matmul baseline for step-shared negatives:
    user (T, K), pos (T, K), negs (n, K) -> ``(pos_sim (T,), neg_sim (T,
    n))``; the normalized copies are materialized (shared negatives need no
    per-row concat)."""
    u_n, p_n, n_n = _normalize(user), _normalize(pos), _normalize(negs)
    return torch.sum(u_n * p_n, dim=-1), u_n @ n_n.T
