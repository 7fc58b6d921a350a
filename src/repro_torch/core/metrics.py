"""Ranking metrics of the paper's accuracy tables (Recall@20, NDCG@20): the
port of ``src/repro/core/metrics.py``.

Every function takes tensors on any device and returns tensors on it (the
metrics as 0-d fp32 tensors).  Top-k follows the reference's tie contract:
among equal scores the lowest item id ranks first, as ``lax.top_k`` and
``np.argsort(-s, kind="stable")`` order them (:func:`stable_topk`).
"""
from __future__ import annotations

import torch

_LOW32 = (1 << 32) - 1


def stable_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices (int64) of the ``k`` largest fp32 ``scores`` of each
    row, largest first, equal scores in ascending column order: the order of
    ``lax.top_k``, which ranks by the floats' total order (-0.0 below +0.0),
    and of ``np.argsort(-s, kind="stable")`` wherever no -0.0 meets a +0.0.

    ``torch.topk`` promises no order among ties, so each score is first made
    unique: its fp32 bits, mapped to an int32 that orders as the total order
    does, become the high half of an int64 key whose low half is the
    complement of the column."""
    bits = scores.to(torch.float32).view(torch.int32)
    ordered = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    col = torch.arange(bits.shape[-1], dtype=torch.int64, device=bits.device)
    key = ordered * (1 << 32) + (_LOW32 - col)
    return torch.topk(key, k, dim=-1, sorted=True).indices


def topk_exclude_train(scores: torch.Tensor, train_mask: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Top-k item ids per user, excluding training positives.

    scores: (B, I); train_mask: (B, I) bool (True = seen in training)."""
    masked = torch.where(train_mask, float("-inf"), scores)
    return stable_topk(masked, k)


def recall_at_k(topk_ids: torch.Tensor, test_mask: torch.Tensor) -> torch.Tensor:
    """Recall@K = |hits| / |test positives| averaged over users with
    positives."""
    hits = torch.take_along_dim(test_mask, topk_ids, dim=1)        # (B, k)
    num_pos = test_mask.sum(1)
    valid = num_pos > 0
    rec = hits.sum(1) / num_pos.clamp_min(1)
    return torch.where(valid, rec, 0.0).sum() / valid.sum().clamp_min(1)


def ndcg_at_k(topk_ids: torch.Tensor, test_mask: torch.Tensor) -> torch.Tensor:
    """NDCG@K with binary relevance."""
    k = topk_ids.shape[1]
    dev = topk_ids.device
    hits = torch.take_along_dim(test_mask, topk_ids, dim=1).to(torch.float32)
    discounts = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32,
                                              device=dev))
    dcg = (hits * discounts[None, :]).sum(1)
    num_pos = test_mask.sum(1)
    ideal_hits = torch.arange(k, device=dev)[None, :] < num_pos[:, None]
    idcg = (ideal_hits * discounts[None, :]).sum(1)
    valid = num_pos > 0
    ndcg = torch.where(valid, dcg / idcg.clamp_min(1e-12), 0.0)
    return ndcg.sum() / valid.sum().clamp_min(1)


def evaluate_ranking(scores: torch.Tensor, train_mask: torch.Tensor,
                     test_mask: torch.Tensor, k: int = 20) -> dict[str, torch.Tensor]:
    """Recall@k / NDCG@k from a (U, I) score matrix, excluding train
    positives."""
    ids = topk_exclude_train(scores, train_mask, k)
    return {f"recall@{k}": recall_at_k(ids, test_mask),
            f"ndcg@{k}": ndcg_at_k(ids, test_mask)}
