"""SimpleX behavior aggregation and HEAT's deferred update of its dense
weights (paper §4.5), ported from ``src/repro/core/aggregation.py``.

The aggregation layer fuses a user's embedding with an aggregate of the
embeddings of the items in their history::

    m_u  = aggregate({T_h : h in history(u)})       (average or attention)
    e_u' = g * S_u + (1 - g) * (m_u @ W)            (W: (K, K) dense)

W is dense and shared by every row of the batch.  HEAT accumulates its
gradients locally and applies them every ``m`` steps (m = 32); here the
accumulator is part of the training state and its ``count`` is a host int,
so the flush decision never waits on the device.  Under a mesh the ranks'
local sums are combined on flush steps only (:func:`maybe_flush`'s
``group``).  The products are plain PyTorch calls, as the
reference leaves them to XLA outside any kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.distributed.sharding import sum_over


class AggregatorParams(NamedTuple):
    """Learnable aggregator weights: ``w`` (K, K) and, for the attention
    kinds, the query ``attn_q`` (K, K)."""

    w: torch.Tensor
    attn_q: Optional[torch.Tensor] = None


def init_aggregator(gen: torch.Generator, emb_dim: int, kind: str = "avg",
                    dtype=torch.float32) -> AggregatorParams:
    """Draw AggregatorParams for ``kind`` from ``gen`` (``w`` first, then
    ``attn_q`` for the attention kinds), scaled by ``1/sqrt(K)``."""
    scale = 1.0 / math.sqrt(emb_dim)

    def draw():
        return torch.randn((emb_dim, emb_dim), generator=gen, device=gen.device,
                           dtype=dtype) * scale

    w = draw()
    attn_q = draw() if kind in ("self_attn", "user_attn") else None
    return AggregatorParams(w=w, attn_q=attn_q)


def aggregate(params: AggregatorParams, user_emb: torch.Tensor,
              hist_emb: torch.Tensor, hist_mask: torch.Tensor, *,
              gate: float = 0.5, kind: str = "avg") -> torch.Tensor:
    """user_emb (B, K), hist_emb (B, H, K), hist_mask (B, H) -> the fused
    user (B, K).  Kinds: ``avg`` (average pooling), ``self_attn``,
    ``user_attn`` — the three of §4.5."""
    denom = hist_mask.sum(-1, keepdim=True).clamp_min(1.0)
    if kind == "avg":
        pooled = torch.einsum("bhk,bh->bk", hist_emb, hist_mask) / denom
    elif kind == "self_attn":
        scores = torch.einsum("bhk,kq,bjq->bhj", hist_emb, params.attn_q,
                              hist_emb)
        scores = torch.where(hist_mask[:, None, :] > 0, scores, -1e9)
        attn = torch.softmax(scores / math.sqrt(hist_emb.shape[-1]), dim=-1)
        ctx = torch.einsum("bhj,bjk->bhk", attn, hist_emb)
        pooled = torch.einsum("bhk,bh->bk", ctx, hist_mask) / denom
    elif kind == "user_attn":
        scores = torch.einsum("bk,kq,bhq->bh", user_emb, params.attn_q,
                              hist_emb)
        scores = torch.where(hist_mask > 0, scores, -1e9)
        attn = torch.softmax(scores / math.sqrt(hist_emb.shape[-1]), dim=-1)
        pooled = torch.einsum("bh,bhk->bk", attn, hist_emb)
    else:
        raise ValueError(f"unknown aggregation kind {kind!r}")
    return gate * user_emb + (1.0 - gate) * (pooled @ params.w)


class AccumulatorState(NamedTuple):
    """The §4.5 local gradient accumulator of the aggregator weights:
    ``grad_sum`` (the tree of the params) and ``count``, the steps since
    the last flush (host int)."""

    grad_sum: AggregatorParams
    count: int


def _map(fn, *trees: AggregatorParams) -> AggregatorParams:
    return AggregatorParams(*(None if xs[0] is None else fn(*xs)
                              for xs in zip(*trees)))


def accumulator_init(params: AggregatorParams) -> AccumulatorState:
    """A zeroed accumulator matching ``params``."""
    return AccumulatorState(grad_sum=_map(torch.zeros_like, params), count=0)


def accumulate(state: AccumulatorState,
               grads: AggregatorParams) -> AccumulatorState:
    """Fold one step's aggregator gradients into the accumulator."""
    return AccumulatorState(grad_sum=_map(torch.add, state.grad_sum, grads),
                            count=state.count + 1)


def maybe_flush(state: AccumulatorState, params: AggregatorParams, lr: float,
                flush_every: int, *, group=None):
    """Every ``flush_every`` steps: ``W -= lr * grad_sum / count`` (Listing
    1's update) and a fresh accumulator; otherwise both unchanged.
    Returns ``(params, state)``.

    ``group`` (a ``distributed.sharding.AxisGroup``; the counterpart of the
    reference's ``axis_name``) combines the members' local sums on flush
    steps only, as §4.5 defers them: an all-gather and a sum in group
    order, so every member applies the same bits.  The members' sums are
    *summed*, where the reference takes a ``pmean`` of per-shard means: the
    sharded step scales each rank's loss by its share of the batch, so a
    rank's gradients are shares of the global mean already."""
    if state.count < flush_every:
        return params, state
    grad_sum = state.grad_sum
    if group is not None:
        leaves = [g for g in grad_sum if g is not None]
        summed = iter(sum_over(leaves, group))
        grad_sum = AggregatorParams(*(None if g is None else next(summed)
                                      for g in grad_sum))
    denom = float(max(state.count, 1))
    new_params = _map(lambda w, g: w - lr * (g / denom), params, grad_sum)
    return new_params, accumulator_init(params)
