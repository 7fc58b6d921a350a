"""Plain PyTorch oracles for every CUDA kernel in this package.

Each function is the semantic ground truth its kernel (and the kernel's plain
version) is tested against; they are written from the math, not from the
kernels' order of operations.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.losses import ccl_loss_autodiff


def ccl_stats_ref(user, pos, negs):
    """Oracle for ``ccl_similarity.ccl_stats`` (float32 accumulation)."""
    u, p, n = user.float(), pos.float(), negs.float()
    uu = torch.sum(u * u, dim=-1, keepdim=True)
    pp = torch.sum(p * p, dim=-1, keepdim=True)
    up = torch.sum(u * p, dim=-1, keepdim=True)
    nn = torch.sum(n * n, dim=-1)
    un = torch.einsum("bk,bnk->bn", u, n)
    return uu, pp, up, nn, un


def ccl_loss_ref(user, pos, negs, mu=1.0, theta=0.0):
    """Oracle for the full fused loss: plain autograd over the reference
    math."""
    return ccl_loss_autodiff(user.float(), pos.float(), negs.float(), mu,
                             theta, "cosine")


def ccl_grads_ref(user, pos, negs, mu=1.0, theta=0.0):
    """Oracle gradients for the backward kernel (autograd of the
    reference)."""
    leaves = [t.detach().float().requires_grad_() for t in (user, pos, negs)]
    with torch.enable_grad():
        loss = ccl_loss_ref(*leaves, mu, theta)
        grads = torch.autograd.grad(loss, leaves)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (user, pos, negs)))


def rows_update_ref(table, ids, grads, lr):
    """Oracle for the sparse row update: out-of-place scatter-add of
    ``-lr * grads`` (duplicates add)."""
    ids = ids.reshape(-1)
    grads = grads.reshape(-1, grads.shape[-1])
    return table.index_add(0, ids, (-lr * grads).to(table.dtype))


def attention_ref(q, k, v, *, causal=True, scale=None):
    """Oracle for the flash kernel: full-materialization softmax attention.

    q (B, Hq, S, D), k/v (B, Hkv, S, D) with Hq a multiple of Hkv (GQA, each
    KV head broadcast to its query heads); fp32 logits, masked to -inf."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kr = k[:, :, None].expand(b, hkv, group, s, d).reshape(b, hq, s, d)
    vr = v[:, :, None].expand(b, hkv, group, s, d).reshape(b, hq, s, d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vr.float())
    return out.to(q.dtype)
