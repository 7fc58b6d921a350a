"""Token-choice top-k mixture of experts with capacity-based dispatch — the
port of ``src/repro/models/moe.py``.

Each token's router logits pick its ``top_k`` experts; the gates are a
softmax over those k logits, in fp32.  A slot's position in its expert's buffer is
the token-major running count of that expert's earlier slots (the cumsum of
the one-hot), and an expert holds ``cap`` slots
(``max(ceil(T * k / E * capacity_factor), min(T, 256), 1)``), so later
tokens past the capacity are dropped (they add zero) and small calls
(decode steps) are dropless.  Only the routed tokens enter the expert
products.  Every rule is the reference's, line for line.

:func:`_moe_local` keeps the reference's ``shard_idx`` / ``num_shards``: a
model shard dispatches only the slots of its own ``E / num_shards``
experts, and the shards' partial outputs sum to the whole.  The port has no
LM mesh yet, so :func:`moe_apply` runs the one-shard path; the reference's
``shard_map`` over the model axis (its ``psum``) waits for LM sharding
(``ROADMAP.md`` A.5).

Determinism on the card: the dispatch writes each kept slot into its own
buffer row (``index_copy``; every dropped slot writes zeros into the one
trash row), whose backward is a gather, and the combine gathers rows with
``tiling.gather_rows``, whose backward sums in a fixed order, so no
gradient goes through atomics.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.tiling import gather_rows
from repro_torch.distributed import sharding
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDef


def moe_defs(cfg: ArchConfig, n_layers: int) -> dict:
    """ParamDefs of the router and the expert stacks for ``n_layers`` MoE
    layers."""
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.moe_experts, n_layers
    return {"router": ParamDef((L, d, e), "scaled_fan_in"),
            "w_gate": ParamDef((L, e, d, f), "scaled_fan_in"),
            "w_up": ParamDef((L, e, d, f), "scaled_fan_in"),
            "w_down": ParamDef((L, e, f, d), "scaled_fan_in")}


def top_k_lowest_first(logits: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest entries of each row, ties
    taken by the lower index first, as ``jax.lax.top_k`` takes them (a
    stable descending sort; ``torch.topk`` leaves the order of ties
    open)."""
    values, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def capacity(tokens: int, top_k: int, experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: the expected load times ``capacity_factor``, at
    least ``min(tokens, 256)`` (so small calls cannot drop) and 1."""
    return max(int(math.ceil(tokens * top_k / experts * capacity_factor)),
               min(tokens, 256), 1)


def _moe_local(router, w_gate, w_up, w_down, x, *, top_k: int,
               capacity_factor: float, shard_idx: int = 0,
               num_shards: int = 1):
    """Dispatch, expert products and combine of one model shard.

    x (B, S, d); ``router`` (d, E) whole; ``w_*`` (E / num_shards, d, f)
    or (E / num_shards, f, d), this shard's experts.  Returns this shard's
    part of the output, (B, S, d); the parts of all shards sum to the
    output (the reference sums them with a ``psum`` inside)."""
    b, s, d = x.shape
    t = b * s
    e = router.shape[-1]
    e_loc = e // num_shards
    xf = x.reshape(t, d)

    logits = xf @ router                                         # (T, E)
    gates, eids = top_k_lowest_first(logits, top_k)              # (T, k)
    gates = torch.softmax(gates.float(), dim=-1).to(x.dtype)

    flat_e = eids.reshape(-1)                                    # (T*k,) token-major
    onehot = F.one_hot(flat_e, e)
    pos_in_e = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                            flat_e[:, None])[:, 0]
    cap = capacity(t, top_k, e, capacity_factor)

    local = torch.div(flat_e, e_loc, rounding_mode="floor") == shard_idx
    keep = (pos_in_e < cap) & local
    slot_e = torch.where(keep, flat_e % e_loc, 0)
    slot_c = torch.where(keep, pos_in_e, cap)                   # cap row = trash

    xk = xf[:, None, :].expand(t, top_k, d).reshape(t * top_k, d)
    rows = slot_e * (cap + 1) + slot_c
    buf = torch.zeros((e_loc * (cap + 1), d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, rows, torch.where(keep[:, None], xk, 0.0))
    buf = buf.reshape(e_loc, cap + 1, d)[:, :cap]

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w_gate))
    h = h * torch.einsum("ecd,edf->ecf", buf, w_up)
    out_e = torch.einsum("ecf,efd->ecd", h, w_down)             # (E_loc, C, d)

    gathered = gather_rows(out_e.reshape(e_loc * cap, d),
                           slot_e * cap + torch.clamp_max(slot_c, cap - 1))
    contrib = gathered * (keep[:, None] * gates.reshape(-1)[:, None])
    return contrib.reshape(t, top_k, d).sum(dim=1).reshape(b, s, d)


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """p: one layer's ``{router (d, E), w_* (E, d, f) / (E, f, d)}``;
    x (B, S, d).  The one-shard path; raises under a mesh with a model
    axis, whose expert-parallel path waits for LM sharding."""
    if sharding.model_shards() > 1:
        raise NotImplementedError(
            "expert-parallel MoE over a model axis waits for LM sharding "
            "(ROADMAP.md A.5)")
    return _moe_local(p["router"], p["w_gate"], p["w_up"], p["w_down"], x,
                      top_k=cfg.moe_top_k,
                      capacity_factor=cfg.capacity_factor)
