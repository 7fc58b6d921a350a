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
experts, and the shards' partial outputs sum to the whole.  Under a mesh
with a model axis :func:`moe_apply` runs that split, the counterpart of the
reference's ``shard_map``; its ``psum`` (``sharding.reduce_from``) sums
each slot's contribution before the slots of a token are summed, so the
sharded layer gives the one-shard layer's bits; each rank's capacity
counts its own data shard's tokens, as the reference's does.

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
from repro_torch.distributed.sharding import P
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDef, Shard, use


def moe_defs(cfg: ArchConfig, n_layers: int) -> dict:
    """ParamDefs of the router and the expert stacks for ``n_layers`` MoE
    layers."""
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.moe_experts, n_layers
    experts = P(None, "model", None, None)
    return {"router": ParamDef((L, d, e), "scaled_fan_in",
                               spec=P(None, None, None)),
            "w_gate": ParamDef((L, e, d, f), "scaled_fan_in", spec=experts),
            "w_up": ParamDef((L, e, d, f), "scaled_fan_in", spec=experts),
            "w_down": ParamDef((L, e, f, d), "scaled_fan_in", spec=experts)}


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
               num_shards: int = 1, route_group=None, model_group=None):
    """Dispatch, expert products and combine of one model shard.

    x (B, S, d); ``router`` (d, E) whole; ``w_*`` (E / num_shards, d, f)
    or (E / num_shards, f, d), this shard's experts.  Returns this shard's
    part of the output, (B, S, d); the parts of all shards sum to the
    output (the reference sums them with a ``psum`` inside).

    ``route_group`` (a data group whose ranks hold the other rows of one
    batch) makes the slots' positions and the capacity those of the whole
    batch, as the reference's meshless layer counts them on a data-sharded
    batch: the expert choices travel (integers only) and each rank keeps
    its rows' slots.

    ``model_group`` (the model group whose ranks hold the other experts,
    ``shard_idx`` this rank's place in it) returns the whole output: each
    slot's contribution is summed over the group (``reduce_from``) before
    the k slots of a token are summed, and the slots' inputs and gates
    enter through ``copy_to``.  A slot is nonzero on its expert's rank
    only, so both sums are exact and the output and the gradients are the
    one-shard layer's bits."""
    b, s, d = x.shape
    t = b * s
    e = router.shape[-1]
    e_loc = e // num_shards
    xf = x.reshape(t, d)

    logits = xf @ router                                         # (T, E)
    gates, eids = top_k_lowest_first(logits, top_k)              # (T, k)
    gates = torch.softmax(gates.float(), dim=-1).to(x.dtype)

    flat_e = eids.reshape(-1)                                    # (T*k,) token-major
    every_e, first, t_all = flat_e, 0, t
    if route_group is not None and route_group.size > 1:
        every, first = sharding.all_gather_rows(eids, route_group,
                                                offset=True)
        every_e, t_all, first = every.reshape(-1), every.shape[0], first * top_k
    onehot = F.one_hot(every_e, e)
    pos_in_e = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                            every_e[:, None])[first:first + t * top_k, 0]
    cap = capacity(t_all, top_k, e, capacity_factor)

    local = torch.div(flat_e, e_loc, rounding_mode="floor") == shard_idx
    keep = (pos_in_e < cap) & local
    slot_e = torch.where(keep, flat_e % e_loc, 0)
    slot_c = torch.where(keep, pos_in_e, cap)                   # cap row = trash

    xk = xf[:, None, :].expand(t, top_k, d).reshape(t * top_k, d)
    g = gates.reshape(-1)
    if model_group is not None:
        xk = sharding.copy_to(xk, model_group)
        g = sharding.copy_to(g, model_group)
    rows = slot_e * (cap + 1) + slot_c
    buf = torch.zeros((e_loc * (cap + 1), d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, rows, torch.where(keep[:, None], xk, 0.0))
    buf = buf.reshape(e_loc, cap + 1, d)[:, :cap]

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w_gate))
    h = h * torch.einsum("ecd,edf->ecf", buf, w_up)
    out_e = torch.einsum("ecf,efd->ecd", h, w_down)             # (E_loc, C, d)

    gathered = gather_rows(out_e.reshape(e_loc * cap, d),
                           slot_e * cap + torch.clamp_max(slot_c, cap - 1))
    contrib = gathered * (keep[:, None] * g[:, None])
    if model_group is not None:
        contrib = sharding.reduce_from(contrib, model_group)
    return contrib.reshape(t, top_k, d).sum(dim=1).reshape(b, s, d)


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """p: one layer's ``{router (d, E), w_* (E, d, f) / (E, f, d)}``;
    x (B, S, d), this rank's batch rows.

    Under a mesh whose model axis splits the experts (the ``w_*`` leaves
    are :class:`~repro_torch.models.params.Shard` slices sharded on the
    expert dimension), the expert-parallel path of the reference's
    ``shard_map``: every rank routes its data shard's tokens (the capacity
    counts those tokens), dispatches the slots of its ``E / m`` experts and
    runs them, and the slots' contributions are summed over the model group
    (the ``psum``, taken per slot: ``_moe_local(model_group=)``).  Otherwise the leaves are made whole and one shard runs
    every expert; under data axes alone the positions and the capacity are
    the whole batch's, as the reference's meshless layer sees its
    data-sharded batch."""
    w = p["w_gate"]
    if (isinstance(w, Shard) and w.spec[0] == sharding.MODEL_AXIS
            and sharding.model_shards() > 1):
        group = sharding.get_mesh().group(sharding.MODEL_AXIS)
        experts = [use(p[k], keep=(0,)) for k in ("w_gate", "w_up", "w_down")]
        return _moe_local(use(p["router"]), *experts, x, top_k=cfg.moe_top_k,
                          capacity_factor=cfg.capacity_factor,
                          shard_idx=group.index, num_shards=group.size,
                          model_group=group)
    mesh = sharding.active_mesh()
    route = (None if mesh is None or sharding.model_shards() > 1
             else mesh.group(sharding.DATA_AXES))
    return _moe_local(use(p["router"]), use(p["w_gate"]), use(p["w_up"]),
                      use(p["w_down"]), x, top_k=cfg.moe_top_k,
                      capacity_factor=cfg.capacity_factor, route_group=route)
