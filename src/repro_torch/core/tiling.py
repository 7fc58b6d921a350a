"""Random-tiling support: the sorted-intersection tile write-through and the
deterministic segment sum it and the slot reduction share.

CUDA's ``index_add_``, ``scatter_add_`` and ``index_put_(accumulate=True)``
add duplicate rows with atomics in a run-to-run order.  :func:`segment_sum`
instead stably sorts the targets and sums each run sequentially
(``segment_reduce``), so the same inputs give the same bits on every run and
every device.  :func:`gather_rows` is a row gather whose backward is that
segment sum, for tables that take gradients (the LM's embedding and output
tables).  Algorithm 1 (``tune_tiling``) and its hardware model wait for
a later slice.
"""
from __future__ import annotations

import torch


def concat_groups(groups):
    """Flatten and concatenate ``[(ids, grads), ...]`` gradient groups into
    one ``(ids (B,), grads (B, K))`` pair."""
    ids = torch.cat([i.reshape(-1) for i, _ in groups])
    grads = torch.cat([g.reshape(-1, g.shape[-1]) for _, g in groups])
    return ids, grads


def run_index(sids):
    """Run index of each lane of sorted ``sids`` (B,): 0 for the lanes of
    the first run of equal values, 1 for the next run, and so on."""
    first = torch.ones(sids.shape, dtype=torch.bool, device=sids.device)
    first[1:] = sids[1:] != sids[:-1]
    return torch.cumsum(first, 0) - 1


def segment_sum(idx, values, num_segments: int):
    """``out[s] = sum(values[i] for i with idx[i] == s)``, summed in the
    order of ``i``: (num_segments, K) from idx (M,) in ``[0, num_segments]``
    and values (M, K).  Entries with ``idx == num_segments`` are dropped:
    they sort last and are not summed at all.  Sort-based, with no atomics
    and no host sync."""
    order = torch.argsort(idx, stable=True)
    return sorted_segment_sum(idx[order], values[order], num_segments)


def sorted_segment_sum(sidx, values, num_segments: int):
    """:func:`segment_sum` of inputs already sorted by ``sidx`` (stably):
    each run is summed sequentially, in the given order.  ``segment_reduce``
    gets the lengths of the ``num_segments`` kept segments only, so the
    sorted tail with ``sidx == num_segments`` (the dropped entries) is never
    summed: their lengths add up to fewer rows than ``values`` has, which
    ``unsafe=True`` accepts."""
    bounds = torch.searchsorted(
        sidx, torch.arange(num_segments + 1, dtype=sidx.dtype,
                           device=sidx.device))
    return torch.segment_reduce(values, "sum", lengths=bounds.diff(),
                                axis=0, unsafe=True)


def tile_write_through(tile_ids, tile_emb, ids, grads, lr: float):
    """Apply ``-lr * grads`` addressed by *global* item id to the resident
    tile copy; returns the new ``tile_emb``.

    Each update id is located by binary search against the sorted tile ids;
    hits add into their tile row (duplicates accumulate, matching the
    table's scatter-add semantics) and misses are dropped.  ``tile_ids``
    must be distinct, in any order."""
    ids = ids.reshape(-1)
    g = grads.reshape(-1, grads.shape[-1])
    n1 = tile_ids.shape[0]
    order = torch.argsort(tile_ids)
    sorted_ids = tile_ids[order]
    slot = torch.searchsorted(sorted_ids, ids)
    slot_c = torch.clamp_max(slot, n1 - 1)
    hit = sorted_ids[slot_c] == ids
    target = torch.where(hit, order[slot_c], torch.full_like(slot_c, n1))
    return tile_emb + segment_sum(target, (-lr * g).to(tile_emb.dtype), n1)


class GatherRows(torch.autograd.Function):
    """``table[ids]`` whose backward scatters the rows' gradients into a
    dense (R, K) table gradient with :func:`segment_sum` — each row's
    duplicates summed in id order, no atomics — where PyTorch's own
    indexing backward (``index_put_`` with accumulate) adds them with
    atomics on the card."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        return segment_sum(ids.reshape(-1), g, ctx.rows), None


def gather_rows(table, ids):
    """Rows ``table[ids]`` (ids of any shape) with a deterministic backward
    (:class:`GatherRows`)."""
    return GatherRows.apply(table, ids)
