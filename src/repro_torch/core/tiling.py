"""Random-tiling support: the sorted-intersection tile write-through and the
deterministic segment sum it and the slot reduction share.

CUDA's ``index_add_``, ``scatter_add_`` and ``index_put_(accumulate=True)``
add duplicate rows with atomics in a run-to-run order.  :func:`segment_sum`
instead stably sorts the targets and sums each run sequentially
(``segment_reduce``), so the same inputs give the same bits on every run and
every device.  :func:`gather_rows` is a row gather whose backward is that
segment sum, for tables that take gradients (the LM's embedding and output
tables).

Algorithm 1 (:func:`tune_tiling`) picks the tile size N1 and the refresh
interval N2 from a roofline model of the card (:class:`HardwareModel`): the
cost of a row read from the table (t_m) against one from the resident tile
(t_c).  Its arithmetic is the reference's, line for line, so the two plans
are equal given equal constants; the constants are the H100's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

#: the L2's read rate in bytes/s, the last line of ``tools/probe_kernels.py
#: --parts l2`` on an NVIDIA H100 80GB HBM3 at 700.00 W: the median over
#: buffers of 4-32 MB of each size's best launch shape (6.90e12 at 16 MB to
#: 7.52e12 at 28 MB; 1 GB from HBM 3.07e12).
L2_READ_BYTES_PER_S = 7.2430e12


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


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Roofline constants of one NVIDIA H100 SXM for Algorithm 1.  Each
    field replaces one of the reference's TPU fields:

    * ``hbm_bandwidth`` (the reference's ``hbm_bandwidth``): 3.35 TB/s,
      NVIDIA's data sheet, the rate ``PERF.md``'s bounds use;
    * ``link_bandwidth`` (``ici_bandwidth``): NVLink, 450 GB/s each way
      between two cards of a host (900 GB/s in all);
    * ``cache_bandwidth`` (``vmem_bandwidth``): the read rate of the L2,
      the level that holds the resident tile on this card, as measured
      (:data:`L2_READ_BYTES_PER_S`);
    * ``cache_bytes`` (``vmem_bytes``): the L2's 50 MiB (the card's
      ``L2_cache_size``);
    * ``peak_flops`` (``peak_flops``): 989 TFLOP/s, dense bf16 on the
      tensor cores (data sheet)."""

    hbm_bandwidth: float = 3.35e12       # B/s
    link_bandwidth: float = 450e9        # B/s, one way
    cache_bandwidth: float = L2_READ_BYTES_PER_S
    cache_bytes: int = 50 * 2**20        # L2
    peak_flops: float = 989e12           # bf16

    def row_cost_remote(self, row_bytes: int, model_shards: int) -> float:
        """t_m: one row from the row-sharded table: its HBM read, plus the
        expected share ``(shards - 1) / shards`` of rows owned by another
        card, whose bytes also cross the link."""
        remote_frac = (model_shards - 1) / max(model_shards, 1)
        return (row_bytes / self.hbm_bandwidth
                + remote_frac * row_bytes / self.link_bandwidth)

    def row_cost_local(self, row_bytes: int, tile_bytes: int) -> float:
        """t_c: one row from the resident tile, at the L2's rate when the
        tile fits it, else at HBM's (paper lines 5-13)."""
        bw = (self.cache_bandwidth if tile_bytes <= self.cache_bytes
              else self.hbm_bandwidth)
        return row_bytes / bw


@dataclasses.dataclass(frozen=True)
class TilingPlan:
    """Chosen (N1, N2) tile/refresh sizes with the model's predicted speedup
    of the negative reads, the sampling space and the two row costs."""

    tile_size: int            # N1
    refresh_interval: int     # N2
    predicted_speedup: float
    sampling_space: float     # M/N2 * N1
    t_m: float
    t_c: float


def _f0_tile_size(cache_bytes: int, row_bytes: int, num_shards_per_core: int,
                  num_items: int, max_tile: int = 4096) -> int:
    """Paper line 21: the largest power of two N1 whose tiles
    (``num_shards_per_core`` of them) fit ``cache_bytes``, capped at
    ``max_tile`` and at a quarter of the items."""
    cap = min(max_tile, max(num_items // 4, 1))
    max_rows = min(cache_bytes // max(row_bytes * num_shards_per_core, 1), cap)
    if max_rows < 1:
        return 1
    return 2 ** int(math.floor(math.log2(max_rows)))


def tune_tiling(num_items: int, total_iterations: int, num_negatives: int,
                emb_dim: int, *, expected_speedup: float = 2.0,
                num_positives: int = 1, positive_hit_ratio: float = 0.5,
                alpha: float = 0.15, beta: float = 0.85,
                model_shards: int = 1, tiles_per_core: int = 1,
                bytes_per_elem: int = 4,
                hw: HardwareModel = HardwareModel()) -> TilingPlan:
    """Algorithm 1: the tuned (N1, N2) plan.  The negative speedup model is
    ``t_m N2 / ((N2 - N1) t_c + N1 t_m)``; N2 is the smaller of the one
    that reaches ``beta * expected_speedup`` and the one that keeps the
    sampling space ``M / N2 * N1`` at the item count, never below N1 nor
    above M; alpha/beta are the paper's positive/negative shares (§4.2)."""
    row_bytes = emb_dim * bytes_per_elem
    n1 = _f0_tile_size(hw.cache_bytes, row_bytes, tiles_per_core, num_items)
    n1 = min(n1, max(total_iterations, 1))
    t_m = hw.row_cost_remote(row_bytes, model_shards)
    t_c = hw.row_cost_local(row_bytes, n1 * row_bytes * tiles_per_core)

    target = max(beta * expected_speedup, 1.0 + 1e-6)
    denom = t_m - target * t_c
    if denom <= 0:
        n2_speed = float("inf")
    else:
        n2_speed = target * n1 * (t_m - t_c) / denom
    n2_space = total_iterations * n1 / max(num_items, 1)
    n2 = max(n1, min(n2_speed, n2_space))
    n2 = int(max(1, min(n2, total_iterations)))

    achieved = t_m * n2 / ((n2 - n1) * t_c + n1 * t_m) if n2 > 0 else 1.0
    pos_speedup = (num_positives * t_m) / (
        num_positives * positive_hit_ratio * t_c
        + num_positives * (1 - positive_hit_ratio) * t_m)
    total = alpha * pos_speedup + beta * achieved
    return TilingPlan(tile_size=n1, refresh_interval=n2,
                      predicted_speedup=total,
                      sampling_space=total_iterations / max(n2, 1) * n1,
                      t_m=t_m, t_c=t_c)
