"""Int8 embedding tables with per-row fp32 scales (the port of
``src/repro/optim/quantization.py``).

A :class:`QuantizedTable` holds a symmetric per-row absmax int8 payload, one
fp32 scale per row, and an int8-quantized error-feedback residual of the last
update of each row: about 2.1 bytes per element of training carry against 4
for fp32.  The accessors (:func:`gather_rows`, :func:`num_rows`, ...) take a
plain ``(R, K)`` tensor or a :class:`QuantizedTable`, so the step, the
samplers and the tile need no branch of their own.  The fp32 table is never
built in the hot path: only gathered rows are dequantized, inside the CUDA
gather-dequant kernel (``kernels/embedding_update.py``) when the caller asks
for it.

Updates (:func:`apply_updates`) requantize only the touched rows, with
stochastic rounding ``floor(x + u)`` whose noise ``u`` is drawn by
:func:`uniform_noise` from the caller's generator, so a quantized trajectory
is pure in (seed, step) and restarts bit for bit.  The update is
deterministic on the card: a stable sort, a fixed-order segment sum into the
reference's compacted layout (segment j in lane j), the requantization of the
segments, and a scatter in which every lane of a run of equal ids writes its
segment's values — no atomics, no host sync.  The tables are updated in
place, as the fp32 tables are.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.core import tiling
from repro_torch.distributed.sharding import ShardedRows
from repro_torch.kernels.embedding_update import (
    gather_dequant_rows, gather_dequant_rows_plain)

#: scale floor: an all-zero row (absmax 0) gets this scale instead of a
#: division by zero, and still dequantizes to exact zeros.
SCALE_FLOOR = 1e-12

#: the table_format vocabulary (MFConfig.table_format).
TABLE_FORMATS = ("fp32", "int8")

#: rows quantized per pass by :func:`quantize_table`, which bounds the fp32
#: temporaries of a full-table quantization (the result does not depend on
#: it: the quantization is per row).
QUANTIZE_CHUNK_ROWS = 1 << 20


class QuantizedTable(NamedTuple):
    """One embedding table in int8 form: ``q`` (R, K) int8 payload,
    ``scale`` (R, 1) fp32 (``row = q * scale``), and ``err``/``err_scale``
    the int8-quantized error-feedback residual (training state)."""

    q: torch.Tensor
    scale: torch.Tensor
    err: torch.Tensor
    err_scale: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        """Logical (R, K) table shape."""
        return tuple(self.q.shape)

    @property
    def dtype(self) -> torch.dtype:
        """Logical element dtype (what dequantized rows come out as)."""
        return self.scale.dtype

    @property
    def device(self) -> torch.device:
        """The device the table lives on."""
        return self.q.device


Table = Union[torch.Tensor, QuantizedTable]


def _row_quantize(x: torch.Tensor):
    """Symmetric per-row absmax: (..., K) fp32 -> (int8, (..., 1) fp32),
    round to nearest (ties to even, as ``jnp.round``)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = (absmax / 127.0).clamp_min(SCALE_FLOOR).to(torch.float32)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def uniform_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """``U[0, 1)`` fp32 noise of ``shape`` from ``gen``: the one place the
    rounding draws happen (tests replay the reference's draws here)."""
    return torch.rand(tuple(shape), generator=gen, device=device,
                      dtype=torch.float32)


def stochastic_round(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Unbiased stochastic rounding to the integer grid: ``floor(x + u)``
    with ``u ~ U[0, 1)``, so ``E[round(x)] == x``."""
    return torch.floor(x + uniform_noise(gen, x.shape, x.device))


def quantize_table(x: torch.Tensor) -> QuantizedTable:
    """fp32 (R, K) table -> :class:`QuantizedTable` (round to nearest, zero
    residual: the init and import path; training rounds stochastically).
    Quantizes :data:`QUANTIZE_CHUNK_ROWS` rows at a time."""
    x = x.to(torch.float32)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    for start in range(0, x.shape[0], QUANTIZE_CHUNK_ROWS):
        stop = start + QUANTIZE_CHUNK_ROWS
        q[start:stop], scale[start:stop] = _row_quantize(x[start:stop])
    return QuantizedTable(q=q, scale=scale, err=torch.zeros_like(q),
                          err_scale=torch.full_like(scale, SCALE_FLOOR))


def dequantize_rows(table: QuantizedTable, ids: torch.Tensor) -> torch.Tensor:
    """Gather and dequantize rows ``ids`` (any int shape) -> fp32
    ``ids.shape + (K,)``, in plain PyTorch."""
    return gather_dequant_rows_plain(table.q, table.scale, ids)


def dequantize_table(table: Table) -> torch.Tensor:
    """The whole fp32 table: offline and evaluation paths only, never the
    training step."""
    if not isinstance(table, QuantizedTable):
        return table
    return gather_dequant_rows_plain(table.q, table.scale, slice(None))


def gather_rows(table: Table, ids: torch.Tensor, *,
                use_kernel: bool = False) -> torch.Tensor:
    """Row gather of either layout: ``table[ids]`` for a plain tensor (with
    the deterministic backward of ``tiling.gather_rows``, so gradients that
    reach a table add in a fixed order), dequantized rows for a quantized
    one.  ``use_kernel=True`` sends a
    quantized gather through the gather-dequant kernel (its plain version on
    CPU tensors); ``ids`` may have any shape.  A row-sharded
    :class:`~repro_torch.distributed.sharding.ShardedRows` table (an LM
    vocab table under a model axis) takes its owner-masked lookup."""
    if isinstance(table, ShardedRows):
        return table.lookup(ids)
    if not isinstance(table, QuantizedTable):
        return tiling.gather_rows(table, ids)
    if use_kernel:
        rows = gather_dequant_rows(table.q, table.scale, ids.reshape(-1))
        return rows.reshape(tuple(ids.shape) + (table.q.shape[1],))
    return dequantize_rows(table, ids)


def num_rows(table: Table) -> int:
    """Logical row count of either layout."""
    return table.shape[0]


def logical_dtype(table: Table) -> torch.dtype:
    """The dtype dequantized rows come out as."""
    return table.dtype


def slice_rows(table: Table, start: int, stop: int) -> torch.Tensor:
    """Row slice ``table[start:stop]`` as fp32-equivalent rows."""
    if not isinstance(table, QuantizedTable):
        return table[start:stop]
    return gather_dequant_rows_plain(table.q, table.scale, slice(start, stop))


def pad_rows(table: Table, pad: int) -> Table:
    """The table with ``pad`` zero rows appended (a copy); an int8 table's
    padding has zero payloads and the floor scale, so it dequantizes to
    zeros."""
    if pad == 0:
        return table
    if not isinstance(table, QuantizedTable):
        return torch.nn.functional.pad(table, (0, 0, 0, pad))
    return QuantizedTable(
        q=torch.nn.functional.pad(table.q, (0, 0, 0, pad)),
        scale=torch.nn.functional.pad(table.scale, (0, 0, 0, pad),
                                      value=SCALE_FLOOR),
        err=torch.nn.functional.pad(table.err, (0, 0, 0, pad)),
        err_scale=torch.nn.functional.pad(table.err_scale, (0, 0, 0, pad),
                                          value=SCALE_FLOOR))


def dynamic_slice_rows(table: Table, start: int, count: int) -> torch.Tensor:
    """``count`` rows from ``start`` as fp32-equivalent rows, indexed as
    ``lax.dynamic_slice_in_dim`` indexes: a negative ``start`` counts from
    the end, then ``start`` moves into ``[0, R - count]``, so the slice
    always holds ``count`` rows."""
    rows, start = num_rows(table), int(start)
    start = min(max(start + rows if start < 0 else start, 0), rows - count)
    return slice_rows(table, start, start + count)


def table_spec(tree):
    """Hashable ``(structure, ((shape, dtype), ...))`` of a table or a
    tuple/list of tables, a :class:`QuantizedTable` counting as its four
    leaves: tells fp32 from int8 layouts and mismatched shapes, which is
    what ``BatchingRecommender`` checks a refresh against.  Dtypes are
    named as numpy names them (``float32``, ``int8``)."""
    leaves = []

    def walk(t) -> str:
        if isinstance(t, QuantizedTable):
            leaves.extend(t)
            return "QuantizedTable(q, scale, err, err_scale)"
        if isinstance(t, (tuple, list)):
            return "(" + ", ".join(walk(x) for x in t) + ")"
        leaves.append(t)
        return "*"

    structure = walk(tree)
    return (structure, tuple((tuple(x.shape), str(x.dtype).removeprefix("torch."))
                             for x in leaves))


def table_nbytes(table: Table) -> int:
    """Serving/checkpoint bytes of the table proper: payload + scales for
    int8 (the residual is optimizer state, see :func:`carry_nbytes`)."""
    if isinstance(table, QuantizedTable):
        return (table.q.numel() * table.q.element_size()
                + table.scale.numel() * table.scale.element_size())
    return table.numel() * table.element_size()


def carry_nbytes(table: Table) -> int:
    """Training-carry bytes (payload + scales + residual for int8)."""
    if isinstance(table, QuantizedTable):
        return sum(t.numel() * t.element_size() for t in table)
    return table_nbytes(table)


def table_all_finite(table: Table) -> torch.Tensor:
    """0-d bool tensor: every value finite.  Int8 payloads cannot hold
    NaN or inf, so only the scales are checked."""
    if isinstance(table, QuantizedTable):
        return (torch.isfinite(table.scale).all()
                & torch.isfinite(table.err_scale).all())
    return torch.isfinite(table).all()


def max_row_norm(table: Table) -> torch.Tensor:
    """0-d fp32: the largest L2 norm of a served row, without building the
    dequantized table (``scale_r * ||q_r||``)."""
    if isinstance(table, QuantizedTable):
        qn = torch.sqrt((table.q.to(torch.float32) ** 2).sum(-1))
        return (table.scale[:, 0] * qn).max()
    return torch.sqrt((table * table).sum(-1).max())


def _dedup(ids: torch.Tensor, grads: torch.Tensor):
    """The §4.5 pre-reduction of duplicate ids, with no atomics and no host
    sync.  ``ids`` (b,), ``grads`` (b, K).  Returns ``(sids, seg, uids,
    reduced)``: the ids sorted by a stable sort, each sorted lane's segment
    (run) index, and in the reference's compacted layout the id of segment
    j and its gradient sum in lane j (summed in sorted order, which is the
    ids' original order).  Lanes past the last segment hold id 0 and a zero
    sum; nothing is scattered from them."""
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    seg = tiling.run_index(sids)
    reduced = tiling.sorted_segment_sum(seg, grads, ids.shape[0], order=order)
    # Every lane of a run writes the same id, so the scatter needs no atomics.
    uids = torch.zeros_like(sids).index_put_((seg,), sids)
    return sids, seg, uids, reduced


def apply_updates(table: QuantizedTable, ids: torch.Tensor, grads: torch.Tensor,
                  lr: float, gen: torch.Generator) -> QuantizedTable:
    """SGD on the touched rows of a quantized table, in place: pre-reduce
    duplicate ids, dequantize the unique rows plus their residual, apply
    ``-lr * grad``, requantize with stochastic rounding, store the new
    payload, scale and residual.  ``gen`` must derive from the step's
    (seed, step) key; its noise has the reference's shape (every lane,
    ``(b, K)``) and segment j takes row j of it.  Returns ``table``."""
    ids = ids.reshape(-1)
    grads = grads.reshape(-1, grads.shape[-1]).to(torch.float32)
    if ids.shape[0] == 0:
        return table
    sids, seg, uids, g = _dedup(ids, grads)

    rows = dequantize_rows(table, uids)
    resid = gather_dequant_rows_plain(table.err, table.err_scale, uids)
    new_rows = rows + resid - lr * g

    absmax = new_rows.abs().amax(dim=-1, keepdim=True)
    new_scale = (absmax / 127.0).clamp_min(SCALE_FLOOR).to(torch.float32)
    q_new = stochastic_round(new_rows / new_scale, gen).clamp(-127, 127) \
        .to(torch.int8)
    err = new_rows - q_new.to(torch.float32) * new_scale
    eq, escale = _row_quantize(err)

    # Every lane of a run writes its segment's values: the writes to one row
    # are identical, so the scatter is idempotent without atomics.
    for dst, src in ((table.q, q_new), (table.scale, new_scale),
                     (table.err, eq), (table.err_scale, escale)):
        dst.index_put_((sids,), src[seg])
    return table


def apply_updates_many(table: QuantizedTable, groups, lr: float,
                       gen: torch.Generator) -> QuantizedTable:
    """All of a step's gradient groups (positives, negatives, history) in
    ONE pre-reduce and requantize pass, so each touched row is requantized
    once per step."""
    return apply_updates(table, *tiling.concat_groups(groups), lr, gen)
