"""The embedding-row kernels as hand-written CUDA kernels, each with its
plain PyTorch version: the sparse SGD row update (paper §3.1 / §4.5) with the
duplicate-id pre-reduce fused in, and the int8 gather-dequant.

HEAT writes only the embedding rows the step touched.  The caller sorts the
step's ids with a stable sort; :func:`gather_fma_rows_` then sums each id's
gradients over its run in sorted order (a fixed-order segment sum, so the
result does not depend on thread scheduling) and writes
``table[id] -= lr * sum`` in place, once per unique id.  It replaces the TPU
kernel ``src/repro/kernels/embedding_update.py::gather_fma_rows`` and the
segment sum its wrapper ran in front of it (``src/repro/kernels/ops.py::
sparse_row_update``); ``csrc/gather_fma.cu`` says what bounds it on the card.

:func:`gather_dequant_rows` gathers rows of an int8 table and dequantizes
them (``float(q[id]) * scale[id]``), so the fp32 table never exists; it
replaces ``src/repro/kernels/embedding_update.py::gather_dequant_rows``, and
``csrc/gather_dequant.cu`` says what bounds it on the card.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises; a ``meta`` tensor (the dry run) gets the kernel's output
shape and runs nothing.  :func:`launch_count` counts the gather-FMA dispatches, so
callers can hold the one-launch-per-step contract of ``row_update_many``;
``GATHER_DEQUANT_LAUNCHES`` counts the gather-dequant ones.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tiling
from repro_torch.kernels import _build, segment_sum

GATHER_FMA_LAUNCHES = _build.LaunchCounter("gather_fma")
GATHER_DEQUANT_LAUNCHES = _build.LaunchCounter("gather_dequant")
_P = ctypes.c_void_p
_ARGS = [_P] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, _P]
_DEQUANT_ARGS = [_P] * 4 + [ctypes.c_int] * 2 + [_P]


def launch_count(device_type: str = "cuda") -> int:
    """Gather-FMA dispatches on ``device_type`` since the last reset: kernel
    launches for ``"cuda"``, plain-version calls for ``"cpu"``."""
    return GATHER_FMA_LAUNCHES.count(device_type)


def reset_launch_count() -> None:
    """Zero the gather-FMA dispatch counts."""
    GATHER_FMA_LAUNCHES.reset()


def gather_fma_rows_plain_(table, sids, order, grads, lr):
    """Plain version of :func:`gather_fma_rows_`.  The segment sum runs in
    sorted order, each run in one piece as the kernel sums it
    (``segment_reduce`` sums each run sequentially), and every lane of a run
    writes the same new row, so the scatter is idempotent and needs no
    atomics."""
    b = sids.shape[0]
    if b == 0:
        return table
    seg = tiling.run_index(sids)
    reduced = segment_sum.sequential_sum(seg, grads[order], b)
    table.index_put_((sids,), table[sids] - lr * reduced[seg])
    return table


def gather_fma_rows_(table, sids, order, grads, lr: float):
    """In place: ``table[id] -= lr * (sum of grads[i] with ids[i] == id)``.

    table (R, K); ``sids`` (B,) int64, the step's ids sorted by a stable sort
    and all in ``[0, R)``; ``order`` (B,) int64, that sort's permutation;
    grads (B, K) in the ids' original order.  Returns ``table``."""
    b = sids.shape[0]
    if table.dim() != 2 or grads.shape != (b, table.shape[1]) \
            or order.shape != (b,) or sids.dim() != 1:
        raise ValueError(f"expected table (R, K), sids/order (B,), grads "
                         f"(B, K); got {tuple(table.shape)}, "
                         f"{tuple(sids.shape)}, {tuple(order.shape)}, "
                         f"{tuple(grads.shape)}")
    if table.device.type == "cpu":
        GATHER_FMA_LAUNCHES.bump("cpu")
        return gather_fma_rows_plain_(table, sids, order, grads, lr)
    if table.device.type == "meta":        # the dry run: nothing to write
        GATHER_FMA_LAUNCHES.bump("meta")
        return table
    if table.device.type != "cuda":
        raise ValueError(f"gather_fma_rows_: no kernel for {table.device}")
    _build.check_operands(
        "gather_fma_rows_", table.device,
        [(table, torch.float32), (grads, torch.float32),
         (sids, torch.int64), (order, torch.int64)])
    fn = _build.bind("gather_fma", "gather_fma_rows", _ARGS)
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), sids.data_ptr(), order.data_ptr(),
                 grads.data_ptr(), b, table.shape[1], float(lr),
                 _build.stream_of(table))
    _build.check(err, "gather_fma_rows_")
    GATHER_FMA_LAUNCHES.bump("cuda")
    return table


def gather_dequant_rows_plain(q, scale, ids):
    """Plain version of :func:`gather_dequant_rows`: the same one fp32
    multiply per element, so the two agree bit for bit.  ``ids`` may be any
    row index (an int tensor of any shape, or a slice): this is the port's
    one plain dequantization."""
    return q[ids].to(torch.float32) * scale[ids]


def gather_dequant_rows(q, scale, ids):
    """``out[i] = float(q[ids[i]]) * scale[ids[i]]``: fp32 ``(B, K)`` from an
    int8 ``(R, K)`` payload ``q``, fp32 ``(R, 1)`` scales and int64 ``(B,)``
    ids, all in ``[0, R)``."""
    if q.dim() != 2 or tuple(scale.shape) != (q.shape[0], 1) or ids.dim() != 1:
        raise ValueError(f"expected q (R, K), scale (R, 1), ids (B,); got "
                         f"{tuple(q.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(ids.shape)}")
    if q.device.type == "cpu":
        GATHER_DEQUANT_LAUNCHES.bump("cpu")
        return gather_dequant_rows_plain(q, scale, ids)
    if q.device.type == "meta":            # the dry run: the output's shape
        GATHER_DEQUANT_LAUNCHES.bump("meta")
        return torch.empty((ids.shape[0], q.shape[1]), device="meta")
    if q.device.type != "cuda":
        raise ValueError(f"gather_dequant_rows: no kernel for {q.device}")
    _build.check_operands(
        "gather_dequant_rows", q.device,
        [(q, torch.int8), (scale, torch.float32), (ids, torch.int64)])
    b, k = ids.shape[0], q.shape[1]
    out = torch.empty((b, k), dtype=torch.float32, device=q.device)
    if b == 0 or k == 0:
        return out
    fn = _build.bind("gather_dequant", "gather_dequant_rows", _DEQUANT_ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), scale.data_ptr(), ids.data_ptr(), out.data_ptr(),
                 b, k, _build.stream_of(q))
    _build.check(err, "gather_dequant_rows")
    GATHER_DEQUANT_LAUNCHES.bump("cuda")
    return out
