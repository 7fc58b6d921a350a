"""The int8 table update's stochastic requantize as a hand-written CUDA
kernel, with its plain PyTorch version: after the duplicate pre-reduce
(``optim/quantization.py::_dedup``), each segment's row is dequantized with
its residual, takes ``-lr * g``, is requantized with stochastic rounding
``floor(x + u)``, and its rounding error is requantized as the new residual;
the payload, scale, residual and residual scale are written in place.

The plain version works on every lane of the update and scatters every lane,
each lane of a run writing its segment's values; the lanes past the last
segment recompute row 0 and are thrown away.  The kernel
(``csrc/requantize_rows.cu``) reads the segment count ``seg[-1] + 1`` on the
card and works and writes the live segments only, with the same arithmetic,
so the stored bits are the same.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises; a ``meta`` tensor (the dry run) runs nothing.
``REQUANTIZE_LAUNCHES`` counts the dispatches; :func:`requantized_rows` is
the card's count of the segments the kernel requantized.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_update import gather_dequant_rows_plain

#: scale floor: an all-zero row (absmax 0) gets this scale instead of a
#: division by zero, and still dequantizes to exact zeros.
SCALE_FLOOR = 1e-12

#: the widest row the kernel takes (eight float4 pieces a lane).
MAX_K = 1024

REQUANTIZE_LAUNCHES = _build.LaunchCounter("requantize_rows")
_P = ctypes.c_void_p
_ARGS = [_P] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float, _P]
_REQUANTIZED: dict[torch.device, torch.Tensor] = {}


def requantized_rows(device) -> torch.Tensor:
    """The card's int64 count (shape (1,)) of the segments the kernel
    requantized on ``device`` since the process started; read it after a
    sync.  The step never reads it."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    counter = _REQUANTIZED.get(device)
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int64, device=device)
        _REQUANTIZED[device] = counter
    return counter


def row_quantize(x: torch.Tensor):
    """Symmetric per-row absmax: (..., K) fp32 -> (int8, (..., 1) fp32),
    round to nearest (ties to even, as ``jnp.round``)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = (absmax / 127.0).clamp_min(SCALE_FLOOR).to(torch.float32)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def requantize_rows_plain_(q, scale, err, err_scale, sids, seg, uids, reduced, noise,
                           lr: float) -> None:
    """Plain version of :func:`requantize_rows_`, on every lane: segment j
    in lane j, the lanes past the last segment on row 0 (never stored).
    Every lane of a run writes its segment's values: the writes to one row
    are identical, so the scatter is idempotent without atomics."""
    rows = gather_dequant_rows_plain(q, scale, uids)
    resid = gather_dequant_rows_plain(err, err_scale, uids)
    new_rows = rows + resid - lr * reduced

    absmax = new_rows.abs().amax(dim=-1, keepdim=True)
    new_scale = (absmax / 127.0).clamp_min(SCALE_FLOOR).to(torch.float32)
    q_new = torch.floor(new_rows / new_scale + noise).clamp(-127, 127).to(torch.int8)
    e = new_rows - q_new.to(torch.float32) * new_scale
    eq, escale = row_quantize(e)

    for dst, src in ((q, q_new), (scale, new_scale), (err, eq), (err_scale, escale)):
        dst.index_put_((sids,), src[seg])


def requantize_rows_(q, scale, err, err_scale, sids, seg, uids, reduced, noise,
                     lr: float) -> None:
    """Requantize the updated rows of an int8 table in place: ``q`` (R, K)
    int8, ``scale`` (R, 1) fp32, ``err`` (R, K) int8, ``err_scale`` (R, 1)
    fp32; from the duplicate pre-reduce, ``sids`` the sorted ids, ``seg``
    each sorted lane's segment, ``uids`` segment j's id in lane j and
    ``reduced`` its gradient sum (all (b,) int64 but ``reduced`` (b, K)
    fp32); ``noise`` (b, K) fp32 in ``[0, 1)``, row j for segment j.  The
    kernel reads ``uids``, ``seg[-1]``, ``reduced`` and ``noise`` of the
    live segments only and never reads ``sids``.  No host sync."""
    b = sids.shape[0]
    k = q.shape[-1]
    shapes = [(q, (q.shape[0], k)), (scale, (q.shape[0], 1)), (err, tuple(q.shape)),
              (err_scale, (q.shape[0], 1)), (sids, (b,)), (seg, (b,)), (uids, (b,)),
              (reduced, (b, k)), (noise, (b, k))]
    if q.dim() != 2 or any(tuple(t.shape) != want for t, want in shapes):
        raise ValueError("expected q, err (R, K), scale, err_scale (R, 1), sids, seg, "
                         "uids (b,), reduced, noise (b, K); got "
                         + ", ".join(str(tuple(t.shape)) for t, _ in shapes))
    dev = q.device
    if dev.type == "meta":                  # the dry run: nothing to compute
        REQUANTIZE_LAUNCHES.bump("meta")
        return
    if dev.type == "cpu":
        REQUANTIZE_LAUNCHES.bump("cpu")
        requantize_rows_plain_(q, scale, err, err_scale, sids, seg, uids, reduced, noise,
                               lr)
        return
    if dev.type != "cuda":
        raise ValueError(f"requantize_rows_: no kernel for {dev}")
    _build.check_operands("requantize_rows_", dev, [
        (q, torch.int8), (scale, torch.float32), (err, torch.int8),
        (err_scale, torch.float32), (seg, torch.int64), (uids, torch.int64),
        (reduced, torch.float32), (noise, torch.float32)])
    if k % 4 != 0 or k > MAX_K:
        raise ValueError(f"requantize_rows_: the CUDA kernel takes K % 4 == 0 and "
                         f"K <= {MAX_K}, got K = {k}")
    if (q.data_ptr() | err.data_ptr()) % 4 or (reduced.data_ptr() | noise.data_ptr()) % 16:
        raise ValueError("requantize_rows_: the CUDA kernel takes int8 rows 4-byte and "
                         "fp32 rows 16-byte aligned")
    if b == 0:
        return
    fn = _build.bind("requantize_rows", "requantize_rows", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), scale.data_ptr(), err.data_ptr(), err_scale.data_ptr(),
                seg.data_ptr(), uids.data_ptr(), reduced.data_ptr(), noise.data_ptr(),
                requantized_rows(dev).data_ptr(), b, k, lr, SCALE_FLOOR,
                _build.stream_of(q))
    _build.check(rc, "requantize_rows_")
    REQUANTIZE_LAUNCHES.bump("cuda")
