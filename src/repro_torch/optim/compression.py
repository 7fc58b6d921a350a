"""Error-feedback int8 gradient compression for a cross-pod sum (the port of
``src/repro/optim/compression.py``).

:func:`compressed_psum` replaces an fp32 sum over a group (the ``pod`` axis
of a mesh) with: per-rank int8 quantization (per-row absmax scales), an
all-gather of the int8 payload and the scales, and a local dequantize-and-
sum in group order.  For a group of 2 it moves about 4x fewer bytes than an
fp32 all-reduce.  Error feedback (Seide et al.) adds each call's
quantization residual back into the next call's gradient, so the
compression is unbiased over time.

The quantizer is the reference's arithmetic on the same fp32 values
(``x / scale`` rounded half to even, as ``jnp.round`` does), so the int8
codes equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed import sharding as shd


class CompressionState(NamedTuple):
    """Error-feedback residual buffer, fp32, shaped like the gradient."""

    error: torch.Tensor


def compression_init(grad_like: torch.Tensor) -> CompressionState:
    """Zeroed :class:`CompressionState` shaped like the gradient."""
    return CompressionState(torch.zeros_like(grad_like, dtype=torch.float32))


def quantize_int8(x: torch.Tensor):
    """Row-wise absmax int8 quantization: x (..., K) -> (int8 codes, fp32
    scales (..., 1)), the scale ``max|x| / 127`` clipped at 1e-12."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = (absmax / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 reconstruction ``q * scale`` of an int8-quantized tensor."""
    return q.to(torch.float32) * scale


def compress_with_feedback(grad: torch.Tensor, state: CompressionState):
    """``(int8 payload, scales, new state)`` of ``grad`` plus the carried
    residual; the new residual is what the payload misses."""
    g = grad.to(torch.float32) + state.error
    q, scale = quantize_int8(g)
    return q, scale, CompressionState(g - dequantize_int8(q, scale))


def compressed_psum(grad: torch.Tensor, state: CompressionState,
                    group: shd.AxisGroup):
    """Error-feedback compressed sum of ``grad`` over ``group``; returns
    ``(total, new state)``, ``total`` the same bits on every member.

    One all-gather moves the int8 payload and the fp32 scales together;
    each member then dequantizes and sums the parts in group order."""
    q, scale, new_state = compress_with_feedback(grad, state)
    members = shd.all_gather_parts([q, scale], group)
    total = dequantize_int8(*members[0])
    for qs, ss in members[1:]:
        total = total + dequantize_int8(qs, ss)
    return total, new_state
