"""Block-wise (flash) attention forward with GQA, as a hand-written CUDA
kernel for Hopper (``csrc/flash_attention.cu``), replacing the TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention``.

q (B, Hq, S, D), k/v (B, Hkv, S, D) with Hq a multiple of Hkv -> (B, Hq, S,
D), causal or full, fp32, ``scale`` 1/sqrt(D) unless given.  The plain
version is ``kernels/ref.py::attention_ref`` (full materialization).  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises.
The kernel takes S a multiple of 64 (its query and key tile, as the
reference asserts ``S % block == 0``) and D in {32, 64, 128}.  Forward
only, as the reference's kernel; ``FLASH_LAUNCHES`` counts dispatches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

FLASH_LAUNCHES = _build.LaunchCounter("flash_attention")
#: the kernel's query and key tile: S must be a multiple of it.
BLOCK = 64
HEAD_DIMS = (32, 64, 128)

_P = ctypes.c_void_p
_ARGS = [_P] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, _P]


def _shapes(q, k, v) -> tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:] \
            or q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"expected q (B, Hq, S, D) and k, v (B, Hkv, S, D) "
                         f"with Hq % Hkv == 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    return b, hq, k.shape[1], s, d


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """Attention forward through the kernel (CUDA) or ``attention_ref``
    (CPU)."""
    b, hq, hkv, s, d = _shapes(q, k, v)
    if q.device.type == "cpu":
        FLASH_LAUNCHES.bump("cpu")
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel or plain version for "
                         f"{q.device}")
    _build.check_operands("flash_attention", q.device,
                          [(x, torch.float32) for x in (q, k, v)])
    if s % BLOCK or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes S % {BLOCK} == 0 "
                         f"and D in {HEAD_DIMS}, got S={s}, D={d}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _build.bind("flash_attention", "flash_attention_fwd", _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 hq, hkv, s, d, scale, int(causal), _build.stream_of(q))
    _build.check(err, "flash_attention")
    FLASH_LAUNCHES.bump("cuda")
    return out
