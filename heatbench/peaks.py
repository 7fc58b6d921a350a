"""The card's peaks and the least time of a piece of work.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
80 GB of HBM3 at 3.35 TB/s, 67 TFLOP/s in fp32 off the tensor cores, the
rate of every model product here (both configurations compute in fp32 with
TF32 off).  The rates assume the card's full 700 W; a run reports the
card's power limit beside every share of a peak.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def least_time_s(nbytes: float, flops: float) -> float:
    """The least seconds the card could take for ``nbytes`` of HBM traffic
    and ``flops`` fp32 operations: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
