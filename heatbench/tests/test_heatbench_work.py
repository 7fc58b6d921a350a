"""Least times, FLOPs and bytes on hand-worked shapes."""
from __future__ import annotations

import pytest

from heatbench import peaks, work


def test_least_time_is_the_larger_bound():
    assert peaks.least_time_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_time_s(0, 134e12) == pytest.approx(2.0)
    assert peaks.least_time_s(6.7e12, 67e12) == pytest.approx(2.0)


def test_ccl_flops_by_hand():
    # per row: forward (4*3 + 6) * 4 = 72, backward (5*3 + 7) * 4 = 88
    assert work.ccl_flops(2, 3, 4) == 2 * (72 + 88)


def test_aggregation_flops_by_hand():
    # per row: forward 2*5*4 + 2*16 + 4*4 = 88, backward 40 + 64 + 12 = 116
    assert work.aggregation_flops(2, 5, 4) == 2 * (88 + 116)
    assert work.aggregation_flops(2, 0, 4) == 0
    assert work.step_model_flops(2, 3, 4, 5) == 320 + 408


def test_paper_scale_step_flops():
    # batch 16,384, n = 64, K = 128, history 100
    ccl = 16384 * (262 + 327) * 128
    agg = 16384 * ((25600 + 32768 + 512) + (25600 + 65536 + 384))
    assert work.step_model_flops(16384, 64, 128, 100) == ccl + agg


def test_bytes_by_hand():
    assert work.row_bytes(128, "fp32") == 512
    assert work.row_bytes(128, "int8") == 132
    # reads 2*512 + 1*132 + 3*512, writes (2 + 1 + 3) * 512
    assert work.ccl_bytes(2, 512, 1, 132, 3, 128) == 2692 + 3072
    assert work.update_bytes(10, 128) == 10 * 3 * 512
    assert work.dequant_gather_bytes(10, 128) == 10 * (132 + 512)
