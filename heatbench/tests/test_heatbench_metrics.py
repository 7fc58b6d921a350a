"""Every per-layer metric reader, and the trace's busy, idle and breakdown
arithmetic, on a small synthetic trace."""
from __future__ import annotations

import json

import pytest
import torch

from heatbench import harness, peaks, profiling, spec, work
from heatbench.profiling import Trace, read_chrome_trace

OPS = [("void (anonymous namespace)::ccl_stats_kernel<4>(float const*)", 0.10, 0.01),
       ("void (anonymous namespace)::ccl_bwd_kernel<4>(float const*)", 0.20, 0.02),
       ("void at::native::radixSortKVInPlace<-2, -1, 32>(...)", 0.30, 0.05),
       ("void at_cuda_detail::cub::DeviceScanKernel<...>", 0.35, 0.01),
       ("gather_fma_kernel(float*, long const*)", 0.50, 0.04),
       ("gather_fma_kernel(float*, long const*)", 0.52, 0.04),
       ("Memcpy DtoH (Device -> Pinned)", 0.90, 0.05)]
CALLS = [("cudaLaunchKernel", 0.14, 0.03), ("cudaStreamSynchronize", 0.6, 0.3)]
CONFIG = {"emb_dim": 4, "num_negatives": 2, "tile_size": 8, "history_len": 0,
          "table_format": "fp32"}
TRAFFIC = {"batch_size": 2}


def ctx(ops=OPS, config=CONFIG, batches=None, samples_per_s=4.0):
    batches = batches or [(torch.tensor([0, 0]), torch.tensor([1, 2]), None)] * 2
    return harness.MetricContext(config, TRAFFIC, 2,
                                 Trace(1.0, list(ops), list(CALLS)), batches,
                                 torch.arange(8), samples_per_s)


def read(name, c):
    return spec.metric_reader(name)(c)


def test_busy_idle_and_gaps():
    t = ctx().trace
    # [.10,.11] [.20,.22] [.30,.36] [.50,.56] [.90,.95]
    assert t.busy_s() == pytest.approx(0.20)
    gaps = t.idle_gaps()
    assert sum(d for _, _, d in gaps) == pytest.approx(0.80)
    # between ops: .11-.20 (mid .155, in the launch), .22-.30, .36-.50,
    # .56-.90 (mid .73, in the sync); the edges: 1.0 - .85
    assert [g[0] for g in gaps] == (
        ["cudaLaunchKernel"] + [profiling.PYTHON] * 2
        + ["cudaStreamSynchronize", profiling.EDGES])
    bd = t.breakdown()
    assert bd["device_ops"][0][0].startswith("gather_fma_kernel")
    assert bd["device_ops"][0][1] == pytest.approx(0.08)
    assert bd["idle_gaps"][0] == ["cudaStreamSynchronize: all 1 gaps",
                                  pytest.approx(0.34)]
    assert bd["idle_gaps"][2] == [f"{profiling.PYTHON}: all 2 gaps",
                                  pytest.approx(0.22)]
    assert bd["idle_gaps"][3] == [f"{profiling.PYTHON}: longest gap",
                                  pytest.approx(0.14)]
    assert bd["idle_gaps"][4] == [f"{profiling.EDGES}: all 1 gaps",
                                  pytest.approx(0.15)]


def test_launches_idle_and_sort():
    c = ctx()
    assert read("step.launches", c) == pytest.approx(3.5)
    assert read("device.idle_pct", c) == pytest.approx(80.0)
    assert read("update.sort_us", c) == pytest.approx(30000.0)


def test_ccl_roofline_by_hand():
    # per step: 1 distinct user, 2 positives, min(8, 2 * 2) = 4 negative
    # rows, 16 bytes a row: reads 7 * 16, writes 7 * 16; 248 FLOPs
    least = max(224 / peaks.HBM_BYTES_PER_S, 248 / peaks.FP32_FLOP_PER_S)
    assert read("kernel.ccl_roofline", ctx()) == pytest.approx(
        100 * least * 2 / 0.03)


def test_rows_roofline_fp32_and_int8_by_hand():
    # fp32, #6: users 1 row, items {1, 2} with the tile's 8 ids = 8 rows
    least = (peaks.least_time_s(48, 16) + peaks.least_time_s(384, 104))
    assert read("kernel.rows_roofline", ctx()) == pytest.approx(
        100 * least * 2 / 0.08)
    # int8, #5: three gathers, 1 / 2 / 3 distinct rows of 4 + 4 + 16 bytes
    cfg = dict(CONFIG, table_format="int8", history_len=2)
    ops = [(n.replace("gather_fma_kernel", "gather_dequant_kernel"), s, d)
           for n, s, d in OPS]
    hist = torch.tensor([[3, 4], [5, 3]])
    c = ctx(ops, cfg, [(torch.tensor([0, 0]), torch.tensor([1, 2]), hist)] * 2)
    least = sum(peaks.least_time_s(rows * 24, lanes * 4)
                for rows, lanes in ((1, 2), (2, 2), (3, 4)))
    assert read("kernel.rows_roofline", c) == pytest.approx(
        100 * least * 2 / 0.08)


def test_mfu_by_hand():
    # 4 samples/s at batch 2: 2 steps a second, from the untraced window
    flops = work.step_model_flops(2, 2, 4, 0)
    assert read("train.mfu_pct", ctx()) == pytest.approx(
        100 * flops * 2 / peaks.FP32_FLOP_PER_S)


@pytest.mark.parametrize("name", ["step.launches", "update.sort_us",
                                  "kernel.ccl_roofline", "kernel.rows_roofline",
                                  "device.idle_pct", "train.mfu_pct"])
def test_reader_with_nothing_to_read_returns_none(name):
    assert read(name, ctx(ops=[], samples_per_s=0.0)) is None


def test_chrome_trace_keeps_device_ops_and_cuda_calls(tmp_path):
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1000.0, "dur": 6.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1100.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 1900.0, "dur": 50.0},
        {"ph": "X", "cat": "Kernel", "name": "k2", "ts": 1950.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1100.0,
         "dur": 5.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = read_chrome_trace(str(path), 2e-3)
    assert t.window_s == pytest.approx(2e-3)
    assert [n for n, _, _ in t.ops] == ["k1", "m", "k2"]
    assert [n for n, _, _ in t.calls] == ["cudaLaunchKernel"]
    assert t.ops[0][1] == pytest.approx(1.1e-3)
    assert t.busy_s() == pytest.approx(65e-6)
    # 2 ms of wall time less the 855 us from k1's start to k2's end
    assert t.idle_gaps()[-1][2] == pytest.approx(2e-3 - 855e-6)


def test_off_the_card_nothing_is_traced():
    t = profiling.profile(lambda: None, "cpu")
    assert t.ops == [] and t.calls == [] and t.window_s >= 0
