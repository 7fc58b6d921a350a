"""The benchmark's join of the program's spans with a traced stretch
(``heatbench/spans.py``) and the four readers built on it, on a synthetic
trace and synthetic spans worked by hand."""
from __future__ import annotations

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from heatbench import harness, spec  # noqa: E402
from heatbench import spans as hs  # noqa: E402
from heatbench.profiling import Trace  # noqa: E402
from repro_torch.train import spans  # noqa: E402

ANCHOR = "cudaStreamQuery"
#: host seconds = trace seconds + OFFSET
OFFSET = 100.0


def _span(name, start, end, parent, step):
    ns = lambda t: round((t + OFFSET) * 1e9)  # noqa: E731
    return spans.Span(name, ns(start), ns(end), parent, step)


# One window [0, .1] of two steps; times in trace seconds.
SPANS = [_span("window", 0.000, 0.100, -1, None),
         _span("step", 0.002, 0.040, 0, 0),
         _span("sample", 0.005, 0.010, 1, 0),
         _span("update.item", 0.020, 0.030, 1, 0),
         _span("step", 0.050, 0.090, 0, 1),
         _span("sample", 0.055, 0.060, 4, 1),
         _span("tile.write", 0.070, 0.080, 4, 1)]
ANCHORS = [(round((0.0010 + OFFSET) * 1e9), round((0.0012 + OFFSET) * 1e9))]
#: host calls: the anchor, enqueue calls, a sync
CALLS = [(ANCHOR, 0.0010, 0.0002),
         ("cudaLaunchKernel", 0.006, 0.001),        # sample, step 0
         ("cudaMemsetAsync", 0.021, 0.001),         # update.item
         ("cudaLaunchKernelExC", 0.025, 0.001),     # update.item
         ("cudaLaunchKernel", 0.045, 0.001),        # window, between steps
         ("cuLaunchKernel", 0.056, 0.001),          # sample, step 1
         ("cudaLaunchKernel", 0.071, 0.001),        # tile.write
         ("cudaMemcpyAsync", 0.101, 0.002),         # the readback
         ("cudaStreamSynchronize", 0.103, 0.008)]
OPS = [("gather_kernel", 0.007, 0.002),
       ("Memset (Device)", 0.022, 0.001),
       ("segment_reduce_forward_kernel", 0.026, 0.004),
       ("stack_kernel", 0.046, 0.001),
       ("gather_kernel", 0.057, 0.002),
       ("add_kernel", 0.072, 0.003),
       ("Memcpy DtoH (Device -> Pageable)", 0.110, 0.001)]
WINDOW_S = 0.12


def _trace(ops=OPS, calls=CALLS):
    return Trace(WINDOW_S, list(ops), list(calls))


def _rec(span_list=SPANS, anchors=ANCHORS):
    return spans.Recording(tuple(span_list), tuple(anchors), 0), ANCHOR


@pytest.fixture
def ctx(monkeypatch):
    """A metric context over the synthetic trace, with the program's
    recording replaced by the synthetic spans."""
    monkeypatch.setattr(hs, "recording", lambda: _rec())
    return harness.MetricContext({}, {"batch_size": 2}, 2, _trace(), [],
                                 torch.arange(2), 1.0)


def test_join_pairs_calls_and_operations_in_order():
    j = hs.join(_trace(), _rec())
    assert j is not None and j.lost == 0 and j.steps == 2
    assert j.offsets == [pytest.approx(OFFSET)]
    names = [j.spans[i][0] if i >= 0 else None for i in j.owner]
    assert names == ["sample", "update.item", "update.item", "window",
                     "sample", "tile.write", None]
    assert j.spans[1][1] == pytest.approx(0.002)


def test_device_us_by_span():
    j = hs.join(_trace(), _rec())
    # (.001 + .004 + .003) s over 2 steps; (.002 + .002) s over 2 steps
    assert j.device_us(hs.UPDATE) == pytest.approx(4000.0)
    assert j.device_us(("sample",)) == pytest.approx(2000.0)
    rows = hs.by_span(j)
    assert rows["update.item"]["launches"] == pytest.approx(1.0)
    assert sum(r["device_us"] for r in rows.values()) == pytest.approx(
        1e6 * (0.002 + 0.001 + 0.004 + 0.001 + 0.002 + 0.003) / 2)


def test_calls_whose_operations_the_trace_lost_are_left_out():
    """A launch at the stretch's start whose device record is missing:
    the calls pair from the end and the attribution stands."""
    calls = CALLS[:1] + [("cudaLaunchKernel", 0.003, 0.001)] + CALLS[1:]
    j = hs.join(_trace(calls=calls), _rec())
    assert j is not None and j.lost == 1
    assert j.device_us(hs.UPDATE) == pytest.approx(4000.0)
    assert j.device_us(("sample",)) == pytest.approx(2000.0)


@pytest.mark.parametrize("case", ["more_ops", "kind", "anchors", "no_step"])
def test_join_finds_nothing_where_the_records_disagree(case):
    trace, rec = _trace(), _rec()
    if case == "more_ops":
        trace = _trace(ops=OPS + [("extra_kernel", 0.115, 0.001)])
    elif case == "kind":      # the set read back as a kernel
        trace = _trace(ops=[OPS[0], ("fill_kernel", 0.022, 0.001)]
                       + OPS[2:])
    elif case == "anchors":   # a window's anchor missing from the trace
        rec = _rec(anchors=ANCHORS * 2)
    else:
        rec = _rec(span_list=SPANS[:1])
    assert hs.join(trace, rec) is None


def test_host_self_time_leaves_out_cuda_calls():
    j = hs.join(_trace(), _rec())
    # steps .038 + .040 s; five 1 ms calls inside them (the launch at
    # .045 lies between the steps)
    assert hs.host_self_us(j) == pytest.approx(1e6 * (0.078 - 0.005) / 2)


def test_idle_gaps_split_inside_and_outside_steps():
    # gaps .009-.022, .023-.026, .030-.046 (middle .038, step 0),
    # .047-.057, .059-.072 inside; .075-.110 (middle .0925) after step 1
    j = hs.join(_trace(), _rec())
    assert hs.idle_in_steps_s(j) == pytest.approx(0.055)
    rows = hs.by_span(j)
    assert sum(r["idle_us"] for r in rows.values()) == pytest.approx(
        1e6 * (0.055 + 0.035) / 2)


def test_readers_on_the_synthetic_stretch(ctx):
    def read(name):
        return spec.metric_reader(name)(ctx)

    assert read("update.device_us") == pytest.approx(4000.0)
    assert read("sample.device_us") == pytest.approx(2000.0)
    assert read("step.host_us") == pytest.approx(36500.0)
    assert read("device.idle_in_step_pct") == pytest.approx(
        100 * 0.055 / WINDOW_S)


@pytest.mark.parametrize("name", ["update.device_us", "sample.device_us",
                                  "step.host_us", "device.idle_in_step_pct"])
def test_readers_find_nothing_without_spans(name):
    """A run in which the program recorded no span leaves the metric
    out."""
    spans.clear()
    assert hs.recording() is None
    ctx = harness.MetricContext({}, {"batch_size": 2}, 2, _trace(), [],
                                torch.arange(2), 1.0)
    assert spec.metric_reader(name)(ctx) is None


def test_a_program_without_the_recorder_records_nothing(monkeypatch):
    """A program older than the recorder (no ``train/spans.py``): the
    readers find nothing, and raise nothing."""
    import repro_torch.train
    from torch.profiler import ProfilerActivity, profile

    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("step", 0):
            pass
    try:
        assert hs.recording() is not None
        monkeypatch.delattr(repro_torch.train, "spans")
        monkeypatch.setitem(sys.modules, "repro_torch.train.spans", None)
        assert hs.recording() is None
        assert hs.join(_trace()) is None
    finally:
        spans.clear()
