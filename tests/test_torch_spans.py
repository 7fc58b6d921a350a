"""The in-program span recorder (``repro_torch/train/spans.py``): nothing is
recorded outside a profiler session; under one, the MF step's phases form
the documented tree, with refreshes and flushes on their scheduled steps;
the buffer is bounded; a recorded step reads nothing back; a streaming
round records its phases and reports its stats from them.  The ``cuda``
test joins the spans of a traced stretch with its device trace on the card.

This file imports no JAX, so the ``cuda`` test runs on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_spans.py``."""
from __future__ import annotations

import collections
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis.sanitize import sanitize
from repro_torch.core import mf
from repro_torch.data import pipeline
from repro_torch.stream.service import StreamingConfig, StreamingTrainer
from repro_torch.stream.sources import SyntheticStream
from repro_torch.train import spans, trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

USERS, ITEMS, BATCH, K = 64, 256, 16, 4
PHASES = {"batch", "gather", "sample", "loss", "update.user", "update.item",
          "tile.write", "tile.refresh", "agg.accumulate", "agg.flush"}


@pytest.fixture(autouse=True)
def _empty_recorder():
    spans.clear()
    yield
    spans.clear()


def _executor(cfg, device="cpu", batch=BATCH, k=K):
    ds = pipeline.device_cf_dataset(pipeline.synth_cf_dataset(
        cfg.num_users, cfg.num_items, interactions_per_user=8), device)
    body = mf.make_scan_body(cfg, lambda s: pipeline.cf_batch_device(
        ds, 0, s, batch, cfg.history_len), 0)
    return trainer.EpochExecutor(body, k), mf.init_mf(0, cfg, device=device)


FP32_TILE = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=16,
                        num_negatives=4, tile_size=32, refresh_interval=3)
INT8_HIST = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=16,
                        num_negatives=4, tile_size=32, refresh_interval=3,
                        history_len=4, flush_every=2, table_format="int8")


def test_nothing_is_recorded_outside_a_profiler_session():
    ex, state = _executor(INT8_HIST)
    state, _ = ex.run(state, 0, K)
    assert spans.span("step", 0) is spans.span("loss")
    rec = spans.read()
    assert rec.spans == () and rec.anchors == () and rec.dropped == 0


@pytest.mark.parametrize("cfg", [FP32_TILE, INT8_HIST], ids=["fp32_tile",
                                                             "int8_hist4"])
def test_mf_step_records_the_phase_tree(cfg):
    """Two windows of four steps under a CPU profiler: windows hold steps,
    steps hold the phases; every phase carries its step; the tile redraws
    on steps 2 and 5 (every 3 from the fresh tile) and the aggregator
    flushes on steps 1, 3, 5, 7 (every 2)."""
    ex, state = _executor(cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        for w in range(2):
            state, _ = ex.run(state, w * K, K)
    rec = spans.read()
    assert rec.dropped == 0 and rec.anchors == ()   # no CUDA: no anchor
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns
               for s in rec.spans)
    windows = [i for i, s in enumerate(rec.spans) if s.name == "window"]
    steps = [i for i, s in enumerate(rec.spans) if s.name == "step"]
    assert len(windows) == 2
    assert all(rec.spans[i].parent == -1 and rec.spans[i].step is None
               for i in windows)
    assert [rec.spans[i].step for i in steps] == list(range(2 * K))
    assert [rec.spans[i].parent for i in steps] == [windows[0]] * K + [
        windows[1]] * K
    by_step = collections.defaultdict(list)
    for s in rec.spans:
        if s.name in PHASES:
            assert rec.spans[s.parent].name == "step"
            assert rec.spans[s.parent].step == s.step
            parent = rec.spans[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            by_step[s.step].append(s.name)
        else:
            assert s.name in ("window", "step")
    history = cfg.history_len > 0
    for step in range(2 * K):
        names = collections.Counter(by_step[step])
        want = {"batch": 1, "gather": 3 if history else 2, "sample": 1,
                "loss": 1, "update.user": 1, "update.item": 1,
                "tile.write": 1}
        if step % 3 == 2:
            want["tile.refresh"] = 1
        if history:
            want["agg.accumulate"] = 1
            if step % 2 == 1:
                want["agg.flush"] = 1
        assert names == want, (step, names)
        assert by_step[step][0] == "batch"


def test_the_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(spans.RECORDER, "capacity", 5)
    ex, state = _executor(FP32_TILE)
    with profile(activities=[ProfilerActivity.CPU]):
        state, _ = ex.run(state, 0, 2)
    rec = spans.read()
    # window, step 0, batch, gather, gather kept; the rest of step 0's
    # phases (sample, loss, two updates, tile write) and all nine of step
    # 1's (step, batch, two gathers, sample, loss, two updates, tile write)
    # dropped
    assert [s.name for s in rec.spans] == ["window", "step", "batch",
                                           "gather", "gather"]
    assert rec.dropped == 5 + 9
    assert rec.spans[0].end_ns is not None and rec.spans[1].end_ns is not None
    spans.clear()
    assert spans.read() == spans.Recording((), (), 0)


def test_a_recorded_step_reads_nothing_back():
    """The spans' schedule decisions (refresh, flush) are host ints: a
    recorded window adds no readback."""
    ex, state = _executor(INT8_HIST)
    state, _ = ex.run(state, 0, K)
    with profile(activities=[ProfilerActivity.CPU]):
        with sanitize(rank_promotion=None) as s:
            for w in range(1, 3):
                state, losses = ex.run(state, w * K, K)
            with s.edge():
                total = float(losses.sum())
    assert np.isfinite(total)
    assert sum(sp.name == "step" for sp in spans.read().spans) == 2 * K


def test_streaming_round_records_its_phases_and_reports_from_them():
    cfg = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=16,
                      num_negatives=4, lr=0.4, backend="fused",
                      sampler="popularity")
    stream = SyntheticStream(USERS, ITEMS, seed=0, total=256)
    t = StreamingTrainer(cfg, stream, StreamingConfig(
        capacity=8, micro_batch=32, steps_per_round=4, batch_size=16,
        seed=0, ckpt_every=0), device="cpu", log=lambda *_: None)
    assert t.run_round()
    assert spans.read().spans == ()
    assert set(t.last_round_stats) == {"round", "events", "ingest_s",
                                       "train_s", "refresh_s", "loss"}
    with profile(activities=[ProfilerActivity.CPU]):
        assert t.run_round()
    rec = spans.read()
    top = [s for s in rec.spans if s.parent == -1]
    assert [s.name for s in top] == ["round"]
    kids = [s for s in rec.spans if s.parent == 0]
    assert [s.name for s in kids] == ["ingest", "train", "guard", "refresh"]
    stats = t.last_round_stats
    assert stats["round"] == 2
    assert stats["ingest_s"] == pytest.approx(
        (kids[0].end_ns - kids[0].start_ns) * 1e-9)
    assert stats["train_s"] == pytest.approx(
        (kids[2].end_ns - kids[1].start_ns) * 1e-9)
    assert stats["refresh_s"] == pytest.approx(
        (kids[3].end_ns - kids[3].start_ns) * 1e-9)
    train = rec.spans.index(kids[1])
    windows = [s for s in rec.spans if s.name == "window"]
    assert len(windows) == 1 and windows[0].parent == train
    assert sum(s.name == "step" for s in rec.spans) == 4


@pytest.mark.cuda
def test_spans_join_the_device_trace_on_the_card():
    """Four small MF windows under a CUDA-only profiler: spans are
    recorded; the four anchors give clock offsets within 5 us of each
    other; the enqueue calls inside the windows equal the device operations
    the join puts down to spans; every other device operation is a window's
    loss readback.  The tracer may drop the device records of its first
    launches, so the session warms up on launches of its own first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from heatbench import profiling
    from heatbench import spans as hs

    ex, state = _executor(INT8_HIST, device="cuda", batch=256, k=8)
    for w in range(2):
        state, _ = ex.run(state, w * 8, 8)
    warm = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch._C._autograd._profiler_enabled()
        for _ in range(256):
            warm.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for w in range(2, 6):
            state, losses = ex.run(state, w * 8, 8)
            losses.cpu()
        torch.cuda.synchronize()
    rec = spans.read()
    assert sum(s.name == "window" for s in rec.spans) == 4
    assert sum(s.name == "step" for s in rec.spans) == 32
    assert len(rec.anchors) == 4 and rec.dropped == 0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        trace = profiling.read_chrome_trace(path, 1.0)
    joined = hs.join(trace, (rec, spans.ANCHOR_CALL))
    assert joined is not None
    assert max(joined.offsets) - min(joined.offsets) < 5e-6, joined.offsets
    windows = [(s, e) for name, s, e, _, _ in joined.spans if name == "window"]
    inside = [c for c in hs.enqueue_calls(trace.calls)
              if any(a <= c[1] + c[2] / 2 <= b for a, b in windows)]
    owned = [k for k, i in enumerate(joined.owner) if i >= 0]
    assert len(inside) == len(owned) > 32 * 10
    outside = [(joined.ops[k][0], joined.ops[k][1])
               for k, i in enumerate(joined.owner) if i < 0]
    readbacks = [name for name, start in outside if start > windows[0][0]]
    assert len(readbacks) == 4, outside
    assert all(name.startswith("Memcpy DtoH") for name in readbacks), outside
