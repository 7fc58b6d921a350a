"""The reference against the port, on the CPU at a tiny size through the
kernels' plain versions; the control (the reference with TF32 operands in
the program's place) and the training faults a cell can have (a step that
returns its state unchanged, half of the batch left out, the positives
counted twice in the item update alone, the aggregator's flush that leaves
its weights unchanged) must each come out as not correct.  The harness runs
whole, apart from its look for a chip."""
from __future__ import annotations

import pytest
import torch
from conftest import tiny_cell

from heatbench import calibrate, check, harness

CELLS = ["mf100m_b65536", "amazon_int8_b16384"]
SEED = 2**31 + 1234


def _run(cell):
    return harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                            log=lambda s: None)


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference(workload):
    result = _run(tiny_cell(workload))
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["checks"]
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], (name, c)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = tiny_cell(workload)
    r = calibrate.reference_reading(cell, SEED, torch.device("cpu"),
                                    precision="tf32")
    assert not check.verdict(r["values"], cell.limits), r["values"]


@pytest.mark.parametrize("fault", ["half", "pos_twice", "no_flush"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_planted_in_the_reference_is_not_correct(workload, fault):
    cell = tiny_cell(workload)
    if fault == "no_flush" and not cell.config["history_len"]:
        pytest.skip("no aggregator, so no flush, in this configuration")
    r = calibrate.reference_reading(cell, SEED, torch.device("cpu"),
                                    fault=fault)
    assert not check.verdict(r["values"], cell.limits), r["values"]


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    return x


def unchanged(step_fn):
    """The step on a copy of the state; the state comes back untouched."""
    def fn(state, batch, rng, cfg, **kw):
        _, loss = step_fn(_clone(state), batch, rng, cfg, **kw)
        return state._replace(step=state.step + 1), loss
    return fn


def half_batch(step_fn):
    """The step on the first half of the batch, its mean over that half."""
    def fn(state, batch, rng, cfg, **kw):
        keep = batch.user_ids.shape[0] // 2
        return step_fn(state, type(batch)(*(None if x is None else x[:keep]
                                            for x in batch)), rng, cfg, **kw)
    return fn


def positives_twice(update_many):
    """The item update with the positives' group (the first) twice."""
    def fn(table, groups, *args, **kw):
        return update_many(table, [groups[0]] + list(groups), *args, **kw)
    return fn


def weights_kept_at_flush(maybe_flush):
    """The flush empties the accumulator and leaves the weights as they
    were."""
    def fn(state, params, *args, **kw):
        return params, maybe_flush(state, params, *args, **kw)[1]
    return fn


@pytest.mark.parametrize("fault", [unchanged, half_batch])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    from repro_torch.core import mf
    monkeypatch.setattr(mf, "heat_train_step", fault(mf.heat_train_step))
    result = _run(tiny_cell(workload))
    assert result["correct"] is False
    assert max(c["value"] / c["limit"]
               for c in result["checks"].values()) > 10


@pytest.mark.parametrize("workload", CELLS)
def test_positives_counted_twice_in_the_item_update_is_not_correct(
        workload, monkeypatch):
    from repro_torch.core import engine
    from repro_torch.optim import quantization as qz
    monkeypatch.setattr(qz, "apply_updates_many",
                        positives_twice(qz.apply_updates_many))
    for name, fn in list(engine.UPDATE_MANY_IMPLS.items()):
        monkeypatch.setitem(engine.UPDATE_MANY_IMPLS, name,
                            positives_twice(fn))
    result = _run(tiny_cell(workload))
    assert result["correct"] is False


def test_a_flush_that_keeps_the_weights_is_not_correct(monkeypatch):
    from repro_torch.core import aggregation
    monkeypatch.setattr(aggregation, "maybe_flush",
                        weights_kept_at_flush(aggregation.maybe_flush))
    result = _run(tiny_cell("amazon_int8_b16384"))
    assert result["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference_on_the_card(workload, cuda_device):
    result = harness.run_cell(tiny_cell(workload), SEED, 0.2, False,
                              device="cuda", log=lambda s: None)
    assert result["correct"] is True
