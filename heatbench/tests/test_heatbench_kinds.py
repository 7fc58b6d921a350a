"""Configuration kinds: a configuration with no ``kind`` is ``mf``; the MF
cells run through ``kinds/mf.py`` and report today's keys; a toy kind,
written as new files into a copy of the benchmark's folder, trains a
reduced LM of the port through ``trainer.lm_window_body`` under
``EpochExecutor`` with a check of its own, end to end through
``harness.run_cell``; unknown kinds, bad names, limits outside a kind's
numbers and faults a kind does not list are refused."""
from __future__ import annotations

import copy
import json
import shutil
import textwrap

import pytest
from conftest import ROOT, tiny_cell

from heatbench import calibrate, check, harness, peaks, profiling, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MF_CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {"setup_s", "train_samples_per_s"}
#: readers whose names the fake trace's operations match
MF_TRACED = {"step.launches", "update.sort_us", "kernel.ccl_roofline",
             "kernel.rows_roofline", "device.idle_pct", "train.mfu_pct"}
OPS = [("ccl_stats_kernel", 0.10, 0.01), ("ccl_bwd_kernel", 0.20, 0.02),
       ("radixSortKVInPlace", 0.30, 0.05), ("gather_fma_kernel", 0.40, 0.04),
       ("gather_dequant_kernel", 0.50, 0.04)]

TOY_KIND = textwrap.dedent('''
    """A reduced LM of the port, trained by SGD with the softmax head through
    ``trainer.lm_window_body`` under ``trainer.EpochExecutor``; its check:
    the first step's loss against the cross-entropy of an untrained head,
    ln(vocab)."""
    import math

    from heatbench import peaks

    NAMES = ("first_loss_gap",)
    FAULTS = ("no_step",)
    CONTROL = {"precision": "bf16"}


    def _program(config):
        from repro_torch.configs import get_config
        from repro_torch.models import lm
        from repro_torch.optim.optimizers import get_optimizer
        from repro_torch.train import trainer
        return (get_config(config["arch"]).reduced(),
                lm.TrainOptions(loss="softmax", remat="none"),
                get_optimizer("sgd"), trainer)


    class Run:
        def __init__(self, cell, seed, dev, clock):
            c, t = cell.config, cell.traffic
            self.arch, opts, opt, trainer = clock.part(
                "import", lambda: _program(c))
            tcfg = trainer.TrainerConfig(lr=c["lr"], batch_size=t["batch_size"],
                                         seq_len=t["seq_len"], seed=seed,
                                         optimizer="sgd")
            self.state = clock.part("init", lambda: trainer.init_lm_state(
                seed, self.arch, opts, opt, device=dev))
            self.executor = trainer.EpochExecutor(trainer.lm_window_body(
                self.arch, opts, tcfg, opt, device=dev), t["steps_per_dispatch"])
            self.k, self.rows, self.step = t["steps_per_dispatch"], t["batch_size"], 0
            self.first = clock.part("first_steps", self.window)

        def window(self):
            self.state, w = self.executor.run(self.state, self.step, self.k)
            self.step += self.k
            return w.cpu().tolist()

        def sync(self):
            pass

        def metric_inputs(self, start):
            return {"extra": {"traced_steps": self.step - start}}

        def free_program(self):
            del self.state, self.executor

        def readings(self):
            ln_v = math.log(self.arch.vocab)
            return ({"first_loss_gap": abs(self.first[0] - ln_v) / ln_v},
                    {"first_loss": self.first[0], "ln_vocab": ln_v})


    def build(cell, seed, dev, clock):
        return Run(cell, seed, dev, clock)


    def reference_reading(cell, seed, dev, **kw):
        return {"values": {"first_loss_gap": 1.0 if kw else 0.0}, "detail": kw}


    def model_flops(config, traffic):
        arch = _program(config)[0]
        per_token = 6 * (12 * arch.n_layers * arch.d_model ** 2
                         + arch.d_model * arch.vocab)
        return per_token * traffic["seq_len"], peaks.FP32_FLOP_PER_S
''')


def fake_profile(run, device_type):
    """Runs the traced stretch and returns a fixed trace, as the card's
    would come, so that the readers have operations to read on the CPU."""
    run()
    return profiling.Trace(1.0, list(OPS), [])


def _run(cell, traced, seed=2**31 + 77):
    return harness.run_cell(cell, seed, 0.1, traced, device="cpu",
                            log=lambda s: None)


def test_a_configuration_without_kind_is_mf():
    for name in MF_CELLS:
        cell = spec.load_cell(name)
        assert "kind" not in cell.config and cell.kind == "mf"
    assert spec.kind_module("mf").NAMES == check.NAMES


@pytest.mark.parametrize("workload", ["amazon_int8_b16384", "mf100m_b65536"])
def test_mf_cells_run_through_their_kind_with_todays_keys(workload,
                                                         monkeypatch):
    cell = tiny_cell(workload)
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in BENCH["per_layer"]}
    result = _run(cell, False)
    assert result["correct"] is True
    assert set(result["metrics"]) == E2E
    assert set(result["checks"]) == set(cell.limits)
    assert list(result)[-1] == "checks"
    monkeypatch.setattr(profiling, "profile", fake_profile)
    traced = _run(cell, True)
    assert traced["correct"] is True
    assert set(traced["metrics"]) == MF_TRACED
    assert all(m["value"] > 0 for m in traced["metrics"].values())


def _toy_folder(tmp_path):
    files = tmp_path / "heatbench"
    shutil.copytree(ROOT / "heatbench", files,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in files.rglob("*") if p.is_file()}
    (files / "kinds" / "toy_lm.py").write_text(TOY_KIND)
    (files / "configs" / "toy_lm.json").write_text(json.dumps(
        {"kind": "toy_lm", "arch": "smollm-360m", "lr": 0.1}))
    (files / "traffic" / "toy_seq.json").write_text(json.dumps(
        {"batch_size": 4, "seq_len": 32, "steps_per_dispatch": 2}))
    (files / "cells" / "toy_cell.json").write_text(json.dumps(
        {"limits": {"first_loss_gap": 0.01}}))
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "toy_lm", "source": "a test",
                             "file": "heatbench/configs/toy_lm.json",
                             "reduced": [], "why": "a toy kind"})
    bench["workloads"].append({"name": "toy_cell", "config": "toy_lm",
                               "traffic": "toy_seq", "chips": 1,
                               "why": "a toy kind"})
    assert all(p.read_bytes() == b for p, b in before.items())
    return files, bench


def test_a_new_kind_is_new_files_only(tmp_path, monkeypatch):
    files, bench = _toy_folder(tmp_path)
    monkeypatch.setattr(spec, "FILES", files)
    cell = spec.load_cell("toy_cell", bench=bench)
    assert cell.kind == "toy_lm"
    asked = {m["name"] for m in cell.per_layer}
    assert {"step.launches", "train.mfu_pct"} <= asked
    assert not asked & {"update.sort_us", "update.device_us",
                        "sample.device_us", "kernel.ccl_roofline",
                        "kernel.rows_roofline"}
    monkeypatch.setattr(profiling, "profile", fake_profile)
    seen = []

    class Seen(harness.MetricContext):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen.append(self)

    monkeypatch.setattr(harness, "MetricContext", Seen)
    result = _run(cell, True)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"first_loss_gap"}
    assert result["checks"]["first_loss_gap"]["value"] < 0.01
    assert result["attempted"] > 0 and result["failed"] == 0
    metrics = result["metrics"]
    assert set(metrics) == {"step.launches", "device.idle_pct",
                            "train.mfu_pct"}
    # 4 traced windows of 2 steps, 5 operations
    assert metrics["step.launches"]["value"] == pytest.approx(5 / 8)
    ctx, = seen
    assert ctx.kind.NAMES == ("first_loss_gap",)
    assert ctx.extra == {"traced_steps": 8} and ctx.steps == 8
    assert ctx.batches == [] and ctx.tile_ids is None
    flops, peak = ctx.kind.model_flops(cell.config, cell.traffic)
    assert peak == peaks.FP32_FLOP_PER_S
    assert metrics["train.mfu_pct"]["value"] == pytest.approx(
        100.0 * flops * ctx.samples_per_s / peak)
    assert ctx.samples_per_s > 0
    assert set(_run(cell, False)["metrics"]) == E2E


def test_a_toy_kind_that_fails_its_check_is_not_correct(tmp_path,
                                                        monkeypatch):
    files, bench = _toy_folder(tmp_path)
    (files / "cells" / "toy_cell.json").write_text(json.dumps(
        {"limits": {"first_loss_gap": 1e-9}}))
    monkeypatch.setattr(spec, "FILES", files)
    assert _run(spec.load_cell("toy_cell", bench=bench), False)[
        "correct"] is False


def test_an_unknown_kind_raises_and_names_the_kinds_found(tmp_path,
                                                          monkeypatch):
    files, bench = _toy_folder(tmp_path)
    monkeypatch.setattr(spec, "FILES", files)
    with pytest.raises(ValueError, match=r"no kind 'lm'.*\['mf', 'toy_lm'\]"):
        spec.kind_module("lm")
    (files / "configs" / "toy_lm.json").write_text(json.dumps(
        {"kind": "lm", "arch": "smollm-360m", "lr": 0.1}))
    cell = spec.load_cell("toy_cell", bench=bench)
    with pytest.raises(ValueError, match="no kind 'lm'"):
        _run(cell, False)


@pytest.mark.parametrize("bad", ["../mf", "a b", "", 7])
def test_a_bad_kind_name_raises(bad, tmp_path, monkeypatch):
    files, bench = _toy_folder(tmp_path)
    (files / "configs" / "toy_lm.json").write_text(json.dumps(
        {"kind": bad, "arch": "smollm-360m", "lr": 0.1}))
    monkeypatch.setattr(spec, "FILES", files)
    with pytest.raises(ValueError, match="not a valid name"):
        spec.load_cell("toy_cell", bench=bench)
    with pytest.raises(ValueError, match="not a valid name"):
        spec.kind_module(bad)


def test_limits_outside_the_kinds_numbers_are_refused(tmp_path, monkeypatch):
    cell = tiny_cell("mf100m_b65536")
    cell.limits = dict(cell.limits, first_loss_gap=0.01)
    with pytest.raises(ValueError, match="first_loss_gap"):
        _run(cell, False)
    files, bench = _toy_folder(tmp_path)
    (files / "cells" / "toy_cell.json").write_text(json.dumps(
        {"limits": {"first_loss_gap": 0.01, "loss_gap": 1e-5}}))
    monkeypatch.setattr(spec, "FILES", files)
    with pytest.raises(ValueError, match="loss_gap"):
        _run(spec.load_cell("toy_cell", bench=bench), False)


def test_calibrate_takes_faults_and_control_from_the_kind(tmp_path,
                                                          monkeypatch):
    cell = tiny_cell("amazon_int8_b16384")
    assert calibrate.jobs(cell, "1,2", "3", ["half:4", "no_flush:5"]) == [
        ("program", 1, {}), ("program", 2, {}),
        ("control", 3, {"precision": "tf32"}),
        ("half", 4, {"fault": "half"}), ("no_flush", 5, {"fault": "no_flush"})]
    with pytest.raises(ValueError, match="no fault 'no_step'"):
        calibrate.jobs(cell, "", "", ["no_step:1"])
    files, bench = _toy_folder(tmp_path)
    monkeypatch.setattr(spec, "FILES", files)
    toy = spec.load_cell("toy_cell", bench=bench)
    assert calibrate.jobs(toy, "", "1", ["no_step:2"]) == [
        ("control", 1, {"precision": "bf16"}),
        ("no_step", 2, {"fault": "no_step"})]
    with pytest.raises(ValueError, match="no fault 'half'"):
        calibrate.jobs(toy, "", "", ["half:1"])
    assert calibrate.reference_reading(toy, 1, "cpu", fault="no_step")[
        "values"] == {"first_loss_gap": 1.0}
