"""``BENCHMARK.json``'s schema (names, units, keys, files), and a
configuration, a traffic mix and a per-layer metric added as new files plus
new entries, with no edit to a file that is there."""
from __future__ import annotations

import copy
import json
import re
import shutil

import pytest
from conftest import ROOT, TINY

from heatbench import check, harness, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "heatbench/run.py"]
    assert BENCH["paths"] == ["heatbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert LINE.match(text), text


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("heatbench/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "setup_s", "train_samples_per_s"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] == "train_samples_per_s"
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = spec.load_cell(workload)
    assert "loss_gap" in cell.limits and set(cell.limits) <= set(check.NAMES)
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "train_samples_per_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    for key in cell.config["reduced"]:
        assert not key.endswith(("_dim", "_rank"))


def test_new_config_traffic_and_metric_are_new_files_only(tmp_path,
                                                          monkeypatch):
    files = tmp_path / "heatbench"
    shutil.copytree(ROOT / "heatbench", files,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in files.rglob("*") if p.is_file()}
    config = json.loads((files / "configs" / "mf100m_fp32.json").read_text())
    config.update(TINY, emb_dim=128, num_negatives=32)
    (files / "configs" / "new_config.json").write_text(json.dumps(config))
    (files / "traffic" / "new_mix.json").write_text(json.dumps({
        "batch_size": 48, "steps_per_dispatch": 8, "columns": 12,
        "interactions_per_user": 10, "test_frac": 0.2, "num_clusters": 8,
        "item_zipf_exponent": 0.8}))
    (files / "metrics" / "extra.steps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    (files / "cells" / "new_cell.json").write_text(json.dumps({
        "limits": {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-5}}))
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "new_cell", "config": "new_config",
                               "traffic": "new_mix", "chips": 1,
                               "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "extra.steps_traced", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "train_samples_per_s",
                               "workloads": ["new_cell"]})
    assert all(p.read_bytes() == b for p, b in before.items())
    monkeypatch.setattr(spec, "FILES", files)
    cell = spec.load_cell("new_cell", bench=bench)
    result = harness.run_cell(cell, 99, 0.1, True, device="cpu",
                              log=lambda s: None)
    assert result["correct"] is True
    assert result["metrics"] == {"extra.steps_traced": {
        "value": 4.0 * 8, "unit": "steps"}}
