"""Finding a cell and everything it names, by name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
the configurations and the metrics.  A cell's files are found by name under
this folder: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json`` (its correctness limits, set from measured readings)
and ``metrics/<metric>.py`` (one reader per per-layer metric), so a later
change adds a cell, a configuration, a mix or a metric as new files and new
entries, and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: the folder that holds the cells' files (``configs/``, ``traffic/``,
#: ``cells/``, ``metrics/``).
FILES = HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    """One cell with its files read: the ``workloads`` entry, the
    configuration, the traffic mix, the correctness limits, and the
    end-to-end and per-layer metric entries that this cell reports."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _name(kind: str, value: str) -> str:
    if not isinstance(value, str) or not NAME.match(value):
        raise ValueError(f"{kind} {value!r} is not a valid name")
    return value


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (one with no ``workloads`` key
    is reported by every cell)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell named ``workload`` of the checkout's ``BENCHMARK.json`` (or
    of ``bench``) with its files."""
    if bench is None:
        bench = _json(HERE.parent / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise ValueError(f"no workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(entries)}")
    entry = entries[workload]
    config = _json(FILES / "configs" / f"{_name('config', entry['config'])}.json")
    traffic = _json(FILES / "traffic" / f"{_name('traffic', entry['traffic'])}.json")
    limits = _json(FILES / "cells" / f"{_name('workload', workload)}.json")["limits"]
    return Cell(workload, entry, config, traffic, limits,
                [m for m in bench["end_to_end"] if reports(m, workload)],
                [m for m in bench["per_layer"] if reports(m, workload)])


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = FILES / "metrics" / f"{_name('metric', name)}.py"
    spec = importlib.util.spec_from_file_location(
        "heatbench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
