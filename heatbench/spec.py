"""Finding a cell and everything it names, by name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
the configurations and the metrics.  A cell's files are found by name under
this folder: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json`` (its correctness limits, set from measured readings),
``metrics/<metric>.py`` (one reader per per-layer metric) and
``kinds/<kind>.py`` (what a configuration's kind runs, checks and counts:
``heatbench/kinds/__init__.py``), so a later change adds a cell, a
configuration, a mix, a metric or a kind as new files and new entries, and
edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: the folder that holds the cells' files (``configs/``, ``traffic/``,
#: ``cells/``, ``metrics/``, ``kinds/``).
FILES = HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    """One cell with its files read: the ``workloads`` entry, the
    configuration, the traffic mix, the correctness limits, the
    end-to-end and per-layer metric entries that this cell reports, and the
    configuration's kind (its ``"kind"``, ``mf`` where it names none)."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    kind: str = "mf"


def _name(what: str, value: str) -> str:
    if not isinstance(value, str) or not NAME.match(value):
        raise ValueError(f"{what} {value!r} is not a valid name")
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
                [m for m in bench["per_layer"] if reports(m, workload)],
                _name("kind", config.get("kind", "mf")))


def _module(prefix: str, name: str, path: Path):
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return _module("heatbench_metric_", name,
                   FILES / "metrics" / f"{_name('metric', name)}.py").read


def kind_module(name: str):
    """The module ``kinds/<name>.py`` (its contract:
    ``heatbench/kinds/__init__.py``)."""
    path = FILES / "kinds" / f"{_name('kind', name)}.py"
    if not path.is_file():
        found = sorted(p.stem for p in (FILES / "kinds").glob("*.py")
                       if p.stem != "__init__")
        raise ValueError(f"no kind {name!r}; {FILES / 'kinds'} has {found}")
    return _module("heatbench_kind_", name, path)
