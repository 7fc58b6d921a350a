"""Shared pieces of the benchmark's CPU tests: tiny copies of the cells
(the published widths K = 128 and n = 64, few rows) that the harness runs
on the CPU through the kernels' plain versions."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from heatbench import spec  # noqa: E402

TINY = {"num_users": 500, "num_items": 2000, "tile_size": 128}


def tiny_cell(workload: str) -> spec.Cell:
    """``workload`` with its tables cut to a few thousand rows, a batch of
    64 and (with history) 8 history columns."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = spec.load_cell(workload, bench=bench)
    cell.config.update(TINY)
    cell.traffic.update(batch_size=64)
    if cell.config["history_len"]:
        cell.config["history_len"] = 8
        cell.traffic["columns"] = 8
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run
    time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
