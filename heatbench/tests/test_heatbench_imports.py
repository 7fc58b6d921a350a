"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (``repro_torch`` begins with ``repro``), and the
command refuses to run without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import ROOT

from heatbench import run

SCRIPT = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
sys.path.insert(2, {tests!r})
from conftest import tiny_cell
from heatbench import harness, run
r = harness.run_cell(tiny_cell("amazon_int8_b16384"), 5, 0.1, True,
                     device="cpu", log=lambda s: None)
print(json.dumps({{"correct": r["correct"],
                   "forbidden": run.forbidden_modules(),
                   "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_a_run_loads_no_jax_and_no_jax_package():
    code = SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT),
                         tests=str(ROOT / "heatbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["forbidden"] == []
    assert "repro_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["tops"])


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_probe", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_probe", sys)
    assert "repro" in run.forbidden_modules()


def test_no_card_means_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "heatbench" / "run.py"), "--workload",
         "amazon_int8_b16384", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        return
    assert out.returncode != 0
    assert out.stdout.strip() == ""
