"""The port's training loop, data pipeline, CLI and package boundary.

Runs on the CPU (``device="cpu"``), where the kernels' plain versions run:
the loop gives the same losses at any window length, repeats bit for bit,
truncates windows as the reference does, resumes after an injected failure
bit for bit (int8 tables with behavior aggregation included, as the
reference's ``tests/test_quantization.py`` holds its own trainer), and
refuses to fall back to the CPU on its own.  A subprocess shows that the port and ``chip_smoke.py``
load neither JAX nor the JAX package.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.train import trainer as jtrainer
from repro_torch.core import mf
from repro_torch.core.losses import ccl_loss_fused
from repro_torch.data import pipeline
from repro_torch.kernels import ccl_similarity, embedding_update
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
CFG = mf.MFConfig(num_users=64, num_items=256, emb_dim=16, num_negatives=4,
                  tile_size=16, refresh_interval=5, backend="pallas",
                  update_impl="pallas")
INT8 = dataclasses.replace(CFG, table_format="int8", history_len=3)


@pytest.fixture(scope="module")
def ds():
    return pipeline.synth_cf_dataset(64, 256)


def _run(ds, **kw):
    return trainer.train_mf(CFG, ds, 12, batch_size=8, device="cpu", **kw)


def test_same_losses_at_any_window_length(ds):
    _, l1 = _run(ds, steps_per_dispatch=1)
    _, l4 = _run(ds, steps_per_dispatch=4)
    _, l5 = _run(ds, steps_per_dispatch=5)          # truncated last window
    assert len(l1) == 12 and all(np.isfinite(l1))
    assert l1 == l4 == l5


def test_two_runs_bit_identical(ds):
    s0, l0 = _run(ds, steps_per_dispatch=4)
    s1, l1 = _run(ds, steps_per_dispatch=4)
    assert l0 == l1
    assert torch.equal(s0.params.user_table, s1.params.user_table)
    assert torch.equal(s0.params.item_table, s1.params.item_table)
    assert torch.equal(s0.tile.tile_ids, s1.tile.tile_ids)
    assert torch.equal(s0.tile.tile_emb, s1.tile.tile_emb)
    assert (s0.step, s0.tile.step) == (12, 12 % CFG.refresh_interval)
    _, other = _run(ds, steps_per_dispatch=4, seed=1)
    assert other != l0


def test_main_path_dispatches_once_per_step(ds):
    """One stats and one backward dispatch per step; one gather-FMA dispatch
    per table per step (the user update and the item groups' fused one)."""
    counters = (ccl_similarity.STATS_LAUNCHES, ccl_similarity.BWD_LAUNCHES,
                embedding_update.GATHER_FMA_LAUNCHES)
    for c in counters:
        c.reset()
    _run(ds, steps_per_dispatch=4)
    assert [c.count("cpu") for c in counters] == [12, 12, 24]
    assert [c.count() for c in counters] == [0, 0, 0]      # no kernel on CPU


def test_int8_main_path_dispatches(ds):
    """The int8 path with history on the `pallas` backend: three
    gather-dequant dispatches per step (user, positive, history), one stats
    and one backward; the requantizing update replaces the gather-FMA."""
    counters = (embedding_update.GATHER_DEQUANT_LAUNCHES,
                ccl_similarity.STATS_LAUNCHES, ccl_similarity.BWD_LAUNCHES,
                embedding_update.GATHER_FMA_LAUNCHES)
    for c in counters:
        c.reset()
    state, losses = trainer.train_mf(INT8, ds, 6, batch_size=8, device="cpu",
                                     steps_per_dispatch=3)
    assert [c.count("cpu") for c in counters] == [18, 6, 6, 0]
    assert all(np.isfinite(losses))
    assert state.params.item_table.q.dtype == torch.int8
    assert state.accum.count == 6 and state.params.aggregator.w.shape == (16, 16)


def _leaves(state):
    return ckpt.named_leaves(state)


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        assert same, name


@pytest.mark.parametrize("cfg", [INT8, dataclasses.replace(INT8, flush_every=5),
                                 CFG], ids=["int8_history", "int8_flush5", "fp32"])
def test_restart_after_failure_is_bit_identical(ds, cfg, tmp_path):
    """Crash at step 13, mid-window; train_mf restores the step-8
    checkpoint and replays 8..24 with the same (seed, step) draws: every
    leaf — int8 payloads, scales, residuals, aggregator, accumulator, tile —
    lands on the uninterrupted run's bits."""
    s1, l1 = trainer.train_mf(cfg, ds, 24, batch_size=16, seed=3,
                              device="cpu", steps_per_dispatch=4)
    logs = []
    s2, l2 = trainer.train_mf(cfg, ds, 24, batch_size=16, seed=3,
                              device="cpu", steps_per_dispatch=4,
                              ckpt_dir=str(tmp_path), ckpt_every=8,
                              fail_at_step=13, log=logs.append)
    _assert_states_equal(s1, s2)
    assert logs == ["[mf] injected failure at step 13 -> restoring"]
    assert l2[:13] == l1[:13] and l2[-16:] == l1[-8 - 8:]
    assert ckpt.valid_steps(str(tmp_path)) == [8, 16, 24]


def test_failure_before_the_first_checkpoint_starts_over(ds, tmp_path):
    s1, _ = trainer.train_mf(INT8, ds, 10, batch_size=8, device="cpu",
                             steps_per_dispatch=4)
    s2, _ = trainer.train_mf(INT8, ds, 10, batch_size=8, device="cpu",
                             steps_per_dispatch=4, ckpt_dir=str(tmp_path),
                             ckpt_every=8, fail_at_step=3, log=lambda m: None)
    _assert_states_equal(s1, s2)


def test_resumes_from_the_latest_checkpoint(ds, tmp_path):
    """A second run over the same directory resumes where the first
    stopped and ends on the bits of one uninterrupted run."""
    whole, _ = trainer.train_mf(INT8, ds, 12, batch_size=8, device="cpu",
                                steps_per_dispatch=4)
    trainer.train_mf(INT8, ds, 8, batch_size=8, device="cpu",
                     steps_per_dispatch=4, ckpt_dir=str(tmp_path), ckpt_every=4)
    logs = []
    resumed, losses = trainer.train_mf(INT8, ds, 12, batch_size=8, device="cpu",
                                       steps_per_dispatch=4,
                                       ckpt_dir=str(tmp_path), ckpt_every=4,
                                       log=logs.append)
    assert logs == ["[mf] resumed from step 8"] and len(losses) == 4
    _assert_states_equal(whole, resumed)


def test_failure_without_a_checkpoint_dir_raises(ds):
    with pytest.raises(trainer.SimulatedFailure, match="step 2"):
        trainer.train_mf(CFG, ds, 6, batch_size=8, device="cpu",
                         steps_per_dispatch=4, fail_at_step=2)


def test_history_batches_follow_the_reference(ds):
    """The history is the user's first ``history_len`` train columns,
    padding masked and pointed at item 0; a history longer than the
    dataset's 16 columns stops at its width, in both packages."""
    dds = pipeline.device_cf_dataset(ds, "cpu")
    b = pipeline.cf_batch_device(dds, 0, 3, 32, history_len=100)
    want = jpipeline.cf_batch(jpipeline.synth_cf_dataset(64, 256), 3, 32, 100)
    assert b.hist_ids.shape == b.hist_mask.shape == want.hist_ids.shape == (32, 16)
    rows = torch.as_tensor(ds.train_pos)[b.user_ids]
    assert torch.equal(b.hist_mask, (rows >= 0).float())
    assert torch.equal(b.hist_ids, torch.where(rows >= 0, rows, 0))
    b3 = pipeline.cf_batch_device(dds, 0, 3, 32, history_len=3)
    assert torch.equal(b3.user_ids, b.user_ids) and torch.equal(b3.pos_ids, b.pos_ids)
    assert torch.equal(b3.hist_ids, b.hist_ids[:, :3])
    assert pipeline.cf_batch_device(dds, 0, 3, 32).hist_ids is None


def test_training_lowers_loss_on_a_fixed_set(ds):
    """The check chip_smoke.py makes on the card, at a small size: the CCL
    loss of fixed (user, positive, negatives) triples falls after training."""
    dds = pipeline.device_cf_dataset(ds, "cpu")

    def eval_loss(state):
        b = pipeline.cf_batch_device(dds, 1000, 0, 64)
        neg = torch.randint(0, CFG.num_items, (64, CFG.num_negatives),
                            generator=mf.generator(1000, "cpu"))
        t = state.params
        return ccl_loss_fused(t.user_table[b.user_ids], t.item_table[b.pos_ids],
                              t.item_table[neg]).item()

    cfg = dataclasses.replace(CFG, lr=0.5)
    before = eval_loss(mf.init_mf(0, cfg, device="cpu"))
    state, _ = trainer.train_mf(cfg, ds, 30, batch_size=16, device="cpu",
                                steps_per_dispatch=10)
    assert eval_loss(state) < before


@pytest.mark.parametrize("step,stop,k,ckpt,fail", [
    (0, 10, 4, 0, None), (8, 10, 4, 0, None), (0, 100, 16, 10, None),
    (5, 100, 16, 10, None), (0, 100, 16, 0, 7), (7, 100, 16, 0, 7),
    (9, 100, 16, 0, 7), (3, 50, 1, 20, 30), (18, 50, 8, 20, 19),
    (0, 3, 16, 50, None)])
def test_window_length_matches_reference(step, stop, k, ckpt, fail):
    assert (trainer._window_length(step, stop, k, ckpt, fail)
            == jtrainer._window_length(step, stop, k, ckpt, fail))


def test_entry_points_refuse_to_fall_back_to_cpu(ds):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train_mf(CFG, ds, 2, batch_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mf.init_mf(0, CFG)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--mf", "--reduced", "--steps", "2"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120,
                       env=_env())
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "done:" not in r.stdout


def test_synth_dataset_matches_reference():
    ours = pipeline.synth_cf_dataset(50, 300, seed=3)
    theirs = jpipeline.synth_cf_dataset(50, 300, seed=3)
    np.testing.assert_array_equal(ours.train_pos, theirs.train_pos)
    np.testing.assert_array_equal(ours.test_pos, theirs.test_pos)


def test_batches_pure_in_seed_and_step(ds):
    dds = pipeline.device_cf_dataset(ds, "cpu")
    a = pipeline.cf_batch_device(dds, 0, 5, 32)
    b = pipeline.cf_batch_device(dds, 0, 5, 32)
    c = pipeline.cf_batch_device(dds, 0, 6, 32)
    assert torch.equal(a.user_ids, b.user_ids) and torch.equal(a.pos_ids, b.pos_ids)
    assert not torch.equal(a.user_ids, c.user_ids)
    for u, p in zip(a.user_ids.tolist(), a.pos_ids.tolist()):
        assert p in ds.train_pos[u]


def test_device_dataset_refuses_all_empty_users():
    empty = pipeline.CFDataset(3, 5, np.full((3, 2), -1, np.int32),
                               np.full((3, 1), -1, np.int32))
    with pytest.raises(ValueError, match="zero train interactions"):
        pipeline.device_cf_dataset(empty, "cpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_cli_trains_on_cpu():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--mf", "--reduced", "--steps", "6", "--device", "cpu",
                        "--steps-per-dispatch", "4", "--backend", "pallas",
                        "--update-impl", "pallas"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120,
                       env=_env())
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("[launch] MF engine: pallas+pallas+auto")
    assert lines[-1].startswith("done: 6 steps, final loss ")


def test_cli_int8_crash_and_resume_on_cpu(tmp_path):
    """``--table-format int8 --ckpt-dir --fail-at-step``: the injected
    failure is healed from the checkpoint and the run ends on the loss of an
    uninterrupted one."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--mf",
            "--reduced", "--steps", "12", "--device", "cpu",
            "--steps-per-dispatch", "4", "--table-format", "int8"]
    runs = [subprocess.run(base + extra, capture_output=True, text=True,
                           cwd=ROOT, timeout=300, env=_env())
            for extra in ([], ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
                               "--fail-at-step", "6"])]
    for r in runs:
        assert r.returncode == 0, r.stderr
    assert "[mf] injected failure at step 6 -> restoring" in runs[1].stdout
    clean, healed = (r.stdout.splitlines()[-1] for r in runs)
    assert clean.startswith("done: 12 steps") and healed.startswith("done: 14 steps")
    assert clean.split("final loss")[1] == healed.split("final loss")[1]
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000008",
                                            "step_00000012"]


def test_no_jax_or_reference_module_is_loaded():
    """Import every module of the port and chip_smoke.py (whose main does
    not run on import) in a fresh interpreter: neither jax nor any
    ``repro`` module may be loaded."""
    mods = sorted("repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
                  for p in PKG.rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import ast, importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120, env=_env())
    assert r.returncode == 0, r.stdout + r.stderr
    assert "repro_torch.kernels.ops" in mods and "repro_torch.core.mf" in mods


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_ast_scan_imports_no_jax_or_reference():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{f}: {name}"


def test_chip_smoke_refuses_without_the_card(tmp_path):
    """No CUDA device: non-zero exit and no result line; alone in a
    directory (no repo around it): the same."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], capture_output=True,
                           text=True, cwd=script.parent, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

