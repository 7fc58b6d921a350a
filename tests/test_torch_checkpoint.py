"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
reference's format (``repro.train.checkpoint``).

A checkpoint written by either package restores into the other, leaf for
leaf and bit for bit, for fp32 and int8 tables with and without behavior
aggregation and the tile; the manifests the two write for one state are the
same.  The integrity contract (CRC32s, quarantine of corrupt checkpoints and
fallback to the newest valid one, strict explicit steps, retention over
valid checkpoints only) is held as the reference's own tests hold it.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import mf as jmf
from repro.train import checkpoint as jckpt
from repro_torch import convert
from repro_torch.core import mf as tmf
from repro_torch.data import pipeline
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import trainer

CONFIGS = {
    "fp32": dict(),
    "int8_history": dict(table_format="int8", history_len=3),
    "fp32_self_attn": dict(history_len=3, aggregation_kind="self_attn"),
    "int8_user_attn_no_tile": dict(table_format="int8", history_len=2,
                                   aggregation_kind="user_attn", tile_size=0),
}


def _cfg(name):
    base = dict(num_users=40, num_items=60, emb_dim=16, num_negatives=4,
                tile_size=8)
    base.update(CONFIGS[name])
    return jmf.MFConfig(**base)


def _port_cfg(cfg):
    return tmf.MFConfig(**dataclasses.asdict(cfg))


def _ref_tree(state):
    return {n: np.asarray(leaf) for n, leaf in jckpt._flatten_with_paths(state)}


def _trained_port_state(cfg, steps=5):
    """A port state a few steps into training (counters and residuals not
    at their initial values)."""
    ds = pipeline.synth_cf_dataset(cfg.num_users, cfg.num_items, seed=1)
    state, _ = trainer.train_mf(_port_cfg(cfg), ds, steps, batch_size=8,
                                device="cpu", steps_per_dispatch=2)
    return state


def _assert_trees_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_checkpoint_restores_into_port(name, tmp_path):
    cfg = _cfg(name)
    jstate = jmf.init_mf(jax.random.PRNGKey(0), cfg)
    jckpt.save(str(tmp_path), 7, jstate, extra={"note": name})
    target = tmf.init_mf(1, _port_cfg(cfg), device="cpu")
    state, step, extra = tckpt.restore(str(tmp_path), target)
    assert (step, extra) == (7, {"note": name})
    _assert_trees_equal(convert.mf_state_to_numpy(state), _ref_tree(jstate))
    for (n, a), (_, b) in zip(tckpt.named_leaves(state),
                              tckpt.named_leaves(target)):
        assert type(a) is type(b), n
        if isinstance(a, torch.Tensor):
            assert (a.dtype, a.device) == (b.dtype, b.device), n


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_checkpoint_restores_into_reference(name, tmp_path):
    cfg = _cfg(name)
    state = _trained_port_state(cfg)
    tckpt.save(str(tmp_path), state.step, state)
    target = jmf.init_mf(jax.random.PRNGKey(1), cfg)
    restored, step, _ = jckpt.restore(str(tmp_path), target)
    assert step == state.step == 5
    _assert_trees_equal(_ref_tree(restored), convert.mf_state_to_numpy(state))


@pytest.mark.parametrize("name", ["int8_history", "fp32_self_attn"])
def test_both_packages_write_the_same_manifest(name, tmp_path):
    """One state written by each package: the same leaf names, files,
    shapes, dtypes, byte sizes and CRC32s."""
    jstate = jmf.init_mf(jax.random.PRNGKey(2), _cfg(name))
    tstate = convert.mf_state_from_numpy(_ref_tree(jstate))
    jckpt.save(str(tmp_path / "ref"), 3, jstate)
    tckpt.save(str(tmp_path / "port"), 3, tstate)
    manifests = [json.loads((tmp_path / d / "step_00000003" / "manifest.json")
                            .read_text()) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    names = [leaf["name"] for leaf in manifests[1]["leaves"]]
    assert "accum/count" in names
    assert ("params/item_table/err_scale" in names) == (name == "int8_history")


def _save_steps(path, steps=(1, 2, 3)):
    state = tmf.init_mf(0, _port_cfg(_cfg("int8_history")), device="cpu")
    for s in steps:
        tckpt.save(str(path), s, state._replace(step=s), keep=10)
    return state


def _flip_byte(path, step):
    d = path / f"step_{step:08d}"
    leaf = sorted(p for p in d.iterdir() if p.suffix == ".npy")[0]
    data = bytearray(leaf.read_bytes())
    data[-1] ^= 0xFF
    leaf.write_bytes(bytes(data))


def test_corrupt_newest_is_quarantined_and_restore_falls_back(tmp_path):
    state = _save_steps(tmp_path)
    _flip_byte(tmp_path, 3)
    assert tckpt.verify_step(str(tmp_path), 3)
    assert tckpt.valid_steps(str(tmp_path)) == [1, 2]
    assert tckpt.latest_valid_step(str(tmp_path)) == 2
    restored, step, _ = tckpt.restore(str(tmp_path), state)
    assert step == 2 and restored.step == 2
    assert os.path.isdir(tmp_path / "step_00000003.corrupt")
    assert tckpt.latest_step(str(tmp_path)) == 2


def test_explicit_step_is_strict(tmp_path):
    state = _save_steps(tmp_path)
    _flip_byte(tmp_path, 2)
    with pytest.raises(tckpt.CheckpointCorruptError, match="step 2"):
        tckpt.restore(str(tmp_path), state, step=2)
    with pytest.raises(FileNotFoundError, match=r"available steps: \[1, 2, 3\]"):
        tckpt.restore(str(tmp_path), state, step=9)
    assert tckpt.restore(str(tmp_path), state, step=1)[1] == 1


def test_all_corrupt_raises_and_quarantines_every_one(tmp_path):
    state = _save_steps(tmp_path, (1, 2))
    for s in (1, 2):
        _flip_byte(tmp_path, s)
    with pytest.raises(FileNotFoundError, match="2 candidate"):
        tckpt.restore(str(tmp_path), state)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001.corrupt",
                                            "step_00000002.corrupt"]
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tckpt.restore(str(tmp_path / "empty"), state)


def test_truncated_and_missing_leaves_fail_verification(tmp_path):
    _save_steps(tmp_path, (1, 2))
    leaf = sorted((tmp_path / "step_00000001").glob("*.npy"))[0]
    leaf.write_bytes(leaf.read_bytes()[:-3])
    assert "truncated" in " ".join(tckpt.verify_step(str(tmp_path), 1))
    (tmp_path / "step_00000002" / "manifest.json").unlink()
    assert "missing" in " ".join(tckpt.verify_step(str(tmp_path), 2))


def test_retention_keeps_valid_checkpoints_and_sweeps_tmp(tmp_path):
    state = tmf.init_mf(0, _port_cfg(_cfg("fp32")), device="cpu")
    for s in (1, 2, 3):
        tckpt.save(str(tmp_path), s, state, keep=2)
    assert tckpt.valid_steps(str(tmp_path)) == [2, 3]
    _flip_byte(tmp_path, 3)
    os.makedirs(tmp_path / "step_00000009.tmp")
    tckpt.save(str(tmp_path), 4, state, keep=2)
    # step 3 is corrupt, so the two newest VALID ones are 2 and 4
    assert tckpt.valid_steps(str(tmp_path)) == [2, 4]
    assert not (tmp_path / "step_00000009.tmp").exists()
    assert tckpt.sweep_tmp(str(tmp_path)) == []


def test_extra_takes_numpy_scalars(tmp_path):
    state = tmf.init_mf(0, _port_cfg(_cfg("fp32")), device="cpu")
    tckpt.save(str(tmp_path), 1, state,
               extra={"cursor": np.int64(12), "loss": np.float32(0.5)})
    assert tckpt.restore(str(tmp_path), state)[2] == {"cursor": 12, "loss": 0.5}
    with pytest.raises(TypeError, match="not JSON-serializable"):
        tckpt.save(str(tmp_path), 2, state, extra={"bad": object()})


def test_named_leaves_skip_none_and_keep_field_order():
    state = tmf.init_mf(0, _port_cfg(_cfg("int8_history")), device="cpu")
    names = [n for n, _ in tckpt.named_leaves(state)]
    assert names == [n for n, _ in jckpt._flatten_with_paths(
        jmf.init_mf(jax.random.PRNGKey(0), _cfg("int8_history")))]
    assert "params/aggregator/attn_q" not in names
    rebuilt = tckpt.map_leaves(state, lambda n, leaf: leaf)
    assert rebuilt.params.aggregator.attn_q is None and rebuilt.step == 0
