"""Checkpoints with atomic commits and integrity checks, in the on-disk
format of ``src/repro/train/checkpoint.py``, so either package restores the
other's checkpoints.

Layout::

    <dir>/step_<N:08d>/
        manifest.json     {step, leaves: [{name, file, shape, dtype, bytes,
                           crc32}], extra}
        <leaf>.npy        one file per leaf, named by its path
                          (``params/user_table/q`` -> ``params__user_table__q.npy``)

- **Leaf names** are the reference's: the NamedTuple field, dataclass
  field and dict key path joined by ``/``, with ``None`` fields absent
  (:func:`named_leaves`, which ``convert.py`` uses too).  A dataclass (the
  streaming ring, ``data/pipeline.py::DeviceCFDataset``) is walked like the
  reference's registered pytree: its tensor fields are leaves
  (``data/train_pos``), its int fields metadata that is not written.  int64 tensors (ids) are written as int32 and
  host-int counters as 0-d int32, as the reference keeps them.
- **Atomic**: written to ``step_<N>.tmp`` and renamed; ``save`` first sweeps
  ``.tmp`` directories orphaned by a crashed writer.
- **Verified**: every leaf's byte size and CRC32 are in the manifest.
  ``restore(step=None)`` walks newest-first, moves a corrupt checkpoint
  aside as ``step_<N>.corrupt`` and falls back to the newest valid one; an
  explicit ``step`` is strict.
- **Retention**: keep the last ``keep`` *valid* checkpoints, so a run whose
  newest saves are corrupt never loses its last good state.
- **Sharded runs** (``plan=``, a ``core/mf_distributed.py::MFShardingPlan``):
  a save gathers the whole state and rank 0 alone writes it, in the layout
  above, while the others wait; a restore reads the whole files and keeps
  this rank's part.  The files do not depend on the world size, so a
  checkpoint saved by 2 ranks restores on 1 and the other way round, and
  either package reads it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """An explicitly requested checkpoint failed integrity verification."""


def _is_struct(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def map_leaves(tree: Any, fn: Callable[[str, Any], Any], prefix: str = ""):
    """Rebuild ``tree`` (nested NamedTuples, dataclasses and dicts) with
    each non-None leaf replaced by ``fn(name, leaf)``, ``name`` its field
    path (dict keys taken in sorted order, as ``jax.tree`` flattens them)
    joined by ``/``.  A dataclass's int, float, str and bool fields are
    metadata: kept as they are and never passed to ``fn``."""
    if tree is None:
        return None
    if _is_struct(tree):
        return type(tree)(*(map_leaves(getattr(tree, f), fn,
                                       f"{prefix}/{f}" if prefix else f)
                            for f in tree._fields))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(getattr(tree, f.name), fn,
                               f"{prefix}/{f.name}" if prefix else f.name)
            for f in dataclasses.fields(tree)
            if not isinstance(getattr(tree, f.name), (int, float, str, bool))})
    if isinstance(tree, dict):
        return {k: map_leaves(tree[k], fn, f"{prefix}/{k}" if prefix else k)
                for k in sorted(tree)}
    return fn(prefix or "root", tree)


def named_leaves(tree: Any) -> list[tuple[str, Any]]:
    """``[(name, leaf), ...]`` in field order — the checkpoint's leaf names,
    the same as the reference's ``_flatten_with_paths``."""
    out: list[tuple[str, Any]] = []
    map_leaves(tree, lambda name, leaf: out.append((name, leaf)))
    return out


def leaf_to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array the checkpoint stores: tensors copied to
    the host, int64 ids as int32, host ints as 0-d int32."""
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
        return arr.astype(np.int32) if arr.dtype == np.int64 else arr
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def leaf_from_numpy(arr: np.ndarray, like):
    """``arr`` as a leaf like ``like``: a tensor on ``like``'s device with
    its dtype, or a host int."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(arr)).to(device=like.device,
                                                   dtype=like.dtype)
    if isinstance(like, (int, np.integer)):
        return int(arr)
    return arr


def _json_default(obj):
    """Manifest ``extra`` entries may be numpy scalars: store their Python
    values."""
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray) and obj.ndim == 0:
        return obj.item()
    raise TypeError(f"checkpoint extra is not JSON-serializable: "
                    f"{type(obj).__name__}")


def _crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while block := f.read(chunk):
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def sweep_tmp(ckpt_dir: str) -> list[str]:
    """Remove ``step_*.tmp`` directories left by a crashed writer (never
    committed, so nothing of value); returns the removed names."""
    if not os.path.isdir(ckpt_dir):
        return []
    removed = []
    for d in sorted(os.listdir(ckpt_dir)):
        if re.fullmatch(r"step_\d+\.tmp", d):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
            removed.append(d)
    return removed


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3, *, plan=None) -> str:
    """Write a checkpoint of ``tree`` atomically; returns the committed
    path.  With ``plan``, ``tree`` is this rank's part of a sharded state:
    every rank must call, the whole state is gathered, rank 0 writes it and
    the others wait for the commit."""
    if plan is not None:
        whole = plan.gather_state(tree)
        if plan.mesh.rank == 0:
            save(ckpt_dir, step, whole, extra, keep)
        plan.mesh.barrier()
        return _step_dir(ckpt_dir, step)
    sweep_tmp(ckpt_dir)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, leaf in named_leaves(tree):
        arr = leaf_to_numpy(leaf)
        fname = name.replace("/", "__") + ".npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape),
             "dtype": str(arr.dtype), "bytes": os.path.getsize(fpath),
             "crc32": _crc32_file(fpath)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, default=_json_default)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    _gc(ckpt_dir, keep)
    return final


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Highest step with a checkpoint directory, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def verify(path: str) -> list[str]:
    """Integrity problems of one committed checkpoint directory (empty =
    valid): the manifest reads, and every leaf file exists with the
    recorded byte size and CRC32."""
    mpath = os.path.join(path, "manifest.json")
    if not os.path.isdir(path):
        return [f"{path}: not a directory"]
    if not os.path.exists(mpath):
        return [f"{path}: manifest.json is missing"]
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        return [f"{path}: manifest.json unreadable: {e}"]
    problems = []
    for leaf in manifest.get("leaves", []):
        fpath = os.path.join(path, leaf["file"])
        if not os.path.exists(fpath):
            problems.append(f"{path}: leaf file {leaf['file']!r} is missing")
            continue
        if "bytes" in leaf and os.path.getsize(fpath) != leaf["bytes"]:
            problems.append(
                f"{path}: leaf {leaf['file']!r} is {os.path.getsize(fpath)} "
                f"bytes, manifest says {leaf['bytes']} (truncated?)")
            continue
        if "crc32" in leaf and _crc32_file(fpath) != leaf["crc32"]:
            problems.append(f"{path}: leaf {leaf['file']!r} fails its CRC32 "
                            "(bit rot / torn write)")
    return problems


def verify_step(ckpt_dir: str, step: int) -> list[str]:
    """:func:`verify` of one step's checkpoint."""
    return verify(_step_dir(ckpt_dir, step))


def valid_steps(ckpt_dir: str) -> list[int]:
    """Ascending steps whose checkpoints pass :func:`verify`."""
    return [s for s in _steps(ckpt_dir) if not verify_step(ckpt_dir, s)]


def latest_valid_step(ckpt_dir: str) -> Optional[int]:
    """Highest step whose checkpoint passes verification, or None."""
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def quarantine(ckpt_dir: str, step: int) -> str:
    """Move a corrupt ``step_N`` aside as ``step_N.corrupt[.K]``, so the
    newest-first scan never reconsiders it; returns the new path."""
    src = _step_dir(ckpt_dir, step)
    dst = src + ".corrupt"
    k = 0
    while os.path.exists(dst):
        k += 1
        dst = f"{src}.corrupt.{k}"
    os.rename(src, dst)
    return dst


def _choose_step(ckpt_dir: str, step: Optional[int]) -> int:
    """The step :func:`restore` loads: the newest valid one (quarantining
    corrupt ones on the way) or the requested one, verified."""
    if step is None:
        candidates = _steps(ckpt_dir)
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        for s in reversed(candidates):
            if verify_step(ckpt_dir, s):
                quarantine(ckpt_dir, s)
                continue
            return s
        raise FileNotFoundError(
            f"no valid checkpoint under {ckpt_dir}: all "
            f"{len(candidates)} candidate(s) failed verification and "
            "were quarantined as step_*.corrupt")
    path = _step_dir(ckpt_dir, step)
    if not os.path.isdir(path):
        avail = _steps(ckpt_dir)
        raise FileNotFoundError(
            f"checkpoint step {step} not found under {ckpt_dir} "
            f"(available steps: {avail if avail else 'none'})")
    problems = verify(path)
    if problems:
        raise CheckpointCorruptError(
            f"checkpoint step {step} failed verification: "
            + "; ".join(problems))
    return step


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None, *,
            plan=None):
    """Restore a checkpoint into the structure of ``target``; returns
    ``(tree, step, extra)``.  Each leaf is a new tensor on the target leaf's
    device with its dtype (or a host int where the target has one).

    ``step=None`` takes the newest valid checkpoint, quarantining corrupt
    ones on the way; ``FileNotFoundError`` when none is left.  An explicit
    ``step`` raises ``FileNotFoundError`` (naming the steps there are) when
    it is missing and :class:`CheckpointCorruptError` when it is corrupt.

    With ``plan`` (the counterpart of the reference's ``shardings``),
    ``target`` is this rank's part of a sharded state: every rank must
    call; rank 0 chooses and verifies the step, every rank reads the whole
    files and keeps its own part (``plan.place_state``), whatever world
    size wrote them."""
    if plan is None:
        step = _choose_step(ckpt_dir, step)
    else:
        chosen = None
        if plan.mesh.rank == 0:
            try:
                chosen = _choose_step(ckpt_dir, step)
            except (FileNotFoundError, CheckpointCorruptError) as e:
                chosen = e             # raised on every rank below
        chosen = plan.mesh.broadcast(chosen)
        if isinstance(chosen, BaseException):
            raise chosen
        step = chosen
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}

    def load(name, like):
        arr = np.load(os.path.join(path, by_name[name]["file"]))
        if plan is not None and isinstance(like, torch.Tensor):
            return torch.as_tensor(arr).to(dtype=like.dtype)   # host, whole
        return leaf_from_numpy(arr, like)

    tree = map_leaves(target, load)
    if plan is not None:
        tree = plan.place_state(tree, device=target.params.user_table.device)
    return tree, step, manifest["extra"]


def _gc(ckpt_dir: str, keep: int):
    """Delete steps older than the ``keep``-th newest valid checkpoint;
    with fewer valid checkpoints than ``keep``, delete nothing."""
    if keep <= 0:
        return
    valid = valid_steps(ckpt_dir)
    if len(valid) < keep:
        return
    cutoff = valid[-keep]
    for s in _steps(ckpt_dir):
        if s < cutoff:
            shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
