"""The MF training loop (the MF half of ``src/repro/train/trainer.py``).

The loop runs in K-step windows: an :class:`EpochExecutor` runs K steps as a
Python loop, each drawing its batch on the device from (seed, step), and
keeps the per-step losses on the device; the loop reads them back once per
window.  Every step's draws are pure in (seed, step), so any K gives the same
trajectory, and a run restored from a checkpoint at step N replays the
uninterrupted run bit for bit.  Windows end on the checkpoint schedule and
on an armed failure injection, so both land on window edges, as in the
reference.  The mesh waits for a later slice; capturing each window as a
CUDA graph is a later optimization.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import mf
from repro_torch.core.engine import StepEngine, resolve_engine
from repro_torch.data import pipeline
from repro_torch.train import checkpoint as ckpt

#: restarts ``train_mf`` makes after injected failures before it re-raises.
MAX_RESTARTS = 2


class SimulatedFailure(RuntimeError):
    """An injected failure (``fail_at_step``): the loop restores its latest
    checkpoint and carries on, as after a real crash."""


class EpochExecutor:
    """Runs ``body(state, step) -> (state, loss)`` over K-step windows.

    ``run`` returns the window's losses as one device tensor, so a window
    costs one host sync, taken by the caller at its edge."""

    def __init__(self, body: Callable, steps_per_dispatch: int):
        self.body = body
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)

    def run(self, state, start: int, length: int):
        """Run steps ``[start, start + length)``; returns
        ``(new_state, (length,) device loss tensor)``."""
        losses = []
        for step in range(start, start + length):
            state, loss = self.body(state, step)
            losses.append(loss)
        return state, torch.stack(losses)


def _window_length(step: int, stop: int, k: int, ckpt_every: int,
                   fail_at_step: Optional[int]) -> int:
    """Next window length: at most ``k`` steps, truncated so window edges
    land exactly on the run end, the checkpoint schedule and any armed
    failure injection (the same rule as the reference)."""
    length = min(k, stop - step)
    if ckpt_every:
        length = min(length, ckpt_every - step % ckpt_every)
    if fail_at_step is not None and step < fail_at_step:
        length = min(length, fail_at_step - step)
    return length


def run_window(executor: EpochExecutor, state, step: int, stop: int,
               ckpt_every: int = 0, fail_at_step: Optional[int] = None):
    """One window, truncated at the run end, the checkpoint schedule and an
    armed failure, and its edge sync; returns ``(state, host losses,
    length)``."""
    length = _window_length(step, stop, executor.steps_per_dispatch,
                            ckpt_every, fail_at_step)
    state, window = executor.run(state, step, length)
    return state, window.cpu().tolist(), length


def train_mf(cfg: mf.MFConfig, ds: pipeline.CFDataset, steps: int, *,
             batch_size: int = 256, seed: int = 0,
             engine: Optional[StepEngine] = None,
             ckpt_dir: Optional[str] = None, ckpt_every: int = 200,
             fail_at_step: Optional[int] = None,
             steps_per_dispatch: int = 1, device=None,
             log: Callable[[str], None] = print):
    """HEAT CF training (the Fig. 3 loop) with restart on failure; returns
    ``(state, losses)``.

    Runs on the card unless ``device`` names another device (``"cpu"`` runs
    the kernels' plain versions); with no CUDA device and no ``device`` it
    raises.  ``engine`` defaults to the one ``cfg`` names.  The dataset is
    uploaded once and batches (with ``cfg.history_len`` history columns) are
    drawn on the device, ``steps_per_dispatch`` steps per window.

    With ``ckpt_dir`` the run resumes from its latest checkpoint, saves
    every ``ckpt_every`` steps, and on a :class:`SimulatedFailure` (armed by
    ``fail_at_step``, fired once) restores the latest valid checkpoint — or
    starts over when there is none — at most ``MAX_RESTARTS`` times.  The
    losses of replayed steps are logged again, as in the reference."""
    dev = mf.resolve_device(device)
    if engine is None:
        engine = resolve_engine(cfg)
    state = mf.init_mf(seed, cfg, device=dev)
    dds = pipeline.device_cf_dataset(ds, dev)

    def batch_fn(step):
        return pipeline.cf_batch_device(dds, seed, step, batch_size,
                                        cfg.history_len)

    executor = EpochExecutor(
        mf.make_scan_body(cfg, batch_fn, seed, engine=engine),
        steps_per_dispatch)
    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start, _ = ckpt.restore(ckpt_dir, state)
        log(f"[mf] resumed from step {start}")

    losses: list = []
    step, restarts = start, 0
    while step < steps:
        try:
            if fail_at_step is not None and step == fail_at_step \
                    and restarts == 0:
                raise SimulatedFailure(f"injected failure at step {step}")
            state, window, length = run_window(
                executor, state, step, steps, ckpt_every if ckpt_dir else 0,
                fail_at_step if restarts == 0 else None)
            losses.extend(window)
            step += length
            if ckpt_dir and step % ckpt_every == 0:
                ckpt.save(ckpt_dir, step, state)
        except SimulatedFailure as e:
            restarts += 1
            if restarts > MAX_RESTARTS or not ckpt_dir:
                raise
            log(f"[mf] {e} -> restoring")
            if ckpt.latest_step(ckpt_dir) is not None:
                state, step, _ = ckpt.restore(ckpt_dir, state)
            else:       # failed before the first checkpoint: start over
                state, step = mf.init_mf(seed, cfg, device=dev), 0
    return state, losses
