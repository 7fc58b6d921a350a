"""The MF training loop (the MF half of ``src/repro/train/trainer.py``).

The loop runs in K-step windows: an :class:`EpochExecutor` runs K steps as a
Python loop, each drawing its batch on the device from (seed, step), and
keeps the per-step losses on the device; the loop reads them back once per
window.  Every step's draws are pure in (seed, step), so any K gives the same
trajectory.  Checkpoints, failure injection and the mesh wait for later
slices; ``train_mf`` does not take those parameters.  Capturing each window
as a CUDA graph is a later optimization.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import mf
from repro_torch.core.engine import StepEngine, resolve_engine
from repro_torch.data import pipeline


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


def run_window(executor: EpochExecutor, state, step: int, stop: int):
    """One window and its edge sync; returns ``(state, host losses,
    length)``."""
    length = _window_length(step, stop, executor.steps_per_dispatch, 0, None)
    state, window = executor.run(state, step, length)
    return state, window.cpu().tolist(), length


def train_mf(cfg: mf.MFConfig, ds: pipeline.CFDataset, steps: int, *,
             batch_size: int = 256, seed: int = 0,
             engine: Optional[StepEngine] = None,
             steps_per_dispatch: int = 1, device=None):
    """HEAT CF training (the Fig. 3 loop); returns ``(state, losses)``.

    Runs on the card unless ``device`` names another device (``"cpu"`` runs
    the kernels' plain versions); with no CUDA device and no ``device`` it
    raises.  ``engine`` defaults to the one ``cfg`` names.  The dataset is
    uploaded once and batches are drawn on the device, ``steps_per_dispatch``
    steps per window."""
    dev = mf.resolve_device(device)
    if engine is None:
        engine = resolve_engine(cfg)
    state = mf.init_mf(seed, cfg, device=dev)
    dds = pipeline.device_cf_dataset(ds, dev)

    def batch_fn(step):
        return pipeline.cf_batch_device(dds, seed, step, batch_size)

    executor = EpochExecutor(
        mf.make_scan_body(cfg, batch_fn, seed, engine=engine),
        steps_per_dispatch)
    losses: list = []
    step = 0
    while step < steps:
        state, window, length = run_window(executor, state, step, steps)
        losses.extend(window)
        step += length
    return state, losses
