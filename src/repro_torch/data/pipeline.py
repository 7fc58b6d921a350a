"""Synthetic implicit-feedback CF data and synthetic LM batches (the CF half
and ``lm_batch`` of ``src/repro/data/pipeline.py``).

Every batch is a pure function of (seed, step): :func:`cf_batch_device`
draws from a ``torch.Generator`` seeded with ``fold_in(fold_in(seed, step),
BATCH_STREAM)`` (``repro_torch.core.mf.fold_in``, a SplitMix64 mix — never
CPython ``hash``, whose string hashes are salted per process).  A run
restarted at step N therefore sees exactly the batches it would have seen.
The dataset's ``train_pos`` and its items' interaction counts (the
``popularity`` sampler's weights) are uploaded once
(:func:`device_cf_dataset`), so steady-state training copies nothing from
the host per step.  :func:`cf_batch` is the same draw from the host dataset,
and :func:`procedural_cf_batch` draws batches of any table size without a
dataset.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.mf import Batch, fold_in, generator, resolve_device

#: salt separating the batch draw from the step's own draws (which use
#: ``fold_in(seed, step)`` directly).
BATCH_STREAM = 0x0BA7C4


@dataclasses.dataclass(frozen=True)
class CFDataset:
    """Dense interaction matrix view of a synthetic implicit-feedback set."""

    num_users: int
    num_items: int
    train_pos: np.ndarray       # (num_users, max_train) int32, -1 padded
    test_pos: np.ndarray        # (num_users, max_test) int32, -1 padded

    def train_mask(self) -> np.ndarray:
        """(num_users, num_items) bool: True where a user has a training
        positive."""
        return self._mask(self.train_pos)

    def test_mask(self) -> np.ndarray:
        """(num_users, num_items) bool: True where a user has a test
        positive."""
        return self._mask(self.test_pos)

    def _mask(self, pos: np.ndarray) -> np.ndarray:
        m = np.zeros((self.num_users, self.num_items), bool)
        u = np.repeat(np.arange(self.num_users), pos.shape[1])
        i = pos.reshape(-1)
        valid = i >= 0
        m[u[valid], i[valid]] = True
        return m


def synth_cf_dataset(num_users: int, num_items: int, *, seed: int = 0,
                     interactions_per_user: int = 20, num_clusters: int = 16,
                     test_frac: float = 0.2) -> CFDataset:
    """Clustered power-law interactions: user u prefers items from its
    cluster's popularity-ranked pool, so CF signal is recoverable.  The same
    numpy draws as the reference's ``synth_cf_dataset``, so both packages
    build the identical dataset from one seed."""
    rng = np.random.default_rng(seed)
    user_cluster = rng.integers(0, num_clusters, num_users)
    item_cluster = rng.integers(0, num_clusters, num_items)
    pools = [np.where(item_cluster == c)[0] for c in range(num_clusters)]
    pools = [p if len(p) else np.arange(num_items) for p in pools]

    n_test = max(int(interactions_per_user * test_frac), 1)
    n_train = interactions_per_user - n_test
    train = np.full((num_users, n_train), -1, np.int32)
    test = np.full((num_users, n_test), -1, np.int32)
    for u in range(num_users):
        pool = pools[user_cluster[u]]
        w = 1.0 / np.arange(1, len(pool) + 1)
        w /= w.sum()
        k = min(interactions_per_user, len(pool))
        items = rng.choice(pool, size=k, replace=False, p=w)
        train[u, :max(k - n_test, 0)] = items[:max(k - n_test, 0)]
        test[u, :min(n_test, k)] = items[max(k - n_test, 0):k]
    return CFDataset(num_users, num_items, train, test)


@dataclasses.dataclass(frozen=True)
class DeviceCFDataset:
    """Device-resident view of a :class:`CFDataset`: ``train_pos`` (int64)
    and ``item_weights`` ((num_items,) fp32 interaction counts, the
    ``popularity`` sampler's weights) live on the device the batches are
    drawn on."""

    num_users: int
    num_items: int
    train_pos: torch.Tensor
    item_weights: torch.Tensor


def device_cf_dataset(ds: CFDataset, device) -> DeviceCFDataset:
    """Upload ``train_pos`` and the items' training-interaction counts once,
    ahead of the epoch (the counts as the reference's ``device_cf_dataset``
    makes them).  Raises when every user is empty (every batch row would be
    fallback noise)."""
    if ds.num_users > 0 and not (ds.train_pos >= 0).any():
        raise ValueError("every user has zero train interactions — an "
                         "offline device view would sample pure fallback noise")
    counts = np.bincount(ds.train_pos[ds.train_pos >= 0].ravel(),
                         minlength=ds.num_items)
    return DeviceCFDataset(ds.num_users, ds.num_items,
                           torch.as_tensor(ds.train_pos, dtype=torch.int64,
                                           device=device),
                           torch.as_tensor(counts, dtype=torch.float32,
                                           device=device))


def cf_batch_device(ds: DeviceCFDataset, seed: int, step: int,
                    batch_size: int, history_len: int = 0) -> Batch:
    """Users uniform over the dataset and one train positive each, drawn on
    the dataset's device; pure in (seed, step).

    A drawn padding slot (-1) falls back to the user's column 0; a user with
    no positive at all falls back to a uniform item, as in the reference.
    With ``history_len > 0`` the batch also carries the user's first
    ``history_len`` train columns as history (``train_pos[users,
    :history_len]``, so at most the dataset's width), padding masked out and
    pointed at item 0, as the reference's ``_cf_batch_from``."""
    return _batch_from(ds.train_pos, ds.num_users, ds.num_items, seed, step,
                       batch_size, history_len)


def cf_batch(ds: CFDataset, step: int, batch_size: int, history_len: int = 0,
             seed: int = 0, *, device=None) -> Batch:
    """The batch of :func:`cf_batch_device` from the host dataset, bit for
    bit: ``train_pos`` is uploaded to ``device`` (the card unless the
    caller names another; see ``mf.resolve_device``) on every call, so a
    loop holds a :func:`device_cf_dataset` view instead."""
    train_pos = torch.as_tensor(ds.train_pos, dtype=torch.int64,
                                device=resolve_device(device))
    return _batch_from(train_pos, ds.num_users, ds.num_items, seed, step,
                       batch_size, history_len)


def _batch_from(train_pos: torch.Tensor, num_users: int, num_items: int,
                seed: int, step: int, batch_size: int,
                history_len: int) -> Batch:
    """The one (seed, step)-pure batch draw behind :func:`cf_batch_device`
    and :func:`cf_batch`."""
    gen = generator(fold_in(fold_in(seed, step), BATCH_STREAM),
                    train_pos.device)
    users = torch.randint(0, num_users, (batch_size,), generator=gen,
                          device=train_pos.device)
    cols = torch.randint(0, train_pos.shape[1], (batch_size,), generator=gen,
                         device=train_pos.device)
    uniform = torch.randint(0, num_items, (batch_size,), generator=gen,
                            device=train_pos.device)
    pos = train_pos[users, cols]
    pos = torch.where(pos >= 0, pos, train_pos[users, 0])
    pos = torch.where(pos >= 0, pos, uniform)
    hist_ids = hist_mask = None
    if history_len > 0:
        h = train_pos[users, :history_len]
        hist_mask = (h >= 0).to(torch.float32)
        hist_ids = torch.where(h >= 0, h, 0)
    return Batch(user_ids=users, pos_ids=pos, hist_ids=hist_ids,
                 hist_mask=hist_mask)


def procedural_cf_batch(step: int, batch_size: int, num_users: int,
                        num_items: int, num_clusters: int = 64, seed: int = 0,
                        *, device=None) -> Batch:
    """Batches at any table size without a dataset, pure in (seed, step):
    users uniform, user u in cluster ``u % num_clusters``, its positive at a
    power-law offset ``floor(block * v^3)`` (fp32, ``v`` uniform) into that
    cluster's contiguous block of ``num_items // num_clusters`` items, as
    the reference draws it.  Drawn on ``device`` (the card unless the caller
    names another)."""
    dev = resolve_device(device)
    gen = generator(fold_in(fold_in(seed, step), BATCH_STREAM), dev)
    users = torch.randint(0, num_users, (batch_size,), generator=gen,
                          device=dev)
    v = torch.rand((batch_size,), generator=gen, device=dev)
    block = max(num_items // num_clusters, 1)
    offset = torch.clamp_max((block * v ** 3).to(torch.int64), block - 1)
    pos = (users % num_clusters) * block + offset
    return Batch(user_ids=users, pos_ids=torch.clamp_max(pos, num_items - 1))


def lm_batch(step: int, batch_size: int, seq_len: int, vocab: int,
             seed: int = 0, device="cpu") -> dict:
    """Synthetic LM batch ``{"tokens": (B, S) int64}`` on ``device``, pure
    in (seed, step): uniform tokens of which half the positions (a fair coin
    each) copy their predecessor, the reference's Markov structure, so the
    loss has signal to learn.  Drawn from ``fold_in(fold_in(seed, step),
    BATCH_STREAM)`` on the device; the modality extras (audio frames, VLM
    patches) wait for their families."""
    gen = generator(fold_in(fold_in(seed, step), BATCH_STREAM), device)
    base = torch.randint(0, vocab, (batch_size, seq_len), generator=gen,
                         device=device)
    copy = torch.rand((batch_size, seq_len), generator=gen, device=device) < 0.5
    shifted = torch.cat([base[:, :1], base[:, :-1]], dim=1)
    return {"tokens": torch.where(copy, shifted, base)}
