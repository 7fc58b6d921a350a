"""The one generator of the benchmark's implicit-feedback data.

It draws the law of the repository's own synthetic data,
``synth_cf_dataset`` in ``src/repro/data/pipeline.py`` (the reference's,
which its CLI and the port's smoke run train on), on the device and in a
few large calls instead of a per-user Python loop:

* every user and every item falls in one of ``num_clusters`` clusters,
  uniformly;
* a user's interactions are drawn from their cluster's pool (its items in
  ascending id order) with weight ``1 / rank^item_zipf_exponent``, without
  replacement (repeats are drawn again until a user's items are distinct);
* every user has ``interactions_per_user`` of them, of which
  ``max(int(interactions_per_user * test_frac), 1)`` are held out as test
  items, as ``synth_cf_dataset`` splits them; the rest fill the first
  columns of the user's train row, ``-1`` after them.

A traffic mix (``heatbench/traffic/<mix>.json``) gives those parameters,
the batch size, the window length in steps (``steps_per_dispatch``) and the
width of ``train_pos`` (``columns``).  The same seed gives the same bits on
the same device.  The batches are drawn from it by the program
(``cf_batch_device``) and, independently, by the reference.
"""
from __future__ import annotations

import torch

from heatbench.reference import rng

#: salt of the data draw: far from the program's init and step salts.
DATA_STREAM = 0xDA7A5E7
#: rounds of redrawing repeated items before a draw is given up.
MAX_ROUNDS = 64


def train_count(traffic: dict) -> int:
    """Train interactions per user: the interactions less the held-out
    test items, as ``synth_cf_dataset`` splits them."""
    per_user = int(traffic["interactions_per_user"])
    n_test = max(int(per_user * float(traffic["test_frac"])), 1)
    return per_user - n_test


def power_law_cdf(n: int, exponent: float, device) -> torch.Tensor:
    """fp64 running sums of ``r^-exponent`` for ``r = 1..n``."""
    r = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    return torch.cumsum(r.pow(-exponent), 0)


def _draw_ranks(cdf: torch.Tensor, sizes: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
    """One rank ``0..sizes[i]-1`` for each entry of ``sizes``, drawn with
    the weights whose running sums are ``cdf`` (cut to that size)."""
    u = torch.rand(sizes.shape, generator=gen, dtype=torch.float64,
                   device=cdf.device) * cdf[sizes - 1]
    return torch.minimum(torch.searchsorted(cdf, u, right=True), sizes - 1)


def _repeats(items: torch.Tensor) -> torch.Tensor:
    """True where an item repeats one earlier in its row."""
    vals, idx = torch.sort(items, dim=1, stable=True)
    later = torch.zeros_like(items, dtype=torch.bool)
    later[:, 1:] = vals[:, 1:] == vals[:, :-1]
    out = torch.zeros_like(later)
    return out.scatter_(1, idx, later)


def make_dataset(num_users: int, num_items: int, traffic: dict, seed: int,
                 device):
    """``(train_pos, item_weights)`` on ``device``: ``train_pos``
    (num_users, columns) int64, -1 padded, and the items' fp32 train
    interaction counts (num_items,)."""
    cols, clusters = int(traffic["columns"]), int(traffic["num_clusters"])
    n_train = train_count(traffic)
    if not 1 <= n_train <= cols:
        raise ValueError(f"{n_train} train items a user do not fit "
                         f"{cols} columns")
    gen = rng.generator(rng.fold_in(seed, DATA_STREAM), device)
    user_cluster = torch.randint(0, clusters, (num_users,), generator=gen,
                                 device=device)
    item_cluster = torch.randint(0, clusters, (num_items,), generator=gen,
                                 device=device)
    pool = torch.sort(item_cluster, stable=True).indices
    sizes = torch.bincount(item_cluster, minlength=clusters)
    if int(sizes.min()) < n_train:
        raise ValueError("a cluster holds fewer items than a user draws")
    starts = torch.cumsum(sizes, 0) - sizes
    cdf = power_law_cdf(int(sizes.max()), float(traffic["item_zipf_exponent"]),
                        device)
    row_sizes = sizes[user_cluster][:, None].expand(num_users, n_train)
    row_starts = starts[user_cluster][:, None].expand(num_users, n_train)
    items = pool[row_starts + _draw_ranks(cdf, row_sizes, gen)]
    for _ in range(MAX_ROUNDS):
        again = _repeats(items)
        if not bool(again.any()):
            break
        items[again] = pool[row_starts[again]
                            + _draw_ranks(cdf, row_sizes[again], gen)]
    else:
        raise RuntimeError("repeated items remain after redrawing")
    train_pos = torch.full((num_users, cols), -1, dtype=torch.int64,
                           device=device)
    train_pos[:, :n_train] = items
    return train_pos, torch.bincount(items.reshape(-1),
                                     minlength=num_items).float()
