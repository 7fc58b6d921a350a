"""Keys and draws of a HEAT MF run, written down independently of the port.

A run's randomness is a set of ``torch.Generator`` streams, each seeded with
a 64-bit key derived from ``(seed, step)`` by a stated SplitMix64 mix.  The
reference and the benchmark's data generator derive the same keys and make
the same ``torch`` random calls in the same order on the same device, so
both sides of the comparison train on the same ids and the same rounding
noise.  The constants are the program's stated salts.
"""
from __future__ import annotations

import torch

M64 = (1 << 64) - 1

#: salt of the batch draw (a step's batch comes from
#: ``fold_in(fold_in(seed, step), BATCH_STREAM)``).
BATCH_STREAM = 0x0BA7C4
#: salts of the step key: negatives, tile refresh, int8 rounding of the user
#: update, int8 rounding of the item update.
NEG_SALT, TILE_SALT, ROUND_USER_SALT, ROUND_ITEM_SALT = 0, 1, 2, 3
#: salts of the init key: user table, item table, tile, aggregator.
INIT_USER, INIT_ITEM, INIT_TILE, INIT_AGG = 0, 1, 2, 3


def splitmix64(x: int) -> int:
    """One SplitMix64 output for the 64-bit input ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """``splitmix64(key ^ splitmix64(data))`` over 64-bit integers."""
    return splitmix64((key & M64) ^ splitmix64(data & M64))


def generator(key: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with the 64-bit ``key``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key & M64)
    return gen


def batch_draw(train_pos: torch.Tensor, num_items: int, seed: int, step: int,
               batch_size: int, history_len: int):
    """Step ``step``'s batch: users uniform over the rows of ``train_pos``,
    one train column each (a padding slot falls back to column 0, a user
    with no positive to a uniform item), and with ``history_len`` the first
    columns as history, padding masked out and pointed at item 0.  Returns
    ``(users, pos, hist or None, mask or None)``."""
    dev = train_pos.device
    gen = generator(fold_in(fold_in(seed, step), BATCH_STREAM), dev)
    users = torch.randint(0, train_pos.shape[0], (batch_size,), generator=gen,
                          device=dev)
    cols = torch.randint(0, train_pos.shape[1], (batch_size,), generator=gen,
                         device=dev)
    uniform = torch.randint(0, num_items, (batch_size,), generator=gen,
                            device=dev)
    pos = train_pos[users, cols]
    pos = torch.where(pos >= 0, pos, train_pos[users, 0])
    pos = torch.where(pos >= 0, pos, uniform)
    if history_len <= 0:
        return users, pos, None, None
    h = train_pos[users, :history_len]
    return users, pos, torch.where(h >= 0, h, 0), (h >= 0).to(torch.float32)


def tile_ids(seed: int, num_items: int, tile_size: int, device) -> torch.Tensor:
    """The initial resident tile: ``tile_size`` distinct item ids, sorted (a
    prefix of a random permutation)."""
    gen = generator(fold_in(seed, INIT_TILE), device)
    perm = torch.randperm(num_items, generator=gen, device=device)
    return torch.sort(perm[:tile_size]).values


def negative_slots(seed: int, step: int, tile_size: int, shape,
                   device) -> torch.Tensor:
    """The tile slots of step ``step``'s negatives, ``shape`` (B, n)."""
    gen = generator(fold_in(fold_in(seed, step), NEG_SALT), device)
    return torch.randint(0, tile_size, tuple(shape), generator=gen,
                         device=device)


def rounding_noise(seed: int, step: int, salt: int, shape,
                   device) -> torch.Tensor:
    """U[0, 1) fp32 noise of an int8 update (``salt``: user or item)."""
    gen = generator(fold_in(fold_in(seed, step), salt), device)
    return torch.rand(tuple(shape), generator=gen, device=device,
                      dtype=torch.float32)
