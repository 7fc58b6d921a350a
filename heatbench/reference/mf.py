"""The plain reference of a HEAT MF run's first steps.

From the seed and the benchmark's dataset alone, it works out again what the
port's training loop does in its first steps: the initial tables (fp32, or
int8 with per-row scales and an error-feedback residual), the resident tile,
the aggregator, each step's batch, negatives and CCL loss, the gradients
(by autograd over the plain formulas, not by the port's analytic backward),
the sparse row updates (int8: requantized with stochastic rounding), the
tile write-through, the aggregator's accumulator and its deferred flush
(every ``flush_every`` steps ``W -= lr * sum / count`` and a fresh
accumulator).  It keeps only the table rows the steps touch, in compact
tables indexed by sorted ids, so it fits beside a paper-scale dataset.

Computed in fp32 with TF32 off; duplicate-id sums accumulate in fp64.
``precision="tf32"`` is the control: every product that a matmul computes
(the similarity dots, the history average and the aggregator product, in the
forward and the backward) takes its operands rounded to TF32's 10 mantissa
bits, as a TF32 matmul on the card does.  Faults, each planted in the
reference put in the program's place: ``"half"`` leaves out the second half
of every batch and takes the mean over the rest; ``"pos_twice"`` counts the
positives' gradients twice in the item table's update, and nowhere else;
``"no_flush"`` leaves the aggregator's weights unchanged at its flush (the
accumulator is still emptied).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from heatbench.reference import rng

EPS = 1e-12
SCALE_FLOOR = 1e-12


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """The fields of a configuration file that the reference reads."""

    num_users: int
    num_items: int
    emb_dim: int
    num_negatives: int
    mu: float
    theta: float
    lr: float
    history_len: int
    gate: float
    flush_every: int
    tile_size: int
    refresh_interval: int
    init: str
    init_std: float
    table_format: str
    aggregation_kind: str
    similarity: str

    @classmethod
    def from_dict(cls, d: dict) -> "RefConfig":
        """The fields of ``d``, a configuration file read as a dict."""
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})

    def check(self, steps: int) -> None:
        """Raise unless the reference models this configuration over
        ``steps`` steps: cosine CCL, tile negatives, average aggregation,
        and no tile refresh inside the steps."""
        if self.similarity != "cosine" or self.tile_size <= 0:
            raise ValueError("the reference models cosine CCL with tile "
                             "negatives")
        if self.history_len > 0 and self.aggregation_kind != "avg":
            raise ValueError("the reference models the avg aggregator")
        if self.refresh_interval <= steps:
            raise ValueError(f"a tile refresh falls inside the reference's "
                             f"{steps} steps")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties to even), kept in fp32."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return r.view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` with TF32 operands in the forward and in both products of
    the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g.contiguous())
        return (torch.matmul(g, tf32_round(b).transpose(-1, -2)),
                torch.matmul(tf32_round(a).transpose(-1, -2), g))


def _matmul(precision: str):
    if precision == "fp32":
        return torch.matmul
    if precision == "tf32":
        return _TF32Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


class Rows:
    """The rows ``ids`` (sorted, distinct) of one table: fp32 ``vals``, or
    int8 ``q``/``scale``/``err``/``err_scale`` as the int8 format keeps
    them."""

    def __init__(self, ids, vals=None, q=None, scale=None):
        self.ids = ids
        self.vals = vals
        self.q, self.scale = q, scale
        if q is not None:
            self.err = torch.zeros_like(q)
            self.err_scale = torch.full_like(scale, SCALE_FLOOR)

    @property
    def int8(self) -> bool:
        return self.q is not None

    def index(self, ids: torch.Tensor) -> torch.Tensor:
        """Positions of ``ids`` (all present) in the compact rows."""
        return torch.searchsorted(self.ids, ids)

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """fp32 rows at compact positions ``idx`` (int8: ``q * scale``)."""
        if self.int8:
            return self.q[idx].to(torch.float32) * self.scale[idx]
        return self.vals[idx]

    def state(self) -> torch.Tensor:
        """fp64 values of every kept row (int8: payload plus residual)."""
        if self.int8:
            return (self.q.double() * self.scale.double()
                    + self.err.double() * self.err_scale.double())
        return self.vals.double()


def row_quantize(x: torch.Tensor):
    """Per-row absmax int8, round to nearest: ``(q, scale)``."""
    scale = (x.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(SCALE_FLOOR)
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


def init_rows(seed: int, salt: int, num_rows: int, cfg: RefConfig,
              ids: torch.Tensor) -> Rows:
    """Rows ``ids`` of the table drawn from ``fold_in(seed, salt)``: the
    whole (R, K) normal draw is made, as the program makes it, and only
    ``ids`` are kept (quantized per row for int8)."""
    dev = ids.device
    std = (cfg.init_std if cfg.init == "normal"
           else math.sqrt(2.0 / (num_rows + cfg.emb_dim)))
    full = torch.randn((num_rows, cfg.emb_dim), dtype=torch.float32,
                       device=dev,
                       generator=rng.generator(rng.fold_in(seed, salt), dev))
    vals = full[ids].mul_(std)
    del full
    if cfg.table_format == "int8":
        q, scale = row_quantize(vals)
        return Rows(ids, q=q, scale=scale)
    return Rows(ids, vals=vals)


def _sum_by(idx: torch.Tensor, grads: torch.Tensor, rows: int) -> torch.Tensor:
    """fp64 sums of ``grads`` lanes by compact row ``idx``, cast to fp32."""
    out = torch.zeros((rows, grads.shape[-1]), dtype=torch.float64,
                      device=grads.device)
    return out.index_add_(0, idx, grads.double()).to(torch.float32)


def apply_update(t: Rows, lane_ids: torch.Tensor, grads: torch.Tensor,
                 lr: float, noise_fn) -> None:
    """SGD on the rows that ``lane_ids`` touch, in place.  fp32: ``row -= lr
    * sum``.  int8: the row plus its residual minus ``lr * sum``,
    requantized with stochastic rounding ``floor(x + u)``, where the
    ``j``-th distinct id (ascending) takes row ``j`` of the ``(lanes, K)``
    noise, and the new residual quantized to nearest."""
    uids = torch.unique(lane_ids)
    idx = t.index(uids)
    g = _sum_by(torch.searchsorted(uids, lane_ids), grads, uids.shape[0])
    if not t.int8:
        t.vals[idx] = t.vals[idx] - lr * g
        return
    rows = t.q[idx].to(torch.float32) * t.scale[idx]
    resid = t.err[idx].to(torch.float32) * t.err_scale[idx]
    new = rows + resid - lr * g
    scale = (new.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(SCALE_FLOOR)
    noise = noise_fn((lane_ids.shape[0], grads.shape[-1]))[:uids.shape[0]]
    q = torch.floor(new / scale + noise).clamp(-127, 127).to(torch.int8)
    eq, escale = row_quantize(new - q.to(torch.float32) * scale)
    t.q[idx], t.scale[idx], t.err[idx], t.err_scale[idx] = q, scale, eq, escale


def ccl_loss(u, p, negs, mu: float, theta: float, mm) -> torch.Tensor:
    """Mean cosine contrastive loss: ``1 - cos(u, p) + mu / n * sum_j
    relu(cos(u, n_j) - theta)``, the dots through ``mm``."""
    uu = (u * u).sum(-1)
    pp = (p * p).sum(-1)
    nn = (negs * negs).sum(-1)
    up = mm(u[:, None, :], p[:, :, None])[:, 0, 0]
    un = mm(negs, u[:, :, None])[..., 0]
    inv_u = torch.rsqrt(uu + EPS)
    pos_sim = up * inv_u * torch.rsqrt(pp + EPS)
    neg_sim = un * inv_u[:, None] * torch.rsqrt(nn + EPS)
    rows = (1.0 - pos_sim) + (mu / negs.shape[1]) * torch.relu(
        neg_sim - theta).sum(-1)
    return rows.mean()


def touched_ids(train_pos: torch.Tensor, cfg: RefConfig, batch_size: int,
                seed: int, steps: int):
    """Sorted distinct user ids and item ids that the first ``steps`` steps
    read or write: the batches' users, positives and history, and the
    initial tile."""
    users, items = [], [rng.tile_ids(seed, cfg.num_items, cfg.tile_size,
                                     train_pos.device)]
    for s in range(steps):
        u, p, h, _ = rng.batch_draw(train_pos, cfg.num_items, seed, s,
                                    batch_size, cfg.history_len)
        users.append(u)
        items += [p] + ([] if h is None else [h.reshape(-1)])
    return torch.unique(torch.cat(users)), torch.unique(torch.cat(items))


FAULTS = (None, "half", "pos_twice", "no_flush")


def run(train_pos: torch.Tensor, cfg: RefConfig, batch_size: int, seed: int,
        steps: int, *, precision: str = "fp32",
        fault: Optional[str] = None) -> dict:
    """The first ``steps`` steps of the run.  Returns ``{"losses": [...],
    "snaps": {0: snap, 1: snap, steps: snap}, "ids": (users, items)}``
    where a snap maps ``"user"``/``"item"`` to the fp64 rows at the touched
    ids and, with an aggregator, ``"agg.w"`` to its weights and
    ``"agg.acc"`` to its gradient accumulator (fp64), after that many
    steps."""
    cfg.check(steps)
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    mm = _matmul(precision)
    dev = train_pos.device
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        user_ids, item_ids = touched_ids(train_pos, cfg, batch_size, seed,
                                         steps)
        users_t = init_rows(seed, rng.INIT_USER, cfg.num_users, cfg, user_ids)
        items_t = init_rows(seed, rng.INIT_ITEM, cfg.num_items, cfg, item_ids)
        tile = rng.tile_ids(seed, cfg.num_items, cfg.tile_size, dev)
        tile_emb = items_t.rows(items_t.index(tile))
        agg = None
        if cfg.history_len > 0:
            w = torch.randn((cfg.emb_dim, cfg.emb_dim), dtype=torch.float32,
                            device=dev, generator=rng.generator(
                                rng.fold_in(seed, rng.INIT_AGG), dev)
                            ) * (1.0 / math.sqrt(cfg.emb_dim))
            agg = Aggregator(w, torch.zeros_like(w), 0)

        def snap():
            out = {"user": users_t.state(), "item": items_t.state()}
            if agg is not None:
                out["agg.w"] = agg.w.double()
                out["agg.acc"] = agg.acc.double()
            return out

        snaps, losses = {0: snap()}, []
        for step in range(steps):
            loss, tile_emb, agg = _step(train_pos, cfg, batch_size, seed,
                                        step, users_t, items_t, tile,
                                        tile_emb, agg, mm, fault)
            losses.append(loss)
            if step + 1 in (1, steps):
                snaps[step + 1] = snap()
        return {"losses": losses, "snaps": snaps, "ids": (user_ids, item_ids)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


@dataclasses.dataclass
class Aggregator:
    """The aggregator's weights ``w``, its gradient accumulator ``acc`` and
    the steps accumulated since its last flush."""

    w: torch.Tensor
    acc: torch.Tensor
    count: int

    def add(self, grad: torch.Tensor, cfg: RefConfig,
            fault: Optional[str]) -> "Aggregator":
        """Fold one step's gradient in; flush every ``flush_every`` steps:
        ``W -= lr * acc / count`` and a fresh accumulator."""
        acc, count = self.acc + grad, self.count + 1
        if count < cfg.flush_every:
            return Aggregator(self.w, acc, count)
        w = self.w if fault == "no_flush" else self.w - cfg.lr * (
            acc / float(count))
        return Aggregator(w, torch.zeros_like(acc), 0)


def _step(train_pos, cfg: RefConfig, batch_size: int, seed: int, step: int,
          users_t: Rows, items_t: Rows, tile, tile_emb, agg, mm, fault):
    dev = train_pos.device
    users, pos, hist, mask = rng.batch_draw(train_pos, cfg.num_items, seed,
                                            step, batch_size, cfg.history_len)
    local = rng.negative_slots(seed, step, cfg.tile_size,
                               (batch_size, cfg.num_negatives), dev)
    if fault == "half":
        keep = batch_size // 2
        users, pos, local = users[:keep], pos[:keep], local[:keep]
        if hist is not None:
            hist, mask = hist[:keep], mask[:keep]
    u = users_t.rows(users_t.index(users)).requires_grad_()
    p = items_t.rows(items_t.index(pos)).requires_grad_()
    negs = tile_emb[local].requires_grad_()
    leaves = [u, p, negs]
    user_in = u
    if hist is not None:
        he = items_t.rows(items_t.index(hist)).requires_grad_()
        wl = agg.w.detach().requires_grad_()
        leaves += [he, wl]
        denom = mask.sum(-1, keepdim=True).clamp_min(1.0)
        pooled = mm(mask[:, None, :], he)[:, 0, :] / denom
        user_in = cfg.gate * u + (1.0 - cfg.gate) * mm(pooled, wl)
    loss = ccl_loss(user_in, p, negs, cfg.mu, cfg.theta, mm)
    grads = torch.autograd.grad(loss, leaves)
    g_u, g_p, g_n = grads[:3]

    lr = cfg.lr

    def noise(salt):
        return lambda shape: rng.rounding_noise(seed, step, salt, shape, dev)

    apply_update(users_t, users, g_u, lr, noise(rng.ROUND_USER_SALT))
    t = cfg.tile_size
    reduced = _sum_by(local.reshape(-1), g_n.reshape(-1, g_n.shape[-1]), t)
    lane_ids = [pos, tile]
    lane_grads = [g_p, reduced]
    if hist is not None:
        lane_ids.append(hist.reshape(-1))
        lane_grads.append(grads[3].reshape(-1, grads[3].shape[-1]))
    extra_ids, extra_grads = ([pos], [g_p]) if fault == "pos_twice" else ([], [])
    apply_update(items_t, torch.cat(lane_ids + extra_ids),
                 torch.cat(lane_grads + extra_grads), lr,
                 noise(rng.ROUND_ITEM_SALT))

    # The tile copy takes the same updates, exact: its slots' sums, then the
    # positives' and the history's lanes whose ids it holds.
    tile_emb = tile_emb - lr * reduced
    glob_ids = torch.cat([i for i in lane_ids[:1] + lane_ids[2:]])
    glob_g = torch.cat([g for g in lane_grads[:1] + lane_grads[2:]])
    slot = torch.searchsorted(tile, glob_ids).clamp_max(t - 1)
    hit = tile[slot] == glob_ids
    delta = torch.zeros((t, glob_g.shape[-1]), dtype=torch.float64, device=dev)
    delta.index_add_(0, slot[hit], (-lr * glob_g[hit]).double())
    tile_emb = tile_emb + delta.to(torch.float32)
    if agg is not None:
        agg = agg.add(grads[4], cfg, fault)
    return float(loss.detach()), tile_emb.detach(), agg
