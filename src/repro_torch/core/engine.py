"""The execution API of the MF training step and the LM HEAT head:
pluggable loss / row-update / negative-sampling implementations behind one
registry surface, under the same names as ``src/repro/core/engine.py``
(:func:`available_backends` equals the reference's, name for name).

A :class:`StepEngine` bundles the three decisions a training step makes:

  * **loss**: ``fused`` (the residual-reuse autograd Function of
    ``core/losses.py``), ``autodiff`` (plain autograd), ``simplex_bmm``
    (SimpleX's concat -> normalize -> bmm baseline, §3.2), ``mse_dot`` (dot
    product and MSE, the CuMF_SGD class) or ``pallas``.  The port keeps the
    registry key ``pallas`` so a config such as ``MF_100M_PALLAS`` means the
    same in both packages; here it names the hand-written CUDA kernels
    (``csrc/ccl_stats.cu`` forward, ``csrc/ccl_bwd.cu`` backward), whose
    plain versions run on CPU tensors.
  * **row update**: ``scatter_add`` (the sorted, fixed-order segment sum in
    plain PyTorch), ``pallas`` (the same update through the gather-FMA CUDA
    kernel, ``csrc/gather_fma.cu``) or ``dense`` (Table 1's baseline: a
    dense (I, K) gradient buffer and a write of the whole table).  Each has
    a ``row_update_many`` form that applies all of a step's gradient groups
    in one call (one kernel launch for ``pallas``, one full-table write for
    ``dense``).
  * **sampler**: ``uniform``, ``tile`` (the §4.2 resident tile), ``auto``
    (tile when the state carries one), ``popularity`` (proportional to
    explicit weights, else log-uniform over ids) or ``in_batch`` (the
    batch's own positives).

The item table a sampler draws from may be fp32 or int8 (gathers go
through ``optim/quantization.py``).  Unknown names raise the reference's
``ValueError``.  As in the reference, the loss contract is polymorphic over
negative layouts: every loss takes per-example ``(B, n, K)`` negatives (the
MF step) and step-shared ``(n, K)`` negatives (the LM HEAT head), plus an
optional per-row ``mask``; ``pallas`` refuses a mask on per-example
negatives, as the reference's does.  Every sampler draws from the step's
``torch.Generator`` alone, so a draw is pure in (seed, step).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, NamedTuple, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core import samplers
from repro_torch.core.losses import (
    ccl_loss_autodiff,
    ccl_loss_fused,
    ccl_loss_fused_w,
    ccl_loss_simplex_bmm,
    loss_weights,
    mse_loss_dot,
)
from repro_torch.core.tiling import concat_groups, segment_sum
from repro_torch.kernels.ops import (
    fused_rows_update,
    make_ccl_loss_kernel,
    make_ccl_loss_shared_kernel,
    sparse_row_update,
)
from repro_torch.optim import quantization as qz

LossFn = Callable[..., torch.Tensor]
UpdateFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, float], torch.Tensor]
UpdateManyFn = Callable[[torch.Tensor, list, float], torch.Tensor]

LOSS_IMPLS: dict[str, LossFn] = {}
UPDATE_IMPLS: dict[str, UpdateFn] = {}
UPDATE_MANY_IMPLS: dict[str, UpdateManyFn] = {}
SAMPLERS: dict[str, "NegativeSampler"] = {}


def register_loss(name: str):
    """Decorator: register a LossFn under ``name`` in LOSS_IMPLS."""
    def deco(fn: LossFn) -> LossFn:
        LOSS_IMPLS[name] = fn
        return fn
    return deco


def register_update(name: str):
    """Decorator: register an UpdateFn under ``name`` in UPDATE_IMPLS."""
    def deco(fn: UpdateFn) -> UpdateFn:
        UPDATE_IMPLS[name] = fn
        return fn
    return deco


def register_sampler(name: str):
    """Register a :class:`NegativeSampler` class or instance under ``name``."""
    def deco(obj):
        SAMPLERS[name] = obj() if isinstance(obj, type) else obj
        return obj
    return deco


class SampleContext(NamedTuple):
    """Everything a sampler may draw from: the live item table (fp32 or
    int8), the resident tile, the batch's positives (``in_batch``) and
    unnormalized (I,) popularity weights (``popularity``); all but the
    table may be None."""

    table: qz.Table                              # (I, K)
    tile: Optional[samplers.TileState] = None
    pos_ids: Optional[torch.Tensor] = None       # batch positives
    weights: Optional[torch.Tensor] = None       # (I,) popularity weights


class NegSample(NamedTuple):
    """One draw: global ids ``(B, n)``, their embeddings ``(B, n, K)``, the
    context (callers read their tile back from ``state.tile``), and for
    tile-sourced draws the tile-local slots that let the step slot-reduce
    the negatives' gradients."""

    ids: torch.Tensor
    embs: torch.Tensor
    state: SampleContext
    local_idx: Optional[torch.Tensor] = None


@runtime_checkable
class NegativeSampler(Protocol):
    """``sample(state, gen, shape) -> NegSample``: ``gen`` is the step's
    ``torch.Generator`` for this draw and ``shape`` is ``(B, n)`` for
    per-example negatives or ``(n,)`` for a step-shared set."""

    name: str

    def sample(self, state: SampleContext, gen: torch.Generator,
               shape: tuple[int, ...]) -> NegSample:
        ...


@register_sampler("uniform")
class UniformSampler:
    """Uniform over the whole item space, even when a tile exists."""

    name = "uniform"

    def sample(self, state, gen, shape):
        ids = samplers.sample_uniform(gen, qz.num_rows(state.table), shape)
        return NegSample(ids, qz.gather_rows(state.table, ids), state)


@register_sampler("tile")
class TileSampler:
    """HEAT §4.2 random tiling: draw from the resident tile by local slot.
    The rows come from the tile copy, or, for an id-only tile (the LM vocab
    tile), from the live table, so gradients reach it."""

    name = "tile"

    def sample(self, state, gen, shape):
        tile = state.tile
        if tile is None:
            raise ValueError(
                "sampler='tile' requires a resident tile in the sample "
                "context (cfg.tile_size > 0)")
        if tile.tile_emb is not None:
            ids, embs, local = samplers.tile_sample(tile, gen, shape)
            return NegSample(ids, embs, state, local_idx=local)
        local = torch.randint(0, tile.tile_ids.shape[0], tuple(shape),
                              generator=gen, device=gen.device)
        ids = tile.tile_ids[local]
        return NegSample(ids, qz.gather_rows(state.table, ids), state,
                         local_idx=local)


@register_sampler("auto")
class AutoSampler:
    """Tile when the context carries one, else uniform (the default)."""

    name = "auto"

    def sample(self, state, gen, shape):
        impl = SAMPLERS["tile" if state.tile is not None else "uniform"]
        return impl.sample(state, gen, shape)


def popularity_logits(weights: torch.Tensor) -> torch.Tensor:
    """Unnormalized (I,) interaction counts -> fp32 categorical log-weights,
    ``-inf`` where a weight is not positive: the reference's weight
    transform, whose zeros the ``popularity`` sampler never draws."""
    w = weights.to(torch.float32)
    return torch.where(w > 0, torch.log(torch.clamp_min(w, 1e-30)),
                       float("-inf"))


def popularity_cdf(weights: torch.Tensor) -> torch.Tensor:
    """(I,) fp64 running sums of the weights whose :func:`popularity_logits`
    are finite (the others count 0).  Interaction counts are integers, so
    below 2^53 every order of the sum gives the same bits."""
    kept = torch.isfinite(popularity_logits(weights))
    return torch.cumsum(torch.where(kept, weights.to(torch.float64), 0.0), 0)


def sample_popularity(cdf: torch.Tensor, last: torch.Tensor,
                      gen: torch.Generator, shape) -> torch.Tensor:
    """Inverse-CDF draw of int64 ids: ``x = u * total`` with fp64 ``u`` in
    [0, 1), then the first id whose running sum exceeds ``x``.  An id of
    weight 0 has an empty interval, so it is never returned (at ``u = 0``
    the first positive id is); ``last`` (the last id of positive weight)
    catches an ``x`` that rounds up to the total."""
    x = torch.rand(tuple(shape), generator=gen, dtype=torch.float64,
                   device=gen.device) * cdf[-1]
    return torch.searchsorted(cdf, x, right=True).clamp_max(last)


def log_uniform_ids(u: torch.Tensor, num: int) -> torch.Tensor:
    """The log-uniform (Zipfian) ids of fp32 uniforms ``u``:
    ``floor(exp(u * log(num + 1))) - 1`` in fp32, clipped to ``[0, num)``,
    the reference's arithmetic: ``P(k) ~ log(1 + 1/(k + 1))``."""
    log_n = torch.log(torch.tensor(float(num + 1), dtype=torch.float32,
                                   device=u.device))
    ids = torch.floor(torch.exp(u * log_n)).to(torch.int64) - 1
    return ids.clamp(0, num - 1)


@register_sampler("popularity")
class PopularitySampler:
    """Popularity-proportional negatives (Chen et al. 2017 §5).  With
    ``state.weights`` ((I,), unnormalized, zeros excluded) an id is drawn
    with probability proportional to its weight, through an fp64 CDF built
    once per weights tensor (rebuilt when the tensor is changed in place)
    and searched with ``torch.searchsorted``: O(log I) a draw and the same
    bits on the same generator.  Without weights it falls back to the
    log-uniform distribution over ids (:func:`log_uniform_ids`), which
    assumes ids sorted by falling popularity."""

    name = "popularity"

    def __init__(self):
        # (weakref to weights, its version, cdf, last); the weakref's
        # callback drops the CDF with the weights it was built from.
        self._cached = None

    def _drop(self, ref) -> None:
        if self._cached is not None and self._cached[0] is ref:
            self._cached = None

    def _cdf(self, weights: torch.Tensor):
        c = self._cached
        if c is None or c[0]() is not weights or c[1] != weights._version:
            cdf = popularity_cdf(weights)
            if not bool(cdf[-1] > 0):               # one check per weights tensor
                raise ValueError("sampler='popularity' needs at least one "
                                 "positive weight")
            last = torch.searchsorted(cdf, cdf[-1:])[0]
            c = self._cached = (weakref.ref(weights, self._drop),
                                weights._version, cdf, last)
        return c[2], c[3]

    def sample(self, state, gen, shape):
        num = qz.num_rows(state.table)
        if state.weights is not None:
            ids = sample_popularity(*self._cdf(state.weights), gen, shape)
        else:
            u = torch.rand(tuple(shape), generator=gen, device=gen.device)
            ids = log_uniform_ids(u, num)
        return NegSample(ids, qz.gather_rows(state.table, ids), state)


@register_sampler("in_batch")
class InBatchSampler:
    """Negatives drawn from the batch's own positives (Chen et al. 2017
    §4.2).  A per-example ``(B, n)`` draw excludes each row's own batch
    *slot* (an offset in ``[1, B)`` added to the row, mod B) when B > 1; a
    shared ``(n,)`` draw (or B == 1) is uniform over all B positives.  An
    item that is the positive of several rows can still be a row's
    negative, the usual in-batch trade-off."""

    name = "in_batch"

    def sample(self, state, gen, shape):
        if state.pos_ids is None:
            raise ValueError("sampler='in_batch' requires pos_ids in the "
                             "sample context")
        pos = state.pos_ids.reshape(-1)
        b = pos.shape[0]
        shape = tuple(shape)
        if len(shape) >= 2 and shape[0] == b and b > 1:
            off = torch.randint(1, b, shape, generator=gen, device=gen.device)
            rows = torch.arange(b, device=gen.device).reshape(
                (b,) + (1,) * (len(shape) - 1))
            j = (rows + off) % b
        else:
            j = torch.randint(0, b, shape, generator=gen, device=gen.device)
        ids = pos[j]
        return NegSample(ids, qz.gather_rows(state.table, ids), state)


@dataclasses.dataclass(frozen=True)
class StepEngine:
    """One execution backend for the sampled objective."""

    backend: str                 # loss implementation name
    update_impl: str             # row-update implementation name
    sampler_name: str            # negative-sampling strategy name
    loss_fn: LossFn = dataclasses.field(compare=False)
    row_update: UpdateFn = dataclasses.field(compare=False)
    row_update_many: UpdateManyFn = dataclasses.field(compare=False)
    sampler: NegativeSampler = dataclasses.field(compare=False)

    @property
    def name(self) -> str:
        return f"{self.backend}+{self.update_impl}+{self.sampler_name}"


@register_loss("fused")
def _loss_fused(user_e, pos_e, neg_e, *, mu, theta, similarity, mask=None):
    if neg_e.dim() == 3 and mask is None:
        return ccl_loss_fused(user_e, pos_e, neg_e, mu, theta, similarity)
    w = loss_weights(mask, user_e.shape[0], user_e.dtype, user_e.device)
    return ccl_loss_fused_w(user_e, pos_e, neg_e, w, mu, theta, similarity)


@register_loss("autodiff")
def _loss_autodiff(user_e, pos_e, neg_e, *, mu, theta, similarity, mask=None):
    return ccl_loss_autodiff(user_e, pos_e, neg_e, mu, theta, similarity,
                             mask=mask)


@register_loss("simplex_bmm")
def _loss_simplex_bmm(user_e, pos_e, neg_e, *, mu, theta, similarity,
                      mask=None):
    return ccl_loss_simplex_bmm(user_e, pos_e, neg_e, mu, theta, mask=mask)


@register_loss("mse_dot")
def _loss_mse_dot(user_e, pos_e, neg_e, *, mu, theta, similarity, mask=None):
    return mse_loss_dot(user_e, pos_e, mask=mask)


@register_loss("pallas")
def _loss_pallas(user_e, pos_e, neg_e, *, mu, theta, similarity, mask=None):
    if similarity != "cosine":
        raise ValueError(
            "backend='pallas' implements cosine similarity only "
            f"(got similarity={similarity!r})")
    if neg_e.dim() == 3:
        if mask is not None:
            raise ValueError(
                "backend='pallas' does not implement masked per-example "
                "negatives; use backend='fused' (the LM head's shared "
                "layout supports masks)")
        return make_ccl_loss_kernel(mu, theta)(user_e, pos_e, neg_e)
    w = loss_weights(mask, user_e.shape[0], user_e.dtype, user_e.device)
    return make_ccl_loss_shared_kernel(mu, theta)(user_e, pos_e, neg_e, w)


@register_update("scatter_add")
def _update_scatter_add(table, ids, grads, lr):
    return sparse_row_update(table, ids, grads, lr, use_kernel=False)


@register_update("pallas")
def _update_pallas(table, ids, grads, lr):
    return sparse_row_update(table, ids, grads, lr, use_kernel=True)


def _update_scatter_add_many(table, pairs, lr):
    """All of a step's gradient groups in one sorted segment-sum update."""
    ids, grads = concat_groups(pairs)
    return sparse_row_update(table, ids, grads, lr, use_kernel=False)


def _update_pallas_many(table, pairs, lr):
    """Single-launch fused path (§3.1/§4.5): one cross-group sort and one
    gather-FMA kernel launch for the whole step."""
    return fused_rows_update(table, pairs, lr, use_kernel=True)


@register_update("dense")
def _update_dense(table, ids, grads, lr):
    return _update_dense_many(table, [(ids, grads)], lr)


def _update_dense_many(table, pairs, lr):
    """Table 1's dense baseline: every gradient group accumulates into ONE
    dense (I, K) buffer (a fixed-order segment sum, so the same bits on
    every run), and the whole table is written once per step, not once per
    group, which would overstate the baseline's memory traffic."""
    ids, grads = concat_groups(pairs)
    dense = segment_sum(ids, grads.to(table.dtype), table.shape[0])
    return table.sub_(dense.mul_(lr))


UPDATE_MANY_IMPLS["scatter_add"] = _update_scatter_add_many
UPDATE_MANY_IMPLS["pallas"] = _update_pallas_many
UPDATE_MANY_IMPLS["dense"] = _update_dense_many


def available_backends() -> dict[str, tuple[str, ...]]:
    """The advertised combination matrix (for docs, tests)."""
    return {"backend": tuple(LOSS_IMPLS), "update_impl": tuple(UPDATE_IMPLS),
            "sampler": tuple(SAMPLERS)}


def resolve_engine(cfg=None, *, backend: Optional[str] = None,
                   update_impl: Optional[str] = None,
                   sampler: Optional[str] = None) -> StepEngine:
    """Single entry point: config fields -> StepEngine (kwargs override cfg)."""
    backend = backend or (getattr(cfg, "backend", None) or "fused")
    update_impl = update_impl or (getattr(cfg, "update_impl", None)
                                  or "scatter_add")
    sampler = sampler or (getattr(cfg, "sampler", None) or "auto")
    if backend not in LOSS_IMPLS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"available: {sorted(LOSS_IMPLS)}")
    if update_impl not in UPDATE_IMPLS:
        raise ValueError(f"unknown update_impl {update_impl!r}; "
                         f"available: {sorted(UPDATE_IMPLS)}")
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; "
                         f"available: {sorted(SAMPLERS)}")
    table_format = getattr(cfg, "table_format", None) or "fp32"
    if table_format not in qz.TABLE_FORMATS:
        raise ValueError(f"unknown table_format {table_format!r}; "
                         f"available: {list(qz.TABLE_FORMATS)}")
    if backend == "pallas" and getattr(cfg, "similarity", "cosine") != "cosine":
        raise ValueError(
            "backend='pallas' implements cosine similarity only "
            f"(cfg.similarity={cfg.similarity!r})")
    return StepEngine(backend=backend, update_impl=update_impl,
                      sampler_name=sampler, loss_fn=LOSS_IMPLS[backend],
                      row_update=UPDATE_IMPLS[update_impl],
                      row_update_many=UPDATE_MANY_IMPLS[update_impl],
                      sampler=SAMPLERS[sampler])
