"""HEAT-CCL output head for language models — the port of
``src/repro/core/heat_head.py``, a thin adapter over the engine
(``core/engine.py``).

An LM's output table is an item table: this head replaces the full-vocab
softmax with SimpleX/HEAT training of the output embeddings —

    positive  = output embedding of the target token (``out_table[targets]``),
    negatives = n rows drawn by the engine's sampler (by default from the
                id-only §4.2 vocab tile), shared across the step's tokens,
    loss      = the engine's loss on the shared (n, K) layout (CCL over
                cosine similarities, Eq. 3).

Every gather goes through the live table (``tiling.gather_rows``, whose
backward sums duplicates in a fixed order), so gradients reach it.  Under a
mesh whose model axis splits the vocab rows the table is a
``sharding.ShardedRows``: the positive and negative gathers are
owner-masked lookups over the model group, the draws range over the whole
vocabulary (its ``shape``), so every rank draws the negatives and the tile
of the unsharded run, and ``in_batch`` draws from the whole batch's
targets, gathered over the data group.  With
``backend="pallas"`` the loss runs the shared-layout CUDA kernels
(``kernels/ops.py::make_ccl_loss_shared_kernel``).

Randomness: ``rng`` is the step's integer key; the negatives draw from
``generator(fold_in(rng, NEG_SALT))`` and the tile refresh from
``generator(fold_in(rng, TILE_SALT))``, the port's counterpart of the
reference's ``jax.random.split(rng)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import samplers
from repro_torch.core.engine import SampleContext, StepEngine, resolve_engine
from repro_torch.core.mf import NEG_SALT, TILE_SALT, fold_in, generator
from repro_torch.distributed import sharding
from repro_torch.optim import quantization as qz


class HeatHeadConfig(NamedTuple):
    """CCL head knobs for the LM vocab head (negatives, margins, tile)."""

    num_negatives: int = 64
    mu: float = 1.0
    theta: float = 0.0
    similarity: str = "cosine"
    tile_size: int = 0          # 0 = no vocab tile (uniform over the vocab)
    refresh_interval: int = 1024
    backend: str = "fused"      # loss implementation (engine.LOSS_IMPLS)
    sampler: str = "auto"       # negative strategy (engine.SAMPLERS)


def sampled_ccl_loss(hidden, targets, out_table, rng: int, cfg: HeatHeadConfig,
                     tile: Optional[samplers.TileState] = None, mask=None, *,
                     engine: Optional[StepEngine] = None):
    """hidden (B, S, D), targets (B, S) int64, out_table (V, D) (or a
    ``sharding.ShardedRows``) -> ``(loss, new_tile)``.

    The loss and the negative draw go through the engine registries
    (``cfg.backend``/``cfg.sampler``; ``engine`` overrides); the sampler
    sees the targets as the batch's positives (``in_batch``).  The negatives
    come in the step-shared (n, D) layout; after the draw the tile takes its
    scheduled refresh, as in the reference."""
    if engine is None:
        engine = resolve_engine(backend=cfg.backend, sampler=cfg.sampler)
    b, s, d = hidden.shape
    h = hidden.reshape(b * s, d)
    tgt = targets.reshape(b * s)
    pos_e = qz.gather_rows(out_table, tgt)                       # (T, D)
    dev = hidden.device
    pos_ids = tgt
    mesh = sharding.active_mesh()
    if engine.sampler_name == "in_batch" and mesh is not None:
        pos_ids = sharding.all_gather_rows(
            tgt, mesh.group(sharding.DATA_AXES))
    drawn = engine.sampler.sample(
        SampleContext(table=out_table, tile=tile, pos_ids=pos_ids),
        generator(fold_in(rng, NEG_SALT), dev), (cfg.num_negatives,))
    m = mask.reshape(b * s) if mask is not None else None
    loss = engine.loss_fn(h, pos_e, drawn.embs, mu=cfg.mu, theta=cfg.theta,
                          similarity=cfg.similarity, mask=m)
    new_tile = drawn.state.tile
    if new_tile is not None:
        new_tile = samplers.tile_refresh(
            new_tile, generator(fold_in(rng, TILE_SALT), dev), out_table,
            cfg.refresh_interval)
    return loss, new_tile


def full_softmax_loss(hidden, targets, out_table, mask=None):
    """Baseline head: full-vocab cross entropy (masked mean with ``mask``)."""
    logits = torch.einsum("bsd,vd->bsv", hidden, out_table)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
    nll = logz - tgt
    if mask is not None:
        m = mask.to(nll.dtype)
        return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.mean(nll)
