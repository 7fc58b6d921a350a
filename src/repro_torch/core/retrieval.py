"""Tile-pruned batched top-k retrieval, the port of
``src/repro/core/retrieval.py``: HEAT's cache tiling (§4.2) used as a coarse
quantizer on the serving path.

Items are partitioned into fixed-size tiles; one centroid per tile is scored
first, and exact scoring runs only on the members of the best
``expand_tiles`` tiles: ``T * R`` rows a request instead of all ``I``.  The
choices are the reference's:

  * **fixed-size candidate layout.**  Every tile holds exactly ``tile_rows``
    member slots (the last is padded with -1), so a request's candidate
    block is always ``(B, expand_tiles * tile_rows)``;
  * **refresh without rebuild.**  The member partition comes from a
    balanced spherical k-means (:func:`build_retrieval_index`); centroids
    are a function of (partition, live table) through :func:`refresh_index`,
    so a server re-centers the index on an updated table without
    re-clustering.

The k-means runs with torch on the table's device, in item chunks, so the
(I, tiles) score matrix never exists whole; its initial centroids are the
reference's numpy draw, and its sums are fixed-order segment sums, so a
build gives the same index on every run.  Both top-k stages rank ties as
``lax.top_k`` does (``metrics.stable_topk``: lowest index first).

Parity: with ``expand_tiles >= num_tiles`` the candidate set is the whole
catalog and :func:`topk_pruned` returns ``mf.topk_all_items``'s top-k set.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import mf
from repro_torch.core.metrics import stable_topk
from repro_torch.core.tiling import segment_sum
from repro_torch.optim import quantization as qz

#: elements of one chunk's (items, tiles) score block in the k-means.
KMEANS_CHUNK_ELEMS = 1 << 26


class RetrievalIndex(NamedTuple):
    """Coarse quantizer over the catalog: ``member_ids`` (num_tiles,
    tile_rows) int64, a partition of the item ids with -1 in the padding
    slots (only the last tile has any), and ``centroids`` (num_tiles, K),
    each tile's mean member row (of the L2-normalized rows, renormalized,
    under cosine; the raw mean under dot)."""

    member_ids: torch.Tensor
    centroids: torch.Tensor

    @property
    def num_tiles(self) -> int:
        """Number of tiles."""
        return self.member_ids.shape[0]

    @property
    def tile_rows(self) -> int:
        """Member slots per tile."""
        return self.member_ids.shape[1]


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def refresh_index(index: RetrievalIndex, item_table: qz.Table, *,
                  similarity: str = "cosine") -> RetrievalIndex:
    """Recompute the centroids from the live table under the existing member
    partition (one gather and a masked mean on the table's device): the
    online refresh, which keeps every candidate layout valid."""
    ids = index.member_ids
    valid = ids >= 0
    rows = qz.gather_rows(item_table, ids.clamp_min(0))            # (T, R, K)
    if similarity == "cosine":
        rows = _normalize(rows)
    rows = rows * valid[..., None].to(rows.dtype)
    counts = valid.sum(dim=1).clamp_min(1).to(rows.dtype)
    cent = rows.sum(dim=1) / counts[:, None]
    if similarity == "cosine":
        cent = _normalize(cent)
    return index._replace(centroids=cent.to(qz.logical_dtype(item_table)))


@torch.no_grad()
def build_retrieval_index(item_table: qz.Table, *, tile_rows: int = 512,
                          similarity: str = "cosine", kmeans_iters: int = 8,
                          seed: int = 0) -> RetrievalIndex:
    """Cluster the catalog into ``ceil(I / tile_rows)`` fixed-size tiles.

    A few rounds of spherical k-means (initial centroids: the rows of
    ``np.random.default_rng(seed).choice(I, tiles, replace=False)``) assign
    each item a direction; items are then sorted by (cluster, id) and cut
    into tiles of exactly ``tile_rows`` (balanced by construction, a tile
    may straddle two clusters), and the centroids are recomputed from the
    tiles' members by :func:`refresh_index`.  Runs on the table's device,
    ``KMEANS_CHUNK_ELEMS // tiles`` items at a time."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    num_items = qz.num_rows(item_table)
    num_tiles = max(1, math.ceil(num_items / tile_rows))
    chunk = max(1, KMEANS_CHUNK_ELEMS // num_tiles)

    def rows(start, stop):
        x = qz.slice_rows(item_table, start, stop).to(torch.float32)
        return _normalize(x) if similarity == "cosine" else x

    dev = item_table.device
    pick = np.random.default_rng(seed).choice(num_items, size=num_tiles,
                                              replace=False)
    cent = qz.gather_rows(item_table, torch.as_tensor(pick, device=dev))
    cent = cent.to(torch.float32)
    if similarity == "cosine":
        cent = _normalize(cent)
    assign = torch.zeros(num_items, dtype=torch.int64, device=dev)
    for _ in range(max(kmeans_iters, 0)):
        sums = torch.zeros_like(cent)
        for s0 in range(0, num_items, chunk):
            x = rows(s0, s0 + chunk)
            a = torch.argmax(x @ cent.T, dim=1)
            assign[s0:s0 + x.shape[0]] = a
            sums += segment_sum(a, x, num_tiles)
        counts = torch.bincount(assign, minlength=num_tiles).to(torch.float32)
        live = counts > 0
        cent = torch.where(live[:, None], sums / counts.clamp_min(1)[:, None],
                           cent)
        if similarity == "cosine":
            cent = _normalize(cent)

    order = torch.argsort(assign, stable=True)       # (cluster, id) order
    padded = torch.full((num_tiles * tile_rows,), -1, dtype=torch.int64,
                        device=dev)
    padded[:num_items] = order
    index = RetrievalIndex(member_ids=padded.reshape(num_tiles, tile_rows),
                           centroids=cent)
    return refresh_index(index, item_table, similarity=similarity)


@torch.no_grad()
def candidate_scores(params: mf.MFParams, user_ids: torch.Tensor,
                     index: RetrievalIndex, *, expand_tiles: int,
                     similarity: str = "cosine",
                     exclude_mask: Optional[torch.Tensor] = None):
    """The two stages of :func:`topk_pruned` before its final top-k:
    ``(cand (B, C) int64 item ids, -1 in padding slots; scores (B, C))``,
    ``-inf`` at padding and excluded items.  Centroid scoring picks
    ``expand_tiles`` tiles; their members' rows are gathered as ``(B, C,
    K)`` and scored exactly.  ``exclude_mask`` (B, I) bool is read at the
    candidates only."""
    if expand_tiles < 1:
        raise ValueError(f"expand_tiles must be >= 1, got {expand_tiles}")
    expand = min(int(expand_tiles), index.num_tiles)
    u = qz.gather_rows(params.user_table, user_ids)              # (B, K)

    # Stage 1, coarse: centroids are unit-norm under cosine, so a dot with
    # the normalized user ranks tiles as cosine does.
    uq = _normalize(u) if similarity == "cosine" else u
    top_tiles = stable_topk(uq @ index.centroids.T, expand)      # (B, E)

    # Stage 2, exact scoring on the fixed-size candidate block.
    cand = index.member_ids[top_tiles].reshape(u.shape[0], -1)   # (B, C)
    dead = cand < 0
    safe = cand.clamp_min(0)
    cand_e = qz.gather_rows(params.item_table, safe)             # (B, C, K)
    scores = torch.einsum("bk,bck->bc", u, cand_e)
    if similarity == "cosine":
        un = torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(1e-12)
        cn = torch.linalg.vector_norm(cand_e, dim=-1).clamp_min(1e-12)
        scores = scores / un / cn
    if exclude_mask is not None:
        dead = dead | exclude_mask.gather(1, safe)
    return cand, torch.where(dead, float("-inf"), scores)


@torch.no_grad()
def topk_pruned(params: mf.MFParams, user_ids: torch.Tensor, k: int,
                index: RetrievalIndex, *, expand_tiles: int,
                similarity: str = "cosine",
                exclude_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tile-pruned top-k item ids (int64) per user: the stable top-k of
    :func:`candidate_scores` over a fixed ``(B, expand_tiles * tile_rows)``
    candidate block (ties to the earlier slot).  Returns (B, min(k, C))
    ids; a padding slot that survives into the top-k (only when k exceeds
    the live candidates) comes back as -1.  With ``expand_tiles >=
    num_tiles`` the result is the exact top-k set."""
    cand, scores = candidate_scores(params, user_ids, index,
                                    expand_tiles=expand_tiles,
                                    similarity=similarity,
                                    exclude_mask=exclude_mask)
    return cand.gather(1, stable_topk(scores, min(int(k), cand.shape[1])))
