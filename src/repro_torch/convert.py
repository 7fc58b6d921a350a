"""Carry an MF training state between the JAX reference and the port.

The interchange form is a flat dict of numpy arrays keyed by the reference's
checkpoint leaf names (``src/repro/train/checkpoint.py`` flattens an
``MFState`` to exactly these paths)::

    params/user_table, params/item_table      (R, K) float
    tile/tile_ids, tile/tile_emb, tile/step   only when the state has a tile
    step                                      ()

so a test builds it from a reference state with one tree flatten and both
packages then start from the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mf import MFParams, MFState
from repro_torch.core.samplers import TileState


def mf_state_from_numpy(tree: dict, device="cpu") -> MFState:
    """Build a port :class:`MFState` on ``device`` from the numpy leaf dict
    (ids become int64, counters host ints)."""
    def tensor(name, dtype=None):
        return torch.as_tensor(np.array(tree[name]), dtype=dtype,
                               device=device)

    tile = None
    if "tile/tile_ids" in tree:
        tile = TileState(tile_ids=tensor("tile/tile_ids", torch.int64),
                         tile_emb=tensor("tile/tile_emb"),
                         step=int(tree["tile/step"]))
    return MFState(params=MFParams(tensor("params/user_table"),
                                   tensor("params/item_table")),
                   tile=tile, step=int(tree["step"]))


def mf_state_to_numpy(state: MFState) -> dict:
    """The numpy leaf dict of a port :class:`MFState` (inverse of
    :func:`mf_state_from_numpy`; tile ids come back int32 as the reference
    keeps them)."""
    tree = {"params/user_table": state.params.user_table.detach().cpu().numpy(),
            "params/item_table": state.params.item_table.detach().cpu().numpy(),
            "step": np.asarray(state.step, np.int32)}
    if state.tile is not None:
        tree["tile/tile_ids"] = state.tile.tile_ids.cpu().numpy().astype(np.int32)
        tree["tile/tile_emb"] = state.tile.tile_emb.detach().cpu().numpy()
        tree["tile/step"] = np.asarray(state.tile.step, np.int32)
    return tree
