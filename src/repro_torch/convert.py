"""Carry an MF training state between the JAX reference and the port.

The interchange form is a flat dict of numpy arrays keyed by the checkpoint
leaf names (``train/checkpoint.py::named_leaves``, the same names as the
reference's ``src/repro/train/checkpoint.py``)::

    params/user_table, params/item_table      (R, K) fp32, or for int8:
    params/{user,item}_table/{q,scale,err,err_scale}
    params/aggregator/w [, attn_q]            only with history
    tile/tile_ids, tile/tile_emb, tile/step   only when the state has a tile
    accum/grad_sum/w [, attn_q], accum/count  only with history
    step                                      ()

so a test builds it from a reference state with one tree flatten and both
packages then start from the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregation import AccumulatorState, AggregatorParams
from repro_torch.core.mf import MFParams, MFState
from repro_torch.core.samplers import TileState
from repro_torch.optim.quantization import QuantizedTable
from repro_torch.train.checkpoint import leaf_to_numpy, named_leaves


def mf_state_from_numpy(tree: dict, device="cpu") -> MFState:
    """Build a port :class:`MFState` on ``device`` from the numpy leaf dict
    (ids become int64, counters host ints; the layout of each table and the
    optional parts follow from the names present)."""
    def tensor(name, dtype=None):
        return torch.as_tensor(np.array(tree[name]), dtype=dtype,
                               device=device)

    def table(name):
        if f"{name}/q" in tree:
            return QuantizedTable(*(tensor(f"{name}/{f}")
                                    for f in QuantizedTable._fields))
        return tensor(name)

    def agg_params(prefix):
        attn = f"{prefix}/attn_q"
        return AggregatorParams(tensor(f"{prefix}/w"),
                                tensor(attn) if attn in tree else None)

    tile = aggregator = accum = None
    if "tile/tile_ids" in tree:
        tile = TileState(tile_ids=tensor("tile/tile_ids", torch.int64),
                         tile_emb=tensor("tile/tile_emb"),
                         step=int(tree["tile/step"]))
    if "params/aggregator/w" in tree:
        aggregator = agg_params("params/aggregator")
    if "accum/count" in tree:
        accum = AccumulatorState(agg_params("accum/grad_sum"),
                                 int(tree["accum/count"]))
    return MFState(params=MFParams(table("params/user_table"),
                                   table("params/item_table"), aggregator),
                   tile=tile, accum=accum, step=int(tree["step"]))


def mf_state_to_numpy(state: MFState) -> dict:
    """The numpy leaf dict of a port :class:`MFState` (inverse of
    :func:`mf_state_from_numpy`), with the checkpoint's dtypes: tile ids
    int32 and counters 0-d int32, as the reference keeps them."""
    return {name: leaf_to_numpy(leaf) for name, leaf in named_leaves(state)}
