"""Carry an MF or LM training state between the JAX reference and the port.

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
packages then start from the same numbers.  An LM state's names are the
reference's ``jax.tree_util`` paths of ``LMTrainState``::

    params/<tree path>                        e.g. params/blocks/attn/wq
    opt_state/moments/<tree path>/{mu,nu}     AdamW's moments
    opt_state/moments/<tree path>             SGD with momentum
    opt_state/count                           () int32
    tile/tile_ids, tile/step                  the id-only vocab tile, if any
    step                                      ()

Both LM families carry over by these names: an MoE layer's leaves are
``params/blocks/moe/{router,w_gate,w_up,w_down}``, and an interleaved MoE
stack's ``params/blocks/dense/...`` and ``params/blocks/moe_blk/...``.  A
decode cache (``models/lm.py::DecodeCache``) is named as the reference's
flattens: ``kv/k``, ``kv/v``, or for the interleaved MoE layout
``kv/0/{k,v}`` (the dense layers) and ``kv/1/{k,v}`` (the MoE layers).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregation import AccumulatorState, AggregatorParams
from repro_torch.core.mf import MFParams, MFState
from repro_torch.core.samplers import TileState
from repro_torch.models.layers import KVCache
from repro_torch.models.lm import DecodeCache
from repro_torch.models.params import tree_from_items
from repro_torch.optim.optimizers import AdamMoments, OptState
from repro_torch.optim.quantization import QuantizedTable
from repro_torch.train.checkpoint import leaf_to_numpy, named_leaves
from repro_torch.train.trainer import LMTrainState


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


def _subtree(tree: dict, prefix: str, device):
    """The nested dict of tensors under ``prefix/`` (None when absent)."""
    items = [(name[len(prefix) + 1:], torch.as_tensor(np.array(arr),
                                                      device=device))
             for name, arr in tree.items() if name.startswith(prefix + "/")]
    return tree_from_items(items) if items else None


def _moments(node):
    """Turn ``{"mu": ..., "nu": ...}`` leaf dicts into ``AdamMoments``."""
    if isinstance(node, dict):
        if set(node) == {"mu", "nu"} and not isinstance(node["mu"], dict):
            return AdamMoments(node["mu"], node["nu"])
        return {k: _moments(v) for k, v in node.items()}
    return node


def lm_state_from_numpy(tree: dict, device="cpu") -> LMTrainState:
    """Build a port :class:`~repro_torch.train.trainer.LMTrainState` on
    ``device`` from the numpy leaf dict (tile ids become int64, the tile
    and train steps host ints, the optimizer count a 0-d int32 tensor)."""
    tile = None
    if "tile/tile_ids" in tree:
        tile = TileState(
            tile_ids=torch.as_tensor(np.array(tree["tile/tile_ids"]),
                                     dtype=torch.int64, device=device),
            tile_emb=torch.as_tensor(np.array(tree["tile/tile_emb"]),
                                     device=device)
            if "tile/tile_emb" in tree else None,
            step=int(tree["tile/step"]))
    opt = OptState(_moments(_subtree(tree, "opt_state/moments", device)),
                   torch.as_tensor(np.array(tree["opt_state/count"]),
                                   dtype=torch.int32, device=device))
    return LMTrainState(params=_subtree(tree, "params", device),
                        opt_state=opt, tile=tile, step=int(tree["step"]))


def lm_state_to_numpy(state: LMTrainState) -> dict:
    """The numpy leaf dict of a port LM state (inverse of
    :func:`lm_state_from_numpy`)."""
    return {name: leaf_to_numpy(leaf) for name, leaf in named_leaves(state)}


def _tensor_from_numpy(arr, device) -> torch.Tensor:
    """``arr`` as a tensor on ``device``; a bfloat16 array (ml_dtypes, as
    JAX hands it out) keeps its bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.as_tensor(arr.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def decode_cache_from_numpy(tree: dict, device="cpu") -> DecodeCache:
    """Build a port :class:`~repro_torch.models.lm.DecodeCache` on
    ``device`` from the numpy leaf dict of the reference's cache (the names
    of the module docstring; bfloat16 arrays keep their bits)."""
    def kv(prefix):
        return KVCache(_tensor_from_numpy(tree[f"{prefix}/k"], device),
                       _tensor_from_numpy(tree[f"{prefix}/v"], device))

    if "kv/0/k" in tree:
        return DecodeCache(kv=(kv("kv/0"), kv("kv/1")))
    return DecodeCache(kv=kv("kv"))


def decode_cache_to_numpy(cache: DecodeCache) -> dict:
    """The numpy leaf dict of a port decode cache (inverse of
    :func:`decode_cache_from_numpy`); bfloat16 leaves come out as float32,
    which holds them exactly."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    members = cache.kv if isinstance(cache.kv[0], KVCache) else (cache.kv,)
    out = {}
    for i, m in enumerate(members):
        prefix = f"kv/{i}" if len(members) > 1 else "kv"
        out[f"{prefix}/k"], out[f"{prefix}/v"] = arr(m.k), arr(m.v)
    return out
