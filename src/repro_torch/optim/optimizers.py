"""Optimizers over parameter trees: SGD (with optional momentum), AdamW and
Adafactor — the port of ``src/repro/optim/optimizers.py``.

Each optimizer is an ``(init, update)`` pair over nested dicts of tensors.
The state is the reference's :class:`OptState`: a moment tree parallel to
the parameters (``AdamMoments(mu, nu)`` at each leaf for AdamW, the momentum
tensor for SGD with momentum, ``FactoredMoment(vr, vc, v)`` for Adafactor,
None otherwise) and a 0-d int32 step
``count`` on the parameters' device, so the bias correction is computed on
the device and the host never waits for it.  AdamW's arithmetic is the
reference's, in its order: ``(m / bc1) / (sqrt(v / bc2) + eps)`` with
``bc = 1 - b ** count`` in fp32 — not ``torch.optim.AdamW``, which arranges
the bias correction differently.  Adafactor's is the reference's too, in
its order, with the second moment factored by shape (:func:`_factorable`)
and the update clipped by the RMS of the whole leaf's step; a leaf of rank
3 or more is updated slice by slice along its leading axis in two passes
(:func:`make_adafactor`), so no temporary is larger than one slice.

``state_defs`` maps a ParamDef tree to the state's ParamDef tree with the
reference's specs (moments shard like their parameter; AdamW's ZeRO-1
moments are ``fsdpify``-ed over the data axis), for the sharded layout and
the dry run.  Under a mesh the updates see this rank's slices: SGD and
AdamW are elementwise, so a slice's update is the whole update's slice.
AdamW with ``zero1`` and ``data_shards > 1`` keeps only its data rank's
part of each moment (on the dimension ``state_defs`` gives the data axis;
a sharded LM builds its state from ``state_defs`` itself,
``models/lm_distributed.py``); each data rank computes its part of the
step, the parts are
all-gathered over the data group (in bf16 under ``bf16_step``), and every
rank applies the whole step to its parameter slice: the unsharded update's
bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models.params import (
    ParamDef,
    fsdpify,
    map_defs,
    tree_items,
    tree_map,
)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Named ``(init, update, state_defs)`` bundle: ``init(params) ->
    OptState``, ``update(grads, state, params, lr) -> (new_params,
    new_state)`` and ``state_defs(param_defs) -> the state's ParamDef
    tree``.
    ``update`` writes the new values into the parameter and moment tensors
    it is given and returns them (the reference's jitted step donates the
    state's buffers): each leaf's new value is computed out of place, as
    the reference's arithmetic orders it, then copied over the old one, so
    the bits are the same and one leaf's temporaries are the only extra
    memory (an LM's old and new states are never held together)."""

    name: str
    init: Callable[..., Any]
    update: Callable[..., Any]
    state_defs: Callable[[Any], Any]


class OptState(NamedTuple):
    """Optimizer state: the moment tree (or None) and the 0-d int32 step
    counter."""

    moments: Any
    count: torch.Tensor


class AdamMoments(NamedTuple):
    """Adam's first and second moments of one parameter."""

    mu: torch.Tensor
    nu: torch.Tensor


def _device(params) -> torch.device:
    return tree_items(params)[0][1].device


def _zeros_def(d: ParamDef) -> ParamDef:
    return dataclasses.replace(d, init="zeros")


def _count_def() -> ParamDef:
    return ParamDef((), "zeros")


def make_sgd(momentum: float = 0.0) -> Optimizer:
    """SGD, with heavy-ball momentum when ``momentum > 0``."""
    use_m = momentum > 0.0

    def init(params):
        m = tree_map(torch.zeros_like, params) if use_m else None
        return OptState(m, torch.zeros((), dtype=torch.int32,
                                       device=_device(params)))

    def update(grads, state, params, lr):
        if use_m:
            new_m = tree_map(lambda m, g: m.copy_(momentum * m + g.to(m.dtype)),
                             state.moments, grads)
            new_p = tree_map(lambda p, m: p.copy_((p - lr * m).to(p.dtype)),
                             params, new_m)
            return new_p, OptState(new_m, state.count + 1)
        new_p = tree_map(lambda p, g: p.copy_((p - lr * g).to(p.dtype)),
                         params, grads)
        return new_p, OptState(None, state.count + 1)

    def state_defs(defs):
        return OptState(map_defs(_zeros_def, defs) if use_m else None,
                        _count_def())

    return Optimizer("sgd", init, update, state_defs)


def make_adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, zero1: bool = False,
               data_shards: int = 1, bf16_step: bool = False) -> Optimizer:
    """AdamW with fp32 moments; ``zero1`` with ``data_shards > 1`` keeps
    each data rank's part of the moments only (the module docstring), and
    ``bf16_step`` rounds the step to bf16 before ``p - lr * step``, as the
    reference does, on every path."""
    sliced = zero1 and data_shards > 1

    def init(params):
        def zeros(p):
            shape = list(p.shape)
            if sliced:                # the dimension state_defs gives "data"
                d = fsdpify(ParamDef(tuple(p.shape)), data_shards)
                for i, ax in enumerate(d.spec):
                    if ax is not None:
                        shape[i] //= data_shards
            return AdamMoments(torch.zeros(shape, dtype=torch.float32,
                                           device=p.device),
                               torch.zeros(shape, dtype=torch.float32,
                                           device=p.device))
        return OptState(tree_map(zeros, params),
                        torch.zeros((), dtype=torch.int32,
                                    device=_device(params)))

    def update(grads, state, params, lr):
        c = state.count + 1
        cf = c.float()
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf

        def step_of(p, g, mom: AdamMoments):
            g = g.float()
            m = b1 * mom.mu + (1 - b1) * g
            v = b2 * mom.nu + (1 - b2) * g * g
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            mom.mu.copy_(m)
            mom.nu.copy_(v)
            return step.to(torch.bfloat16) if bf16_step else step

        def upd(p, g, mom: AdamMoments):
            dim = next((i for i, (a, b) in enumerate(zip(p.shape,
                                                         mom.mu.shape))
                        if a != b), None)
            if dim is None:
                step = step_of(p, g, mom)
            else:                     # ZeRO-1: this data rank's part
                group = _zero1_group(p.shape[dim] // mom.mu.shape[dim])
                n = mom.mu.shape[dim]
                part = step_of(p.narrow(dim, group.index * n, n),
                               g.narrow(dim, group.index * n, n), mom)
                step = shd.all_gather_cat(part.contiguous(), dim, group)
            _apply(p, step, 1.0, lr, bf16_step, scaled=False)
            return p, mom

        out = tree_map(upd, params, grads, state.moments)
        return (tree_map(lambda t: t[0], out),
                OptState(tree_map(lambda t: t[1], out), c))

    def state_defs(defs):
        m = map_defs(lambda d: AdamMoments(_zeros_def(d), _zeros_def(d)),
                     defs)
        if sliced:
            m = fsdpify(m, data_shards)
        return OptState(m, _count_def())

    return Optimizer("adamw", init, update, state_defs)


def _zero1_group(n: int):
    """The data group a ZeRO-1 moment is split over (``n`` ranks) on the
    active mesh: the data axis, or every data axis together."""
    mesh = shd.get_mesh()
    for axes in ("data", shd.DATA_AXES):
        group = mesh.group(axes) if mesh is not None else None
        if group is not None and group.size == n:
            return group
    raise ValueError(f"ZeRO-1 moments split {n} ways need a mesh whose data "
                     f"axes have {n} ranks; the active mesh is {mesh}")


class FactoredMoment(NamedTuple):
    """Adafactor's second moment of one parameter: the row and column
    means ``vr`` (the last dimension reduced) and ``vc`` (the second to
    last reduced) of a factorable leaf, or the full ``v`` of another; the
    unused fields are None."""

    vr: Optional[torch.Tensor]
    vc: Optional[torch.Tensor]
    v: Optional[torch.Tensor]


def _factorable(shape) -> bool:
    """Whether a leaf of ``shape`` keeps factored moments: rank 2 or more
    with both trailing dimensions above 1 (by shape, not by meaning: a
    stacked norm (L, d) is factored too)."""
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _advance(g2, fm: FactoredMoment, decay: float) -> FactoredMoment:
    """The new moments from the squared gradient ``g2`` (plus eps)."""
    if fm.v is None:
        return FactoredMoment(decay * fm.vr + (1 - decay) * torch.mean(g2, dim=-1),
                              decay * fm.vc + (1 - decay) * torch.mean(g2, dim=-2),
                              None)
    return FactoredMoment(None, None, decay * fm.v + (1 - decay) * g2)


def _denom(fm: FactoredMoment):
    """The step's clamped denominator from advanced moments: the factored
    ``sqrt(r vc)`` with ``r = vr / mean(vr)``, or ``sqrt(v)``."""
    if fm.v is None:
        r = fm.vr / torch.mean(fm.vr, dim=-1, keepdim=True).clamp(min=1e-30)
        denom = torch.sqrt(r[..., None] * fm.vc[..., None, :])
    else:
        denom = torch.sqrt(fm.v)
    return denom.clamp(min=1e-30)


def _write(dst: FactoredMoment, src: FactoredMoment) -> None:
    for old, new in zip(dst, src):
        if old is not None:
            old.copy_(new)


def _apply(p, step, scale, lr: float, bf16_step: bool,
           scaled: bool = True) -> None:
    """``p <- p - lr * (step / scale)`` in place (``step`` as it is when
    not ``scaled``); with ``bf16_step`` the step, and ``lr`` with it, is
    rounded to bf16 before the product (as the reference's bf16 step meets
    its weakly typed ``lr``), the subtraction in fp32."""
    if scaled:
        step = step / scale
    if bf16_step:
        step = step.to(torch.bfloat16)
        lr = torch.tensor(lr, dtype=torch.bfloat16, device=step.device)
    p.copy_((p - lr * step).to(p.dtype))


def _adafactor_leaf(p, g, fm: FactoredMoment, lr: float, decay: float,
                    eps: float, clip_threshold: float,
                    bf16_step: bool) -> FactoredMoment:
    """Adafactor's update of one whole leaf in one pass (the reference's
    form): the moments and ``p`` written in place."""
    g = g.float()
    new = _advance(g * g + eps, fm, decay)
    step = g / _denom(new)
    norm = torch.sqrt(torch.mean(step * step)).clamp(min=1.0 / clip_threshold)
    _write(fm, new)
    _apply(p, step, norm * clip_threshold, lr, bf16_step)
    return fm


def _adafactor_leaf_sliced(p, g, fm: FactoredMoment, lr: float, decay: float,
                           eps: float, clip_threshold: float,
                           bf16_step: bool) -> FactoredMoment:
    """:func:`_adafactor_leaf` for a leaf of rank 3 or more, one slice of
    the leading axis at a time: everything but the clipping norm (the RMS
    of the whole leaf's step) is independent along that axis, so pass 1
    writes each slice's new moments and sums its squared step, and pass 2
    recomputes each slice's step from the new moments (the same bits) and
    writes its parameters.  Temporaries stay within one slice; the result
    equals the one-pass form's but for the order of the norm's sum."""
    def part(i) -> FactoredMoment:
        return FactoredMoment(*(None if m is None else m[i] for m in fm))

    total = torch.zeros((), dtype=torch.float32, device=p.device)
    for i in range(p.shape[0]):
        gi = g[i].float()
        new = _advance(gi * gi + eps, part(i), decay)
        step = gi / _denom(new)
        total += torch.sum(step * step)
        _write(part(i), new)
    norm = torch.sqrt(total / p.numel()).clamp(min=1.0 / clip_threshold)
    for i in range(p.shape[0]):
        _apply(p[i], g[i].float() / _denom(part(i)), norm * clip_threshold, lr,
               bf16_step)
    return fm


def make_adafactor(decay: float = 0.99, eps: float = 1e-30,
                   clip_threshold: float = 1.0,
                   bf16_step: bool = False) -> Optimizer:
    """Adafactor (Shazeer & Stern): factored fp32 second moments, no first
    moment, update clipping at ``clip_threshold`` of the step's RMS, and
    with ``bf16_step`` the step rounded to bf16 before it is applied.
    Leaves of rank 3 or more (the stacked layer weights) take the two-pass
    sliced update (:func:`_adafactor_leaf_sliced`), the others the one-pass
    form: an LM's update then holds no more than one layer's temporaries,
    which lets granite-8b (8.46 GB stacked MLP leaves) train on one card."""
    def init(params):
        def fm(p):
            kw = dict(dtype=torch.float32, device=p.device)
            if _factorable(p.shape):
                return FactoredMoment(torch.zeros(p.shape[:-1], **kw),
                                      torch.zeros(p.shape[:-2] + p.shape[-1:],
                                                  **kw), None)
            return FactoredMoment(None, None, torch.zeros(p.shape, **kw))
        return OptState(tree_map(fm, params),
                        torch.zeros((), dtype=torch.int32,
                                    device=_device(params)))

    def update(grads, state, params, lr):
        def upd(p, g, fm: FactoredMoment):
            leaf = _adafactor_leaf_sliced if p.ndim >= 3 else _adafactor_leaf
            return leaf(p, g, fm, lr, decay, eps, clip_threshold, bf16_step)

        moments = tree_map(upd, params, grads, state.moments)
        return params, OptState(moments, state.count + 1)

    def state_defs(defs):
        def fm(d: ParamDef):
            if not _factorable(d.shape):
                return FactoredMoment(None, None, _zeros_def(d))
            spec = list(d.spec) + [None] * (len(d.shape) - len(d.spec))
            return FactoredMoment(
                dataclasses.replace(d, shape=d.shape[:-1],
                                    spec=shd.P(*spec[:-1]), init="zeros"),
                dataclasses.replace(d, shape=d.shape[:-2] + d.shape[-1:],
                                    spec=shd.P(*(spec[:-2] + spec[-1:])),
                                    init="zeros"),
                None)
        return OptState(map_defs(fm, defs), _count_def())

    return Optimizer("adafactor", init, update, state_defs)


def get_optimizer(name: str, **kw) -> Optimizer:
    """Construct a registered optimizer by name (``sgd``, ``adamw``,
    ``adafactor``)."""
    if name == "sgd":
        return make_sgd(**kw)
    if name == "adamw":
        return make_adamw(**kw)
    if name == "adafactor":
        return make_adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}; available: sgd, adamw, "
                     "adafactor")
