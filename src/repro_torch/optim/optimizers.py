"""Optimizers over parameter trees: SGD (with optional momentum) and AdamW —
the port of ``src/repro/optim/optimizers.py``.

Each optimizer is an ``(init, update)`` pair over nested dicts of tensors.
The state is the reference's :class:`OptState`: a moment tree parallel to
the parameters (``AdamMoments(mu, nu)`` at each leaf for AdamW, the momentum
tensor for SGD with momentum, None otherwise) and a 0-d int32 step
``count`` on the parameters' device, so the bias correction is computed on
the device and the host never waits for it.  AdamW's arithmetic is the
reference's, in its order: ``(m / bc1) / (sqrt(v / bc2) + eps)`` with
``bc = 1 - b ** count`` in fp32 — not ``torch.optim.AdamW``, which arranges
the bias correction differently.  Adafactor waits (``get_optimizer`` raises).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.params import tree_items, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Named ``(init, update)`` bundle: ``init(params) -> OptState`` and
    ``update(grads, state, params, lr) -> (new_params, new_state)``.
    ``update`` writes the new values into the parameter and moment tensors
    it is given and returns them (the reference's jitted step donates the
    state's buffers): each leaf's new value is computed out of place, as
    the reference's arithmetic orders it, then copied over the old one, so
    the bits are the same and one leaf's temporaries are the only extra
    memory (an LM's old and new states are never held together)."""

    name: str
    init: Callable[[Any], Any]
    update: Callable[..., Any]


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

    return Optimizer("sgd", init, update)


def make_adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0) -> Optimizer:
    """AdamW with fp32 moments (ZeRO-1 and the bf16 step wait for the mesh
    slice)."""
    def init(params):
        def zeros(p):
            return AdamMoments(torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device),
                               torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device))
        return OptState(tree_map(zeros, params),
                        torch.zeros((), dtype=torch.int32,
                                    device=_device(params)))

    def update(grads, state, params, lr):
        c = state.count + 1
        cf = c.float()
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf

        def upd(p, g, mom: AdamMoments):
            g = g.float()
            m = b1 * mom.mu + (1 - b1) * g
            v = b2 * mom.nu + (1 - b2) * g * g
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            p.copy_((p - lr * step).to(p.dtype))
            return p, AdamMoments(mom.mu.copy_(m), mom.nu.copy_(v))

        out = tree_map(upd, params, grads, state.moments)
        return (tree_map(lambda t: t[0], out),
                OptState(tree_map(lambda t: t[1], out), c))

    return Optimizer("adamw", init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    """Construct a registered optimizer by name (``sgd``, ``adamw``);
    ``adafactor`` waits for a later slice."""
    if name == "sgd":
        return make_sgd(**kw)
    if name == "adamw":
        return make_adamw(**kw)
    if name == "adafactor":
        raise ValueError("optimizer 'adafactor' waits for a later slice of "
                         "the port (ROADMAP.md, queue A)")
    raise ValueError(f"unknown optimizer {name!r}; available: sgd, adamw")
