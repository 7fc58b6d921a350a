"""Mamba2 (state-space duality) mixer layers: the chunked SSD scan of the
train and prefill paths and the O(1) recurrence of decoding — the port of
``src/repro/models/ssm.py``.

SSD chunked algorithm (Dao & Gu, arXiv:2405.21060): the sequence is split
into chunks of Q tokens; within a chunk the recurrence is a masked
attention-like quadratic form, across chunks a small (h, s, p) state is
carried from chunk to chunk.  Decoding is the recurrence itself:
``state' = exp(dt * A) * state + dt * B x^T``, one token costing O(h * p * s)
whatever the context, which is why the SSM family holds a 500k context.

Everything here is plain PyTorch, as the reference leaves it to XLA (no
Pallas kernel).  One departure: the intra-chunk decay is built as
``exp(where(mask, diff, -inf))`` where the reference computes
``where(mask, exp(diff), 0)``.  The forward values are the same bits (the
masked entries are exact zeros either way), but above the diagonal ``diff``
is a positive sum of ``|dt * A|`` over up to Q - 1 tokens, which at the
configs' chunk of 256 passes 88, so ``exp`` overflows to ``inf`` and the
reference's backward multiplies the zero cotangent by ``inf``: its
gradients are NaN there (ROADMAP.md C.7).  Masking before the ``exp`` keeps
them finite.

Determinism on the card: a group's B and C rows are repeated over its heads
with a broadcast and a reshape (``layers.repeat_kv``), whose backward is a
sum, as ``jnp.repeat`` on axis 2 orders them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import repeat_kv
from repro_torch.distributed.sharding import P
from repro_torch.models.params import ParamDef


def _dims(cfg: ArchConfig):
    """(d_inner, heads, head_dim, groups, state) of the config's mixer."""
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state


def mamba_defs(cfg: ArchConfig, n_layers: int) -> dict:
    """ParamDefs of ``n_layers`` stacked Mamba mixer layers (0: unstacked),
    with the reference's names and inits."""
    d = cfg.d_model
    d_in, h, _, g, s = _dims(cfg)
    lead = (n_layers,) if n_layers else ()
    sl = (None,) * len(lead)
    cw = cfg.conv_width

    def pd(shape, spec, init, scale=0.02):
        return ParamDef(lead + shape, init, scale, P(*sl, *spec))

    return {
        "w_z": pd((d, d_in), (None, "model"), "scaled_fan_in"),
        "w_x": pd((d, d_in), (None, "model"), "scaled_fan_in"),
        "w_b": pd((d, g * s), (None, None), "scaled_fan_in"),
        "w_c": pd((d, g * s), (None, None), "scaled_fan_in"),
        "w_dt": pd((d, h), (None, "model"), "scaled_fan_in"),
        "dt_bias": pd((h,), ("model",), "zeros"),
        "conv_x": pd((cw, d_in), (None, "model"), "normal", 0.2),
        "conv_b": pd((cw, g * s), (None, None), "normal", 0.2),
        "conv_c": pd((cw, g * s), (None, None), "normal", 0.2),
        "a_log": pd((h,), ("model",), "zeros"),
        "d_skip": pd((h,), ("model",), "ones"),
        "gate_norm": pd((d_in,), ("model",), "ones"),
        "w_out": pd((d_in, d), ("model", None), "scaled_fan_in"),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of width cw: u (B, S, C), w (cw, C)."""
    cw, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, cw - 1, 0))
    y = pad[:, 0:s] * w[0]
    for i in range(1, cw):
        y = y + pad[:, i:i + s] * w[i]
    return y


def _ssd_chunked(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, chunk: int):
    """The SSD scan.  xdt (b, S, h, p) [x times dt], dA (b, S, h), B and C
    (b, S, h, s) [groups already broadcast]; returns (y (b, S, h, p) in
    xdt's dtype, the final state (b, h, s, p) in fp32).

    A sequence that is not a multiple of the chunk is zero-padded at the
    tail: x = 0 adds nothing to the states and dA = 0 decays by exp(0) = 1,
    so the final state is exact; the padded rows of y are dropped."""
    b, s_len, h, p = xdt.shape
    n_state = B.shape[-1]
    q = min(chunk, s_len)
    pad = (-s_len) % q
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    true_len, s_len = s_len, s_len + pad
    nc = s_len // q

    xr = xdt.reshape(b, nc, q, h, p).float()
    br = B.reshape(b, nc, q, h, n_state).float()
    cr = C.reshape(b, nc, q, h, n_state).float()
    cs = torch.cumsum(dA.reshape(b, nc, q, h).float(), dim=2)     # (b,nc,q,h)

    # Intra-chunk: the masked quadratic form.  Masked before the exp (C.7).
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]            # (b,nc,i,j,h)
    idx = torch.arange(q, device=xdt.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, diff, torch.full(
        (), float("-inf"), dtype=diff.dtype, device=diff.device)))
    scores = torch.einsum("bnihs,bnjhs->bnijh", cr, br)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", scores * decay, xr)

    # Chunk-final states: S_n = sum_j exp(cs_last - cs_j) B_j x_j^T.
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)                  # (b,nc,q,h)
    states = torch.einsum("bnjhs,bnjh,bnjhp->bnhsp", br, decay_end, xr)

    # Inter-chunk recurrence over the chunks.
    total = torch.exp(cs[:, :, -1, :])                            # (b,nc,h)
    prev = torch.zeros((b, h, n_state, p), dtype=torch.float32,
                       device=xdt.device)
    starts = []
    for n in range(nc):
        starts.append(prev)
        prev = prev * total[:, n][:, :, None, None] + states[:, n]
    start_states = torch.stack(starts, dim=1)                     # (b,nc,h,s,p)

    y_inter = torch.einsum("bnihs,bnih,bnhsp->bnihp", cr, torch.exp(cs),
                           start_states)
    y = (y_intra + y_inter).reshape(b, s_len, h, p)[:, :true_len]
    return y.to(xdt.dtype), prev


class MambaCache(NamedTuple):
    """Decode-time Mamba state of one layer, or of a stack of layers with a
    leading (L,) axis."""

    conv: torch.Tensor     # (B, cw - 1, d_in + 2 * g * s): the conv window
    state: torch.Tensor    # (B, h, s, p): the SSM state, fp32


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> MambaCache:
    """A zeroed :class:`MambaCache` for ``batch`` sequences; the state is
    fp32 whatever ``dtype`` the conv window takes."""
    d_in, h, p, g, s = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, d_in + 2 * g * s),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, h, s, p), dtype=torch.float32,
                          device=device))


def _project(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """The input projections z, x, B, C and the step sizes dt."""
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    bb = x @ p["w_b"]
    cc = x @ p["w_c"]
    dt = F.softplus((x @ p["w_dt"]) + p["dt_bias"])
    return z, xs, bb, cc, dt


def _broadcast_groups(t: torch.Tensor, heads: int, groups: int,
                      s: int) -> torch.Tensor:
    """(B, S, g * s) -> (B, S, h, s), each group repeated over its
    ``heads // groups`` consecutive heads (``jnp.repeat`` on axis 2, i.e.
    ``repeat_interleave``, not ``Tensor.repeat``)."""
    b, sl, _ = t.shape
    return repeat_kv(t.reshape(b, sl, groups, s), heads // groups)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, p: dict,
                cfg: ArchConfig) -> torch.Tensor:
    """Mamba2's gated RMSNorm, then the output projection:
    ``norm(y * silu(z)) * gate_norm @ w_out``."""
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + cfg.norm_eps).to(y.dtype)) * p["gate_norm"]
    return y @ p["w_out"]


def mamba_apply(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """Train and prefill path: x (B, S, d) -> (y (B, S, d), the final
    :class:`MambaCache`: the last cw - 1 conv inputs and the scan's final
    state)."""
    d_in, h, hd, g, s = _dims(cfg)
    b, sl, _ = x.shape
    z, xs, bb, cc, dt = _project(p, x, cfg)

    conv_in = torch.cat([xs, bb, cc], dim=-1)
    conv_w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, conv_w))
    xs, bb, cc = torch.split(conv_out, [d_in, g * s, g * s], dim=-1)

    a = -torch.exp(p["a_log"].float())                             # (h,)
    dA = dt.float() * a                                            # (B,S,h)
    xh = xs.reshape(b, sl, h, hd)
    xdt = xh * dt[..., None].to(xh.dtype)
    bh = _broadcast_groups(bb, h, g, s)
    ch = _broadcast_groups(cc, h, g, s)

    y, final_state = _ssd_chunked(xdt, dA, bh, ch, cfg.ssm_chunk)
    y = y + xh * p["d_skip"].reshape(1, 1, h, 1)
    out = _gated_norm(y.reshape(b, sl, d_in), z, p, cfg)
    cache = MambaCache(conv=conv_in[:, -(cfg.conv_width - 1):],
                       state=final_state)
    return out, cache


def mamba_decode(p: dict, x: torch.Tensor, cache: MambaCache,
                 cfg: ArchConfig):
    """One token: x (B, 1, d) -> (y (B, 1, d), the new :class:`MambaCache`
    (the window shifted by one, the state advanced one step); ``cache`` is
    not written)."""
    d_in, h, hd, g, s = _dims(cfg)
    b = x.shape[0]
    z, xs, bb, cc, dt = _project(p, x, cfg)

    conv_in = torch.cat([xs, bb, cc], dim=-1)                      # (B,1,C)
    window = torch.cat([cache.conv, conv_in], dim=1)               # (B,cw,C)
    conv_w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, conv_w))[:, None]
    xs, bb, cc = torch.split(conv_out, [d_in, g * s, g * s], dim=-1)

    a = -torch.exp(p["a_log"].float())
    dA = torch.exp(dt[:, 0].float() * a)                           # (B,h)
    xh = xs.reshape(b, h, hd)
    bh = _broadcast_groups(bb, h, g, s)[:, 0]                      # (B,h,s)
    ch = _broadcast_groups(cc, h, g, s)[:, 0]
    dtx = (dt[:, 0, :, None] * xh).float()                         # (B,h,p)

    new_state = (cache.state * dA[:, :, None, None]
                 + torch.einsum("bhs,bhp->bhsp", bh.float(), dtx))
    y = torch.einsum("bhs,bhsp->bhp", ch.float(), new_state)
    y = y.to(x.dtype) + xh * p["d_skip"].reshape(1, h, 1)
    out = _gated_norm(y.reshape(b, 1, d_in), z, p, cfg)
    return out, MambaCache(conv=window[:, 1:], state=new_state)
