"""Transformer building blocks of the train path: RMSNorm, the MLPs, standard
RoPE and GQA attention — the port of ``src/repro/models/layers.py``.

Everything here is plain PyTorch (``matmul``/``einsum``), as the reference
leaves it to XLA.  The attention is the reference's
:func:`chunked_attention`, the path its model runs; the hand-written flash
kernel sits behind ``kernels/ops.py::attention``, which the model does not
call, as in the reference.  Layouts are the reference's: activations
``(B, S, H, hd)``, ``wq`` ``(d, Hq, hd)``, ``wk``/``wv`` ``(d, Hkv, hd)``,
``wo`` ``(Hq, hd, d)``.  Decode attention, KV caches, cross-attention and
M-RoPE wait for the serving slice.

Determinism on the card: the GQA repeat of K and V is a broadcast and a
reshape, whose backward is a sum, where ``repeat_interleave`` would go
through an index with an atomic backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDef

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMSNorm with fp32 accumulation, cast back to the input dtype."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def mlp_defs(cfg: ArchConfig, n_layers: int) -> dict:
    """ParamDefs of the MLP for ``n_layers`` stacked layers (0: unstacked)."""
    d, f = cfg.d_model, cfg.d_ff
    lead = (n_layers,) if n_layers else ()
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": ParamDef(lead + (d, f), "scaled_fan_in"),
                "w_up": ParamDef(lead + (d, f), "scaled_fan_in"),
                "w_down": ParamDef(lead + (f, d), "scaled_fan_in")}
    return {"w_up": ParamDef(lead + (d, f), "scaled_fan_in"),
            "w_down": ParamDef(lead + (f, d), "scaled_fan_in")}


def mlp_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Feed-forward block: SwiGLU, or GELU (tanh form, ``jax.nn.gelu``'s
    default) per ``cfg.mlp_kind``."""
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (B, S) integers -> cos, sin (B, S, head_dim // 2), fp32
    (standard RoPE; M-RoPE waits for the VLM family)."""
    freqs = _rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs[None, None]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, S, H, hd), cos/sin (B, S, hd // 2): rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attn_defs(cfg: ArchConfig, n_layers: int) -> dict:
    """ParamDefs of the attention projections for ``n_layers`` layers."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = (n_layers,) if n_layers else ()
    return {"wq": ParamDef(lead + (d, hq, hd), "scaled_fan_in"),
            "wk": ParamDef(lead + (d, hkv, hd), "scaled_fan_in"),
            "wv": ParamDef(lead + (d, hkv, hd), "scaled_fan_in"),
            "wo": ParamDef(lead + (hq, hd, d), "scaled_fan_in")}


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv * groups, hd), each KV head repeated
    for its ``groups`` query heads (``jnp.repeat`` on axis 2)."""
    if groups == 1:
        return x
    b, s, hkv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, hkv, groups, hd).reshape(
        b, s, hkv * groups, hd)


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024):
    """Softmax attention unrolled over query chunks, fp32 throughout.

    q (B, S, Hq, hd); k/v (B, S, Hkv, hd).  GQA repeats KV up to the query
    heads; with ``causal`` a chunk sees keys up to its last query, and the
    mask fills ``NEG_INF``."""
    b, s, hq, hd = q.shape
    g = hq // k.shape[2]
    k, v = repeat_kv(k, g), repeat_kv(v, g)
    scale = 1.0 / (hd ** 0.5)
    chunk = min(chunk, s)
    outs = []
    for lo in range(0, s, chunk):
        qc = q[:, lo:lo + chunk].float()
        kv_hi = min(lo + chunk, s) if causal else s
        logits = torch.einsum("bqhd,bkhd->bhqk", qc, k[:, :kv_hi].float()) * scale
        if causal:
            q_pos = lo + torch.arange(qc.shape[1], device=q.device)
            k_pos = torch.arange(kv_hi, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits,
                                 torch.full((), NEG_INF, dtype=logits.dtype,
                                            device=logits.device))
        probs = torch.softmax(logits, dim=-1)
        oc = torch.einsum("bhqk,bkhd->bqhd", probs, v[:, :kv_hi].float())
        outs.append(oc.to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attn_apply(p: dict, x: torch.Tensor, cos, sin, cfg: ArchConfig, *,
               causal: bool = True, attn_chunk: int = 1024) -> torch.Tensor:
    """Attention block body (no residual, no norm) of the train path:
    projections, RoPE on q and k, chunked attention, output projection."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = chunked_attention(q, k, v, causal=causal, chunk=attn_chunk)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
