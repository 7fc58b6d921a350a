"""The port's LM serving path (``prefill`` -> ``pad_cache`` ->
``decode_step``) against the JAX package, at each served architecture's
``reduced()`` config (2 layers, d=64, 4 heads, at most 2 KV heads, vocab
256; the MoE configs 4 experts, top-2 or top-1, llama4's interleaved
dense/MoE layout in one group).

The reference's parameters are carried into the port by name (the
checkpoint leaf names, as ``convert.py`` uses them); prompts are made with
numpy from a seed.  Tolerances: 1e-5 absolute for fp32 results, the
ROADMAP's tolerance; the reference's own ``rel < 2e-3`` for
decode-after-prefill (``tests/test_models.py``); bf16 results as stated at
their tests.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.train.checkpoint import _flatten_with_paths
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers, lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import tree_from_items

ATOL = 1e-5
#: one bf16 unit in the last place relative to the value (the gap above a
#: power of two): how far two roundings of fp32 numbers 1e-5 apart may land.
BF16_ULP = 2.0 ** -7
SERVED = ["smollm-360m", "minitron-4b", "granite-8b", "command-r-35b",
          "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]
B, S = 2, 12


def _scale_tol(want) -> float:
    """1e-5 relative to the largest element (at least 1e-5 absolute): the
    cache's K/V reach |15| at the reference's init (``wk``'s fan-in is its
    Hkv = 2 rows, as ``ParamDef`` takes the second-to-last dimension), where
    one fp32 unit is 1e-6 and the second layer's K carries the first
    layer's rounding."""
    return ATOL * max(1.0, float(np.abs(want).max()))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tree(jtree) -> dict:
    return {name: np.array(leaf) for name, leaf in _flatten_with_paths(jtree)}


def _port_params(jparams) -> dict:
    return tree_from_items([(n, torch.as_tensor(a))
                            for n, a in _tree(jparams).items()])


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)


def _opts(cache_dtype="float32", **kw):
    return (jlm.TrainOptions(loss="softmax", remat="none", attn_chunk=8,
                             cache_dtype=getattr(jnp, cache_dtype), **kw),
            lm.TrainOptions(loss="softmax", remat="none", attn_chunk=8,
                            cache_dtype=getattr(torch, cache_dtype), **kw))


@pytest.fixture(scope="module")
def models():
    """Per architecture: the two configs, the reference's parameters at
    ``PRNGKey(0)`` and the port's copy of them (built once per module)."""
    out = {}
    for arch in SERVED:
        jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
        jp = jlm.init_params(jax.random.PRNGKey(0), jc)
        out[arch] = (jc, tc, jp, _port_params(jp))
    return out


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (6, 2)])
@pytest.mark.parametrize("pos", [0, 5, 15])
def test_decode_attention_matches_reference(hq, hkv, pos):
    """The (Hkv, g) grouping of the query heads and the ``<= pos`` mask
    (the row at ``pos`` included); the cache rows past ``pos`` hold noise
    that must not be seen."""
    q, k, v = _x((B, 1, hq, 8), 0), _x((B, 16, hkv, 8), 1), _x((B, 16, hkv, 8), 2)
    want = jlayers.decode_attention(q, jlayers.KVCache(k, v),
                                    jnp.asarray(pos, jnp.int32))
    got = layers.decode_attention(torch.as_tensor(q), layers.KVCache(
        torch.as_tensor(k), torch.as_tensor(v)), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _attn_params(tc):
    width = {"wq": tc.d_model, "wk": tc.d_model, "wv": tc.d_model,
             "wo": tc.n_heads * tc.head_dim}
    return {k: _x(d.shape, i) / width[k] ** 0.5
            for i, (k, d) in enumerate(sorted(layers.attn_defs(tc, 0).items()))}


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_attn_apply_prefill_and_decode_match_reference(models, cache_dtype):
    """Prefill: the output and the fresh K/V it returns.  Decode: the row
    written at ``pos`` in the cache's dtype, in place, and the output
    attended in fp32 over the cache with that row."""
    jc, tc = models["smollm-360m"][:2]
    p = _attn_params(tc)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    x = _x((B, 16, tc.d_model), 5)
    pos = np.tile(np.arange(16, dtype=np.int32), (B, 1))
    jcos, jsin = jlayers.rope_cos_sin(jnp.asarray(pos), jc.head_dim, jc.rope_theta)
    cos, sin = layers.rope_cos_sin(torch.as_tensor(pos), tc.head_dim, tc.rope_theta)
    want, want_kv = jlayers.attn_apply(p, x, jcos, jsin, jc, attn_chunk=8)
    got, got_kv = layers.attn_apply(tp, torch.as_tensor(x), cos, sin, tc,
                                    attn_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_kv.k.numpy(), np.asarray(want_kv.k), atol=ATOL)
    np.testing.assert_allclose(got_kv.v.numpy(), np.asarray(want_kv.v), atol=ATOL)

    # Decode at position 9 into a 16-row cache that holds rows 0..8.
    at = 9
    hkv, hd = tc.n_kv_heads, tc.head_dim
    ck, cv = _x((B, 16, hkv, hd), 6), _x((B, 16, hkv, hd), 7)
    ck[:, at:] = cv[:, at:] = 0.0
    xd = _x((B, 1, tc.d_model), 8)
    dpos = np.full((B, 1), at, np.int32)
    jcos, jsin = jlayers.rope_cos_sin(jnp.asarray(dpos), jc.head_dim, jc.rope_theta)
    cos, sin = layers.rope_cos_sin(torch.as_tensor(dpos), tc.head_dim, tc.rope_theta)
    jdt = getattr(jnp, cache_dtype)
    want, want_cache = jlayers.attn_apply(
        p, xd, jcos, jsin, jc, cache=jlayers.KVCache(jnp.asarray(ck, jdt),
                                                     jnp.asarray(cv, jdt)),
        pos=jnp.asarray(at, jnp.int32))
    tdt = getattr(torch, cache_dtype)
    cache = layers.KVCache(torch.as_tensor(ck).to(tdt), torch.as_tensor(cv).to(tdt))
    got, got_cache = layers.attn_apply(tp, torch.as_tensor(xd), cos, sin, tc,
                                       cache=cache, pos=at)
    assert got_cache.k is cache.k and got_cache.k.dtype == tdt    # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for g_, w_ in ((got_cache.k, want_cache.k), (got_cache.v, want_cache.v)):
        w_ = np.asarray(w_.astype(jnp.float32))
        g_ = g_.float().numpy()
        np.testing.assert_array_equal(np.delete(g_, at, axis=1),
                                      np.delete(w_, at, axis=1))
        # The new row: fp32 to 1e-5, bf16 to one rounding of such numbers.
        tol = ATOL + (BF16_ULP * np.abs(w_[:, at]) if cache_dtype == "bfloat16" else 0)
        assert np.all(np.abs(g_[:, at] - w_[:, at]) <= tol)


@pytest.mark.parametrize("probs,acc", [("bfloat16", "float32"),
                                       ("float32", "bfloat16"),
                                       ("bfloat16", "bfloat16")])
def test_bf16_attention_knobs_match_reference(probs, acc):
    """``probs_dtype`` / ``attn_acc_dtype`` at bf16 against the reference
    with the same knobs, on unit-normal q, k, v (outputs up to about 2).
    Measured over five seeds: bf16 probabilities alone give the
    reference's bits; bf16 logits and softmax differ by up to 1.2e-2, and
    both together by up to one bf16 unit of the largest output (1.6e-2 at
    outputs up to 2.3): the packages round at the same points, but the
    softmax's sums differ in order and width.  Held to 1e-5 for bf16
    probabilities alone, else to 2^-7 of the largest output."""
    q, k, v = _x((B, 16, 4, 8), 0), _x((B, 16, 2, 8), 1), _x((B, 16, 2, 8), 2)
    kw = dict(causal=True, chunk=6)
    want = np.asarray(jlayers.chunked_attention(
        q, k, v, probs_dtype=getattr(jnp, probs), acc_dtype=getattr(jnp, acc),
        **kw), np.float32)
    got = layers.chunked_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                   probs_dtype=getattr(torch, probs),
                                   acc_dtype=getattr(torch, acc), **kw)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    tol = ATOL if acc == "float32" else BF16_ULP * np.abs(want).max()
    assert err <= tol, (err, tol)


def test_bf16_knobs_in_prefill_match_reference(models):
    """Both knobs at bf16 through the whole smollm stack: prefill logits
    (up to 0.6) within 5e-3 of the reference's with the same knobs
    (measured: 1.3e-3) and within 2e-2 of the port's fp32 logits
    (measured: 6.6e-3)."""
    jc, tc, jp, tp = models["smollm-360m"]
    toks = _tokens(tc.vocab)[:, :S]
    kw = dict(probs_dtype="bfloat16", attn_acc_dtype="bfloat16")
    jo = jlm.TrainOptions(loss="softmax", remat="none", attn_chunk=8,
                          **{k: getattr(jnp, v) for k, v in kw.items()})
    to = lm.TrainOptions(loss="softmax", remat="none", attn_chunk=8,
                         **{k: getattr(torch, v) for k, v in kw.items()})
    want, _ = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, jo)
    got, _ = lm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.int64)},
                        tc, to, device="cpu")
    fp32, _ = lm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.int64)},
                         tc, _opts()[1], device="cpu")
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 5e-3
    assert np.abs(got.numpy() - fp32.numpy()).max() <= 2e-2


# --------------------------------------------------------------------------
# prefill, pad_cache, decode_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVED)
def test_prefill_matches_reference(models, arch):
    """fp32 cache: the logits to 1e-5 and every cache leaf to 1e-5 of its
    largest element (:func:`_scale_tol`; measured: 1.8e-5 absolute on K of
    up to 15).  The default
    bf16 cache: the same logits, and each cache element within one bf16
    rounding of the reference's (|d| <= 1e-5 + 2^-7 |ref|; measured: equal
    bits in all but 0.13% of the elements, which sit one to three bf16
    units apart where the fp32 values straddle a rounding boundary)."""
    jc, tc, jp, tp = models[arch]
    toks = _tokens(tc.vocab)[:, :S]
    for dt in ("float32", "bfloat16"):
        jo, to = _opts(dt)
        want, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, jo)
        got, cache = lm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.int64)},
                                tc, to, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        assert got.shape == (B, tc.vocab)
        want_c = {n: a.astype(np.float32) for n, a in _tree(jcache).items()}
        got_c = convert.decode_cache_to_numpy(cache)
        assert list(got_c) == list(want_c), (list(got_c), list(want_c))
        for name, w in want_c.items():
            assert got_c[name].shape == w.shape, name
            d = np.abs(got_c[name] - w)
            if dt == "float32":
                assert d.max() <= _scale_tol(w), (name, d.max())
            else:
                assert np.all(d <= _scale_tol(w) + BF16_ULP * np.abs(w)), name
                assert (d > 0).mean() < 0.01, name


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_step_fed_the_reference_cache_matches(models, arch, cache_dtype):
    """The reference's prefill cache, padded and carried over with
    ``decode_cache_from_numpy`` (bf16 bits kept), into the port's
    ``decode_step``: the logits to 1e-5 and the cache after the step
    equal to the reference's (the written rows to 1e-5 of the largest
    element, or one bf16 rounding more)."""
    jc, tc, jp, tp = models[arch]
    toks = _tokens(tc.vocab, seed=1)
    jo, to = _opts(cache_dtype)
    _, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jc, jo)
    jcache = jlm.pad_cache(jcache, jc, S + 3)
    want, jnew = jlm.decode_step(jp, jcache, jnp.asarray(toks[:, S:]),
                                 jnp.asarray(S, jnp.int32), jc, jo)
    cache = convert.decode_cache_from_numpy(_tree(jcache))
    kv0 = cache.kv[0] if isinstance(cache.kv[0], layers.KVCache) else cache.kv
    assert kv0.k.dtype == getattr(torch, cache_dtype)
    got, new = lm.decode_step(tp, cache, torch.as_tensor(toks[:, S:], dtype=torch.int64),
                              S, tc, to, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert got.shape == (B, 1, tc.vocab)
    want_c = {n: a.astype(np.float32) for n, a in _tree(jnew).items()}
    got_c = convert.decode_cache_to_numpy(new)
    for name, w in want_c.items():
        tol = _scale_tol(w) + (BF16_ULP * np.abs(w) if cache_dtype == "bfloat16" else 0)
        assert np.all(np.abs(got_c[name] - w) <= tol), name


@pytest.mark.parametrize("arch", SERVED)
def test_decode_after_prefill_matches_prefill(models, arch):
    """The port on its own: decoding token S against the prefilled cache
    equals prefilling S + 1 tokens, within the reference's ``rel < 2e-3``
    (with its fp32 cache), and two more steps stay finite."""
    _, tc, _, tp = models[arch]
    toks = torch.as_tensor(_tokens(tc.vocab, seed=2), dtype=torch.int64)
    to = _opts()[1]
    gt, _ = lm.prefill(tp, {"tokens": toks}, tc, to, device="cpu")
    _, cache = lm.prefill(tp, {"tokens": toks[:, :S]}, tc, to, device="cpu")
    cache = lm.pad_cache(cache, tc, S + 3)
    dl, cache = lm.decode_step(tp, cache, toks[:, S:], S, tc, to, device="cpu")
    rel = (gt - dl[:, 0]).abs().max().item() / (gt.abs().max().item() + 1e-9)
    assert rel < 2e-3, rel
    tok = dl[:, 0].argmax(-1)[:, None]
    for i in (1, 2):
        dl, cache = lm.decode_step(tp, cache, tok, S + i, tc, to, device="cpu")
        assert bool(torch.isfinite(dl).all())
        tok = dl[:, 0].argmax(-1)[:, None]
    with pytest.raises(ValueError, match="outside the cache"):
        lm.decode_step(tp, cache, tok, S + 3, tc, to, device="cpu")


@pytest.mark.parametrize("arch", ["smollm-360m", "llama4-maverick-400b-a17b"])
def test_pad_cache_shapes_in_both_layouts(models, arch):
    """``pad_cache`` grows dim 2 to ``max_len`` with zero rows, keeps the
    prefix, matches ``cache_defs`` and the reference's padded shapes; the
    interleaved layout pads both members."""
    jc, tc, jp, tp = models[arch]
    toks = _tokens(tc.vocab)[:, :S]
    jo, to = _opts("bfloat16")
    _, cache = lm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.int64)},
                          tc, to, device="cpu")
    _, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, jo)
    padded = lm.pad_cache(cache, tc, 20)
    want = {n: a.shape for n, a in _tree(jlm.pad_cache(jcache, jc, 20)).items()}
    defs = {n: d.shape for n, d in convert_names(lm.cache_defs(tc, B, 20)).items()}
    got = {n: a.shape for n, a in convert_names(padded).items()}
    assert got == want == defs
    for name, a in convert_names(padded).items():
        before = convert_names(cache)[name]
        assert a.dtype == torch.bfloat16
        assert torch.equal(a[:, :, :S], before) and not a[:, :, S:].any(), name
    interleaved = isinstance(padded.kv[0], layers.KVCache)
    assert interleaved == (tc.moe_every > 1)
    if interleaved:
        g = lm.num_groups(tc)
        assert padded.kv[0].k.shape[0] == g * (tc.moe_every - 1)
        assert padded.kv[1].k.shape[0] == g
    assert lm.pad_cache(padded, tc, 20).kv == padded.kv     # already long enough


def convert_names(cache) -> dict:
    """Leaf name -> tensor or ParamDef of a decode cache, in
    ``convert.py``'s names."""
    members = cache.kv if isinstance(cache.kv[0], layers.KVCache) else (cache.kv,)
    out = {}
    for i, m in enumerate(members):
        prefix = f"kv/{i}" if len(members) > 1 else "kv"
        out[f"{prefix}/k"], out[f"{prefix}/v"] = m.k, m.v
    return out


def test_decode_cache_roundtrips_through_convert(models):
    """bf16 bits survive the trip from the reference's cache and back."""
    jc, tc, jp, _ = models["llama4-maverick-400b-a17b"]
    _, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(_tokens(tc.vocab)[:, :S])},
                            jc, _opts("bfloat16")[0])
    want = _tree(jcache)
    cache = convert.decode_cache_from_numpy(want)
    assert cache.kv[0].k.dtype == torch.bfloat16 and cache.mamba is None
    got = convert.decode_cache_to_numpy(cache)
    assert list(got) == list(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n].astype(np.float32))


# --------------------------------------------------------------------------
# Configs, refusals, the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVED)
def test_config_is_the_reference_config(arch):
    for reduce in (False, True):
        jc, tc = jget_config(arch), get_config(arch)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.head_dim, lm.num_groups(tc), lm.layers_per_group(tc)) == (
            jc.head_dim, jlm.num_groups(jc), jlm.layers_per_group(jc))
    assert get_config(arch.replace("-", "_").replace(".", "p")) == get_config(arch)


@pytest.mark.parametrize("arch,family", [("whisper-medium", "audio")])
def test_waiting_families_raise_and_name_their_slice(arch, family):
    """The family that once waited for a later slice of the port (audio)
    is served now: its config, ``model_defs`` and ``cache_defs`` (reduced)
    equal the reference's, names and shapes, the config also built from
    the reference's fields; an unknown family is refused by name."""
    tc = get_config(arch).reduced()
    assert tc.family == family
    cfg = ArchConfig(**{f.name: getattr(jget_config(arch).reduced(), f.name)
                        for f in dataclasses.fields(ArchConfig)
                        if f.name != "heat"})
    assert cfg == dataclasses.replace(tc, heat=cfg.heat)
    jc = jget_config(arch).reduced()
    for fn, jfn in ((lm.model_defs, jlm.model_defs),
                    (lambda c: lm.cache_defs(c, 2, 8),
                     lambda c: jlm.cache_defs(c, 2, 8))):
        want = {n: d.shape for n, d in _flatten_with_paths(jfn(jc))}
        got = {n: d.shape for n, d in _def_items(fn(cfg))}
        assert got == want
    with pytest.raises(ValueError, match="unknown family"):
        lm.model_defs(dataclasses.replace(cfg, family="no-such-family"))


def _def_items(tree, prefix=""):
    """``(name, ParamDef)`` of a ParamDef tree of dicts and NamedTuples,
    named as the reference's leaves are (None fields absent)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _def_items(tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, tuple):
        return [x for f in tree._fields if getattr(tree, f) is not None
                for x in _def_items(getattr(tree, f),
                                    f"{prefix}/{f}" if prefix else f)]
    return [(prefix, tree)]


def test_prefill_and_decode_refuse_to_fall_back_to_cpu(models):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, tc, _, tp = models["smollm-360m"]
    toks = torch.as_tensor(_tokens(tc.vocab), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.prefill(tp, {"tokens": toks}, tc)
    _, cache = lm.prefill(tp, {"tokens": toks}, tc, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.decode_step(tp, lm.pad_cache(cache, tc, S + 2), toks[:, :1], S + 1, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(0, tc)


@pytest.mark.parametrize("arch", ["smollm-360m", "moonshot-v1-16b-a3b"])
def test_serve_cli_decodes_on_cpu(capsys, arch):
    """The reference's three lines; the generated ids are the first
    sequence's prompt-end token and one per decode step."""
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--device", "cpu", "--decode-steps", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3, lines
    assert lines[0].startswith("prefill: 4x16 tokens in ")
    assert lines[1].startswith("decode: ") and "us/token/sequence" in lines[1]
    ids = json.loads(lines[2].split(": ", 1)[1])
    assert lines[2].startswith("generated ids[0]: ") and len(ids) == 6
    assert all(0 <= i < 256 for i in ids)


def test_full_width_decode_check_needs_conditioned_attention():
    """ROADMAP.md C.6.  The reference's init divides ``wq``/``wk`` by their
    head counts (``ParamDef``'s fan-in is the second-to-last dimension), so
    at full width the attention logits are of order 100 and nearly
    hard-max: two fp32 orders of the same sums (prefill of S + 1 tokens,
    decode at S) part further at every layer.  At smollm-360m's full width
    and depth (32 prompt tokens) the reference's own decode-after-prefill
    check fails (measured on the CPU: rel 0.24; 0.85 with 64 tokens, the
    port's 0.89; 1.18 on an NVIDIA H100 at 1,024 tokens, ``chip_smoke.py``
    phase 19a).
    With the attention projections at 1/sqrt of their contraction width
    the port holds ``rel < 2e-3`` (measured: 1.0e-6)."""
    import math
    n_layers, s = 32, 32
    jc = dataclasses.replace(jget_config("smollm-360m"), n_layers=n_layers)
    tc = dataclasses.replace(get_config("smollm-360m"), n_layers=n_layers)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    toks = np.random.default_rng(3).integers(0, tc.vocab, (B, s + 1)).astype(np.int32)
    jo, to = _opts()
    want, _ = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, jo)
    _, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc, jo)
    got, _ = jlm.decode_step(jp, jlm.pad_cache(jcache, jc, s + 1),
                             jnp.asarray(toks[:, s:]), jnp.asarray(s, jnp.int32), jc, jo)
    rel_ref = float(jnp.abs(want - got[:, 0]).max() / jnp.abs(want).max())
    assert rel_ref > 2e-3, rel_ref                 # the reference's own check fails

    tp = _port_params(jp)
    d, hq, hkv = tc.d_model, tc.n_heads, tc.n_kv_heads
    for name, scale in (("wq", hq / d), ("wk", hkv / d), ("wv", hkv / d), ("wo", 1 / hq)):
        tp["blocks"]["attn"][name].mul_(math.sqrt(scale))
    t = torch.as_tensor(toks, dtype=torch.int64)
    want, _ = lm.prefill(tp, {"tokens": t}, tc, to, device="cpu")
    _, cache = lm.prefill(tp, {"tokens": t[:, :s]}, tc, to, device="cpu")
    got, _ = lm.decode_step(tp, lm.pad_cache(cache, tc, s + 1), t[:, s:], s, tc, to,
                            device="cpu")
    rel = ((want - got[:, 0]).abs().max() / want.abs().max()).item()
    assert rel < 2e-3, rel
