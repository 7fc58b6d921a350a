"""The port's SSM (mamba2-370m), hybrid (zamba2-2.7b), VLM (qwen2-vl-2b) and
audio (whisper-medium) families against the JAX package, at their
``reduced()`` configs (2 layers, d=64, vocab 256; Mamba heads of 16 with a
state of 16 and a chunk of 8; the hybrid one group of 2 Mamba blocks and
the shared block, and a second case at 4 layers, 2 groups, where the
shared block's gradient sums over its two applications; the VLM 8 patch
rows and M-RoPE; the audio model 2 encoder layers over 16 frames, 2
decoder layers with cross-attention, 4 query heads on 2 K/V heads).

Parameters are drawn with numpy from a seed at the reference's init
scales, except the attention projections, at 1/sqrt of their contraction
width (the decoder's ``cross`` projections too): at the reference's own init (``wq``'s fan-in is its head count) the
attention logits are of order 20 at this width and the softmax nearly
hard-max, so two fp32 orders of the same gradient part by up to 9e-4 on the
token embedding (both packages are that far from each other's float64 runs;
ROADMAP.md C.6).  The same tree goes into both packages.  The HEAT head's
negatives replay the reference's draws as ``tests/test_torch_lm.py`` does;
patches and frames are numpy normals times 0.1.  Tolerances: 1e-5 absolute for fp32
results, 1e-5 of the largest element for cache leaves, one bf16 rounding
more for bf16 caches, and the reference's ``rel < 2e-3`` for
decode-after-prefill.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import (  # noqa: F401  (replay is a fixture)
    _port_tile,
    _record_draws,
    _tcfg,
    _tree,
    replay,
)

from repro.configs import get_config as jget_config
from repro.core import samplers as jsam
from repro.data import pipeline as jpipeline
from repro.models import lm as jlm
from repro.models.params import abstract as jabstract
from repro.optim import optimizers as joptim
from repro.train import trainer as jtrainer
from repro.train.checkpoint import _flatten_with_paths
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.kernels import ccl_similarity
from repro_torch.models import layers, lm, ssm
from repro_torch.models.params import count_params, tree_from_items, tree_items
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer

ATOL = 1e-5
BF16_ULP = 2.0 ** -7
B, S = 2, 12
ARCHS = ["mamba2-370m", "zamba2-2.7b", "qwen2-vl-2b", "whisper-medium"]
#: the configs of the model-level tests: the three reduced configs and the
#: hybrid at 4 layers (2 groups).
CASES = ARCHS + ["zamba2-2.7b/G2"]


def _cfgs(case: str):
    arch, _, groups = case.partition("/")
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    if groups:
        jc, tc = (dataclasses.replace(c, n_layers=4) for c in (jc, tc))
    return jc, tc


def _np_params(tc, seed=0) -> dict:
    """Leaf name -> numpy array for ``lm.model_defs(tc)``: the reference's
    init schemes drawn with numpy, the attention projections at 1/sqrt of
    their contraction width (d for ``wq``/``wk``/``wv``, Hq x hd for
    ``wo``)."""
    width = {"wq": tc.d_model, "wk": tc.d_model, "wv": tc.d_model,
             "wo": tc.n_heads * tc.head_dim}
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in tree_items(lm.model_defs(tc)):
        if d.init in ("zeros", "ones"):
            out[name] = np.full(d.shape, float(d.init == "ones"), np.float32)
            continue
        a = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "scaled_fan_in":
            a /= math.sqrt(width.get(name.rsplit("/", 1)[-1], d.shape[-2]))
        else:
            a *= d.scale
        out[name] = a
    return out


def _batches(tc, s=S + 1, seed=0):
    """The same numpy batch for both packages: tokens (B, s), and for the
    VLM patches (B, num_patches, d), for the audio model frames (B,
    encoder_seq, d), of normals times 0.1."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, tc.vocab, (B, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.as_tensor(toks, dtype=torch.int64)}
    extra = {"vlm": ("patches", tc.num_patches),
             "audio": ("frames", tc.encoder_seq)}.get(tc.family)
    if extra:
        name, rows = extra
        x = 0.1 * r.standard_normal((B, rows, tc.d_model)).astype(np.float32)
        jb[name], tb[name] = jnp.asarray(x), torch.as_tensor(x)
    return jb, tb


def _cut(batch, s):
    return {k: (v[:, :s] if k == "tokens" else v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    """Per case: the two configs, the numpy parameters in the reference's
    tree and the port's copy of them."""
    out = {}
    for case in CASES:
        jc, tc = _cfgs(case)
        p = _np_params(tc)
        jp = jax.tree.map(jnp.asarray, tree_from_items(list(p.items())))
        out[case] = (jc, tc, jp, tree_from_items(
            [(n, torch.as_tensor(a)) for n, a in p.items()]))
    return out


def _opts(cache_dtype="float32", **kw):
    return (jlm.TrainOptions(loss="softmax", remat="none", attn_chunk=8,
                             cache_dtype=getattr(jnp, cache_dtype), **kw),
            lm.TrainOptions(loss="softmax", remat="none", attn_chunk=8,
                            cache_dtype=getattr(torch, cache_dtype), **kw))


def _scale_tol(want) -> float:
    return ATOL * max(1.0, float(np.abs(want).max()))


# --------------------------------------------------------------------------
# Configs and parameter trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch):
    for reduce in (False, True):
        jc, tc = jget_config(arch), get_config(arch)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.head_dim, lm.num_groups(tc), lm.layers_per_group(tc)) == (
            jc.head_dim, jlm.num_groups(jc), jlm.layers_per_group(jc))
    assert get_config(arch.replace("-", "_").replace(".", "p")) == get_config(arch)


@pytest.mark.parametrize("case", CASES)
def test_param_tree_is_the_reference_tree(case):
    jc, tc = _cfgs(case)
    want = {n: tuple(a.shape)
            for n, a in _flatten_with_paths(jlm.abstract_params(jc))}
    params = lm.init_params(3, tc, device="cpu")
    assert {n: tuple(a.shape) for n, a in tree_items(params)} == want
    assert count_params(params) == count_params(lm.model_defs(tc))
    if tc.family in ("ssm", "hybrid"):
        m = params["blocks"]["mamba"]
        assert not m["a_log"].any() and not m["dt_bias"].any()
        assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
        assert abs(m["conv_x"].std().item() - 0.2) < 0.02
    assert ("shared" in params) == (tc.family == "hybrid")


# --------------------------------------------------------------------------
# forward_train
# --------------------------------------------------------------------------

HEADS = [("softmax", "fused", "none"), ("heat", "fused", "full"),
         ("heat", "pallas", "full")]


@pytest.mark.parametrize("loss,backend,remat", HEADS)
@pytest.mark.parametrize("case", CASES)
def test_forward_train_loss_and_grads_match_reference(replay, models, case, loss,
                                                      backend, remat):
    """The loss and the gradient of every parameter to 1e-5, with the
    softmax head and the HEAT head on ``fused`` and ``pallas`` (the
    shared-layout kernels' plain versions here, once each) fed the
    reference's draws; ``remat="full"`` checkpoints a layer, or a whole
    hybrid group."""
    jc, tc, jp, _ = models[case]
    jc = dataclasses.replace(jc, heat=dataclasses.replace(jc.heat, backend=backend))
    tc = dataclasses.replace(tc, heat=dataclasses.replace(tc.heat, backend=backend,
                                                          sampler="replay"))
    jopts = jlm.TrainOptions(loss=loss, remat=remat, attn_chunk=8)
    topts = lm.TrainOptions(loss=loss, remat=remat, attn_chunk=8)
    tile = jsam.id_tile_init(jax.random.PRNGKey(1), jc.vocab,
                             jc.heat.tile_size)._replace(
        step=jnp.asarray(jc.heat.refresh_interval - 1, jnp.int32))
    jb, tb = _batches(tc, s=16)
    rng = jax.random.PRNGKey(5)
    (want, _), want_g = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jb, jc, jopts, rng, tile), has_aux=True)(jp)
    if loss == "heat":
        _record_draws(replay, jc, jp["out_embed"], tile, rng)
    items = [(n, torch.as_tensor(a).requires_grad_()) for n, a in _tree(jp).items()]
    for c in (ccl_similarity.SHARED_STATS_LAUNCHES, ccl_similarity.SHARED_BWD_LAUNCHES):
        c.reset()
    got, _ = lm.forward_train(tree_from_items(items), tb, tc, topts, 5,
                              _port_tile(tile))
    grads = torch.autograd.grad(got, [a for _, a in items])
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    want_grads = _tree(want_g)
    assert [n for n, _ in items] == list(want_grads)
    for (name, _), g in zip(items, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name], atol=ATOL,
                                   err_msg=name)
    pallas = loss == "heat" and backend == "pallas"
    assert ccl_similarity.SHARED_STATS_LAUNCHES.count("cpu") == pallas
    assert ccl_similarity.SHARED_BWD_LAUNCHES.count("cpu") == pallas


# --------------------------------------------------------------------------
# prefill, pad_cache, decode_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_reference(models, case):
    """The logits to 1e-5 and every cache leaf to 1e-5 of its largest
    element, with an fp32 and the default bf16 cache: the Mamba caches stay
    in the dtype they were computed in (fp32), as the reference keeps them;
    only K/V takes ``cache_dtype`` (within one bf16 rounding of the
    reference's)."""
    jc, tc, jp, tp = models[case]
    jb, tb = _batches(tc, s=S)
    for dt in ("float32", "bfloat16"):
        jo, to = _opts(dt)
        want, jcache = jlm.prefill(jp, jb, jc, jo)
        got, cache = lm.prefill(tp, tb, tc, to, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        want_c = {n: np.asarray(a, np.float32) for n, a in _tree(jcache).items()}
        got_c = convert.decode_cache_to_numpy(cache)
        assert list(got_c) == list(want_c)
        for name, w in want_c.items():
            tol = _scale_tol(w)
            if dt == "bfloat16" and "kv" in name:
                tol = tol + BF16_ULP * np.abs(w)
            assert np.all(np.abs(got_c[name] - w) <= tol), name
        if cache.mamba is not None:
            assert cache.mamba.conv.dtype == cache.mamba.state.dtype == torch.float32
        for kv in (cache.kv, cache.shared_kv, cache.cross_kv):
            if kv is not None:
                assert kv[0].dtype == kv[1].dtype == getattr(torch, dt)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_decode_step_fed_the_reference_cache_matches(models, case, cache_dtype):
    """The reference's padded prefill cache, carried over by
    ``decode_cache_from_numpy``, into the port's ``decode_step``: the
    logits to 1e-5, and the cache after the step (written in place) equal
    to the reference's updated copy."""
    jc, tc, jp, tp = models[case]
    jb, tb = _batches(tc, seed=1)
    jo, to = _opts(cache_dtype)
    _, jcache = jlm.prefill(jp, _cut(jb, S), jc, jo)
    jcache = jlm.pad_cache(jcache, jc, S + 3)
    want, jnew = jlm.decode_step(jp, jcache, jb["tokens"][:, S:],
                                 jnp.asarray(S, jnp.int32), jc, jo)
    cache = convert.decode_cache_from_numpy(_tree(jcache))
    got, new = lm.decode_step(tp, cache, tb["tokens"][:, S:], S, tc, to,
                              device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert got.shape == (B, 1, tc.vocab)
    for member in ("kv", "mamba", "shared_kv", "cross_kv"):
        assert getattr(new, member) is getattr(cache, member)       # in place
    want_c = {n: np.asarray(a, np.float32) for n, a in _tree(jnew).items()}
    got_c = convert.decode_cache_to_numpy(new)
    assert list(got_c) == list(want_c)
    for name, w in want_c.items():
        tol = _scale_tol(w) + (BF16_ULP * np.abs(w) if cache_dtype == "bfloat16"
                               and "kv" in name else 0)
        assert np.all(np.abs(got_c[name] - w) <= tol), name


@pytest.mark.parametrize("init", ["numpy", "reference"])
@pytest.mark.parametrize("case", CASES)
def test_decode_after_prefill_matches_prefill(models, case, init):
    """The port on its own: decoding token S against the prefilled cache
    equals prefilling S + 1 tokens within the reference's ``rel < 2e-3``
    (fp32 cache), with the test's parameters and with the port's own init
    (the reference's schemes), and two more steps stay finite."""
    jc, tc, _, tp = models[case]
    if init == "reference":
        tp = lm.init_params(0, tc, device="cpu")
    _, tb = _batches(tc, seed=2)
    to = _opts()[1]
    gt, _ = lm.prefill(tp, tb, tc, to, device="cpu")
    _, cache = lm.prefill(tp, _cut(tb, S), tc, to, device="cpu")
    cache = lm.pad_cache(cache, tc, S + 3)
    dl, cache = lm.decode_step(tp, cache, tb["tokens"][:, S:], S, tc, to,
                               device="cpu")
    rel = (gt - dl[:, 0]).abs().max().item() / (gt.abs().max().item() + 1e-9)
    assert rel < 2e-3, rel
    tok = dl[:, 0].argmax(-1)[:, None]
    for i in (1, 2):
        dl, cache = lm.decode_step(tp, cache, tok, S + i, tc, to, device="cpu")
        assert bool(torch.isfinite(dl).all())
        tok = dl[:, 0].argmax(-1)[:, None]
    if tc.family != "ssm":
        with pytest.raises(ValueError, match="outside the cache"):
            lm.decode_step(tp, cache, tok, S + 3, tc, to, device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_pad_cache_and_cache_defs_match_reference(models, case):
    """``pad_cache`` grows the K/V rows (zeros after the prefix) and leaves
    the Mamba cache and the encoder's K/V alone; the padded cache and the
    reference's padded cache have the same names and shapes, and
    ``cache_defs`` the reference's ``cache_defs``' (the same shapes as the
    padded cache; the audio family's ``cross_kv`` is a plain pair after
    prefill and a ``KVCache`` in ``cache_defs``, in both packages)."""
    jc, tc, jp, tp = models[case]
    jb, tb = _batches(tc, s=S)
    jo, to = _opts("bfloat16")
    _, cache = lm.prefill(tp, tb, tc, to, device="cpu")
    _, jcache = jlm.prefill(jp, jb, jc, jo)
    padded = lm.pad_cache(cache, tc, 20)
    want = {n: a.shape for n, a in _tree(jlm.pad_cache(jcache, jc, 20)).items()}
    defs = lm.cache_defs(tc, B, 20)
    got = {n: a.shape for n, a in convert.decode_cache_to_numpy(padded).items()}
    assert got == want
    want_defs = {n: d.shape for n, d in _flatten_with_paths(
        jlm.cache_defs(jc, B, 20))}
    assert {n: d.shape for n, d in _def_names(defs).items()} == want_defs
    assert sorted(want_defs.values()) == sorted(want.values())
    for member in ("mamba", "cross_kv"):
        if getattr(padded, member) is not None:
            assert getattr(padded, member) is getattr(cache, member)
    for kv, before in ((padded.kv, cache.kv), (padded.shared_kv, cache.shared_kv)):
        if kv is not None:
            assert torch.equal(kv.k[:, :, :S], before.k) and not kv.k[:, :, S:].any()


def _def_names(defs) -> dict:
    out = {}
    for member, names in (("kv", ("k", "v")), ("mamba", ("conv", "state")),
                          ("shared_kv", ("k", "v")), ("cross_kv", ("k", "v"))):
        m = getattr(defs, member)
        if m is not None:
            for n in names:
                out[f"{member}/{n}"] = getattr(m, n)
    return out


def test_ssm_cache_does_not_grow_with_the_context():
    """The SSM decode cache at a context of 524,288 holds under 10M
    elements (no term grows with S), as ``tests/test_models.py`` requires
    of the reference; the hybrid's grows only by its G shared K/V rows."""
    tc = get_config("mamba2-370m").reduced()
    total = sum(math.prod(d.shape) for d in _def_names(
        lm.cache_defs(tc, batch=1, seq=524288)).values())
    assert total < 10_000_000
    jtotal = sum(x.size for x in jax.tree.leaves(jabstract(
        jlm.cache_defs(jget_config("mamba2-370m").reduced(), 1, 524288))))
    assert total == jtotal
    hc = get_config("zamba2-2.7b").reduced()
    defs = _def_names(lm.cache_defs(hc, 1, 1024))
    assert defs["shared_kv/k"].shape == (1, 1, 1024, hc.n_kv_heads, hc.head_dim)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_decode_cache_roundtrips_through_convert(models, arch):
    """The reference's Mamba cache (fp32) and shared K/V (bf16 bits) carry
    over by name and back."""
    jc, tc, jp, _ = models[arch]
    jb, _ = _batches(tc, s=S)
    _, jcache = jlm.prefill(jp, jb, jc, _opts("bfloat16")[0])
    want = _tree(jcache)
    cache = convert.decode_cache_from_numpy(want)
    assert cache.kv is None and isinstance(cache.mamba, ssm.MambaCache)
    assert (cache.shared_kv is None) == (arch == "mamba2-370m")
    if cache.shared_kv is not None:
        assert cache.shared_kv.k.dtype == torch.bfloat16
    got = convert.decode_cache_to_numpy(cache)
    assert list(got) == list(want)
    for n in want:
        np.testing.assert_array_equal(got[n], np.asarray(want[n], np.float32))


def test_cross_kv_roundtrips_through_convert_in_both_forms(models):
    """The reference's prefill cache, whose ``cross_kv`` is the plain
    (k, v) pair its scan stacks (``cross_kv/0``, ``cross_kv/1``, bf16
    bits), and its ``cache_defs`` zeros, whose ``cross_kv`` is a
    ``KVCache`` (``cross_kv/k``, ``cross_kv/v``), carry over by name and
    back, each in its own form; the port's prefill gives the pair too."""
    jc, tc, jp, tp = models["whisper-medium"]
    jb, tb = _batches(tc, s=S)
    _, jcache = jlm.prefill(jp, jb, jc, _opts("bfloat16")[0])
    assert type(jcache.cross_kv).__name__ == "tuple"
    zeros = jax.tree.map(lambda d: jnp.zeros(d.shape, jnp.bfloat16),
                         jlm.cache_defs(jc, B, S), is_leaf=lambda x: hasattr(x, "init"))
    for jtree, names in ((jcache, ("0", "1")), (zeros, ("k", "v"))):
        want = _tree(jtree)
        assert [n for n in want if n.startswith("cross_kv")] == [
            f"cross_kv/{n}" for n in names]
        cache = convert.decode_cache_from_numpy(want)
        assert isinstance(cache.cross_kv, layers.KVCache) == (names == ("k", "v"))
        assert cache.cross_kv[0].dtype == torch.bfloat16
        assert cache.cross_kv[0].shape == (tc.n_layers, B, tc.encoder_seq,
                                           tc.n_kv_heads, tc.head_dim)
        got = convert.decode_cache_to_numpy(cache)
        assert list(got) == list(want)
        for n in want:
            np.testing.assert_array_equal(got[n], np.asarray(want[n], np.float32))
    _, cache = lm.prefill(tp, tb, tc, _opts("bfloat16")[1], device="cpu")
    assert type(cache.cross_kv) is tuple and len(cache.cross_kv) == 2


# --------------------------------------------------------------------------
# State interchange, data, the trainer and the CLIs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_state_roundtrips_through_convert(arch):
    jc = jget_config(arch).reduced()
    jstate = jtrainer.init_lm_state(jax.random.PRNGKey(4), jc, jlm.TrainOptions(),
                                    joptim.get_optimizer("adamw"))
    want = _tree(jstate)
    got = convert.lm_state_to_numpy(convert.lm_state_from_numpy(want))
    assert list(got) == list(want)
    for n in want:
        assert got[n].dtype == want[n].dtype, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_lm_batch_extras_are_pure_and_keyed_by_name():
    """Each extra is pure in (seed, step, name) and drawn from its own
    stream: the same name gives the same numbers whatever else is asked
    for, two names differ, and the tokens do not change.  The reference's
    statistics: normals times 0.1."""
    spec = {"patches": ((2, 64, 32), torch.float32)}
    a = pipeline.lm_batch(3, 2, 16, 100, seed=1, extras=spec)
    assert a["patches"].shape == (2, 64, 32) and a["patches"].dtype == torch.float32
    b = pipeline.lm_batch(3, 2, 16, 100, seed=1, extras={
        "other": ((2, 64, 32), torch.float32), **spec})
    assert torch.equal(a["patches"], b["patches"])
    assert not torch.equal(a["patches"], b["other"])
    assert torch.equal(a["tokens"], pipeline.lm_batch(3, 2, 16, 100, seed=1)["tokens"])
    for other in (pipeline.lm_batch(4, 2, 16, 100, seed=1, extras=spec),
                  pipeline.lm_batch(3, 2, 16, 100, seed=2, extras=spec)):
        assert not torch.equal(a["patches"], other["patches"])
    assert abs(a["patches"].std().item() - 0.1) < 0.005
    ref = jpipeline.lm_batch(3, 2, 16, 100, seed=1,
                             extras={"patches": ((2, 64, 32), jnp.float32)})
    assert abs(float(jnp.std(ref["patches"])) - 0.1) < 0.005


def _reduced_pallas(arch):
    tc = get_config(arch).reduced()
    return dataclasses.replace(tc, heat=dataclasses.replace(tc.heat, backend="pallas"))


def test_train_lm_restart_is_bit_identical_on_mamba2(tmp_path):
    """A failure at step 6 healed from the step-4 checkpoint ends on the
    bits of the uninterrupted run (reduced mamba2, HEAT head on
    ``pallas``, tile refreshes every 4 steps)."""
    cfg, opts = _reduced_pallas("mamba2-370m"), lm.TrainOptions(remat="full")
    clean, losses = trainer.train_lm(cfg, opts, _tcfg(), device="cpu",
                                     log=lambda *_: None)
    logs = []
    healed, healed_losses = trainer.train_lm(
        cfg, opts, _tcfg(ckpt_dir=str(tmp_path), fail_at_step=6),
        device="cpu", log=logs.append)
    assert logs == ["[trainer] injected failure at step 6 -> restoring "
                    "latest checkpoint"]
    assert len(losses) == 10 and healed_losses[-4:] == losses[-4:]
    names = []
    for (n, a), (m, b) in zip(ckpt.named_leaves(clean),
                              ckpt.named_leaves(healed), strict=True):
        assert n == m
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), n
        names.append(n)
    assert "params/blocks/mamba/a_log" in names
    assert "opt_state/moments/blocks/mamba/w_x/nu" in names


@pytest.mark.parametrize("arch", ARCHS)
def test_train_lm_trains_each_family_on_cpu(arch):
    """``train_lm`` (with the VLM's patches or the audio model's frames
    from ``extras_spec``) on one fixed batch: finite losses that fall, and
    one shared-stats and one shared-backward launch a step on the
    ``pallas`` head."""
    cfg = _reduced_pallas(arch)
    extras = _extras(cfg, 4)
    for c in (ccl_similarity.SHARED_STATS_LAUNCHES, ccl_similarity.SHARED_BWD_LAUNCHES):
        c.reset()
    _, losses = trainer.train_lm(
        cfg, lm.TrainOptions(loss="softmax", attn_chunk=8),
        _tcfg(steps=12, lr=0.3, fixed_batch=True, optimizer="sgd", batch_size=4),
        extras, device="cpu", log=lambda *_: None)
    assert np.all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0], losses
    _, losses = trainer.train_lm(cfg, lm.TrainOptions(attn_chunk=8),
                                 _tcfg(steps=3, batch_size=4), extras,
                                 device="cpu", log=lambda *_: None)
    assert np.all(np.isfinite(losses))
    assert ccl_similarity.SHARED_STATS_LAUNCHES.count("cpu") == 3
    assert ccl_similarity.SHARED_BWD_LAUNCHES.count("cpu") == 3


def _extras(cfg, b: int):
    """``train_lm``'s ``extras_spec`` of a family: a VLM's patches, an
    audio model's frames (fp32), else None."""
    if cfg.family == "vlm":
        return {"patches": ((b, cfg.num_patches, cfg.d_model), torch.float32)}
    if cfg.family == "audio":
        return {"frames": ((b, cfg.encoder_seq, cfg.d_model), torch.float32)}
    return None


@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_serve_clis_run_each_family_on_cpu(capsys, arch):
    """The train CLI's last line and the serve CLI's three lines (the VLM
    served with zero patches and the audio model with zero frames, as the
    reference's launcher feeds them)."""
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_cli
    train_cli.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
                    "--seq", "16", "--backend", "pallas", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[launch] LM head engine: pallas")
    assert lines[-1].startswith("done: 2 steps, final loss")
    serve.main(["--arch", arch, "--device", "cpu", "--decode-steps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith("prefill: 4x16 tokens in ")
    ids = json.loads(lines[2].split(": ", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 256 for i in ids)


def test_vlm_patches_replace_the_first_embeddings():
    """``embed_inputs`` puts the patch rows in the first P positions; the
    other families ignore a ``patches`` entry."""
    tc = get_config("qwen2-vl-2b").reduced()
    params = lm.init_params(0, tc, device="cpu")
    _, tb = _batches(tc)
    h = lm.embed_inputs(params, tb, tc)
    p = tc.num_patches
    assert torch.equal(h[:, :p], tb["patches"])
    assert torch.equal(h[:, p:], params["embed"][tb["tokens"][:, p:]])
    dense = get_config("smollm-360m").reduced()
    dp = lm.init_params(0, dense, device="cpu")
    assert torch.equal(lm.embed_inputs(dp, tb, dense), dp["embed"][tb["tokens"]])
    assert isinstance(lm.cache_defs(tc, 1, 4).kv, layers.KVCache)
