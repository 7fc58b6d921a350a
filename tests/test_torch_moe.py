"""The port's MoE family against the JAX package: the layer
(``models/moe.py``: routing, capacity, dispatch, combine, with and without
dropped tokens), the MoE stacks in training (moonshot's uniform MoE and
llama4's interleaved dense/MoE groups at their ``reduced()`` configs) and
the MoE state's carry through ``convert.py``.

Inputs are made with numpy from a seed; the HEAT head's negatives replay
the reference's draws as ``tests/test_torch_lm.py`` does.  Tolerance: 1e-5
absolute for fp32 results, the ROADMAP's tolerance.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import (  # noqa: F401  (replay is a fixture)
    _port_tile,
    _record_draws,
    _tree,
    replay,
)

from repro.configs import get_config as jget_config
from repro.core import samplers as jsam
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import optimizers as joptim
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ccl_similarity
from repro_torch.models import lm, moe
from repro_torch.models.params import count_params, tree_from_items, tree_items
from repro_torch.train import trainer

ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the token embedding's gradient, alone, is held to 1e-4: it passes through
#: the first RMSNorm, whose gain at the 0.02-scale init is about 50, and
#: through the near-hard-max attention of the reference's init, so its fp32
#: noise is the largest.  The reference's own eager and jitted gradients of
#: it differ by 9.5e-6 (moonshot) and 9.6e-5 (llama4) on these inputs; the
#: port's differs from the eager one by 1.7e-5 to 2.7e-5, and every other
#: leaf's by at most 1.1e-6.
EMBED_ATOL = 1e-4
MOE = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]


def _x(shape, seed=0, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# Routing and capacity
# --------------------------------------------------------------------------

def test_top_k_breaks_ties_by_the_lower_index_as_lax_top_k():
    """Integer logits with many ties: the same values and expert ids as
    ``jax.lax.top_k``."""
    logits = np.random.default_rng(0).integers(0, 4, (64, 8)).astype(np.float32)
    for k in (1, 2, 6):
        want_v, want_i = jax.lax.top_k(jnp.asarray(logits), k)
        got_v, got_i = moe.top_k_lowest_first(torch.as_tensor(logits), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("t,k,e,cf,want", [
    (8, 6, 64, 1.25, 8),            # a decode step: at least T, dropless
    (2048, 6, 64, 1.25, 256),       # moonshot training, 4 x 512: the 256 floor
    (8192, 6, 64, 1.25, 960),       # moonshot prefill, 8 x 1,024
    (8200, 1, 128, 1.25, 256),      # llama4, top-1 of 128
    (512, 2, 4, 0.25, 256),
    (0, 2, 4, 1.25, 1)])
def test_capacity_is_the_reference_rule(t, k, e, cf, want):
    assert moe.capacity(t, k, e, cf) == want


def _layer(d, f, e, seed=0):
    """One MoE layer's weights at the reference's scaled fan-in."""
    return {"router": _x((d, e), seed) / d ** 0.5,
            "w_gate": _x((e, d, f), seed + 1) / d ** 0.5,
            "w_up": _x((e, d, f), seed + 2) / d ** 0.5,
            "w_down": _x((e, f, d), seed + 3) / f ** 0.5}


def _moe_case(b, s, d, f, e, top_k, cf, seed=0):
    p = _layer(d, f, e, seed)
    x = _x((b, s, d), seed + 9)
    g = _x((b, s, d), seed + 10)                       # cotangent of the output

    def ref(router, w_gate, w_up, w_down, x):
        return jmoe._moe_local(router, w_gate, w_up, w_down, x, top_k=top_k,
                               capacity_factor=cf, shard_idx=0, num_shards=1,
                               axis_name=None)

    names = ("router", "w_gate", "w_up", "w_down")
    args = [jnp.asarray(p[n]) for n in names] + [jnp.asarray(x)]
    want, vjp = jax.vjp(ref, *args)
    want_g = vjp(jnp.asarray(g))
    leaves = [torch.as_tensor(p[n]).requires_grad_() for n in names]
    xt = torch.as_tensor(x).requires_grad_()
    got = moe._moe_local(*leaves, xt, top_k=top_k, capacity_factor=cf)
    got_g = torch.autograd.grad(got, leaves + [xt], torch.as_tensor(g))
    return want, want_g, got, got_g, (p, x)


def _kept(x, router, top_k, cap):
    """Slots the reference keeps: (token-major position in its expert) <
    cap."""
    _, eids = jax.lax.top_k(jnp.asarray(x.reshape(-1, x.shape[-1]) @ router), top_k)
    flat = np.asarray(eids).reshape(-1)
    seen, kept = {}, 0
    for eid in flat:
        kept += seen.get(eid, 0) < cap
        seen[eid] = seen.get(eid, 0) + 1
    return kept, flat.size


@pytest.mark.parametrize("b,s,top_k,cf,drops", [
    (2, 16, 2, 1.25, False),     # small call: cap >= T, dropless
    (2, 256, 2, 0.25, True),     # 512 tokens, cap 256 < the busiest expert
    (4, 8, 1, 1.25, False)])     # top-1 (llama4)
def test_moe_local_forward_and_grads_match_reference(b, s, top_k, cf, drops):
    """Output and the gradients of the router, the three expert stacks and
    x, to 1e-5; the dropping case is checked to drop."""
    d, f, e = 16, 24, 4
    want, want_g, got, got_g, (p, x) = _moe_case(b, s, d, f, e, top_k, cf)
    kept, slots = _kept(x, p["router"], top_k, moe.capacity(b * s, top_k, e, cf))
    assert (kept < slots) == drops, (kept, slots)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    for name, g, w in zip(("router", "w_gate", "w_up", "w_down", "x"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_moe_local_shards_sum_to_the_whole(num_shards):
    """Each shard dispatches only its own experts' slots (with its slice of
    the expert stacks); the parts sum to the one-shard output (the
    reference's ``psum``), including with dropped tokens."""
    d, f, e, top_k, cf = 16, 24, 4, 2, 0.25
    p = {k: torch.as_tensor(v) for k, v in _layer(d, f, e, 3).items()}
    x = torch.as_tensor(_x((2, 256, d), 4))
    whole = moe._moe_local(p["router"], p["w_gate"], p["w_up"], p["w_down"], x,
                           top_k=top_k, capacity_factor=cf)
    e_loc = e // num_shards
    parts = [moe._moe_local(p["router"],
                            *(p[n][i * e_loc:(i + 1) * e_loc]
                              for n in ("w_gate", "w_up", "w_down")), x,
                            top_k=top_k, capacity_factor=cf, shard_idx=i,
                            num_shards=num_shards)
             for i in range(num_shards)]
    np.testing.assert_allclose(sum(parts).numpy(), whole.numpy(), atol=1e-6)


def test_moe_apply_is_the_one_shard_path_and_refuses_a_model_axis(monkeypatch):
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    jc = jget_config("moonshot-v1-16b-a3b").reduced()
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    p = _layer(d, f, e, 5)
    x = _x((2, 8, d), 6)
    want = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    got = moe.moe_apply(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    monkeypatch.setattr(moe.sharding, "model_shards", lambda: 2)
    with pytest.raises(NotImplementedError, match="A.5"):
        moe.moe_apply(tp, torch.as_tensor(x), cfg)


# --------------------------------------------------------------------------
# The MoE stacks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_param_tree_is_the_reference_tree(arch):
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    want = {n: a.shape for n, a in _tree(jlm.init_params(
        jax.random.PRNGKey(0), jc)).items()}
    params = lm.init_params(3, tc, device="cpu")
    got = {n: tuple(a.shape) for n, a in tree_items(params)}
    assert got == want
    assert count_params(params) == count_params(lm.model_defs(tc))
    if tc.moe_every > 1:
        assert set(params["blocks"]) == {"dense", "moe_blk"}
        assert params["blocks"]["moe_blk"]["moe"]["w_gate"].shape[0] == lm.num_groups(tc)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("loss,backend,remat", [("heat", "pallas", "full"),
                                                ("heat", "fused", "none"),
                                                ("softmax", "fused", "none")])
def test_forward_train_moe_loss_and_grads_match_reference(replay, arch, loss,
                                                          backend, remat):
    """``forward_train`` of the MoE stacks with both heads: the loss and
    the gradient of every parameter to 1e-5 (the embedding's to
    :data:`EMBED_ATOL`), the HEAT head fed the
    reference's draws (its ``pallas`` backend: the shared-layout kernels'
    plain versions here, once a step)."""
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    jc = dataclasses.replace(jc, heat=dataclasses.replace(jc.heat, backend=backend))
    tc = dataclasses.replace(tc, heat=dataclasses.replace(tc.heat, backend=backend,
                                                          sampler="replay"))
    jopts = jlm.TrainOptions(loss=loss, remat=remat, attn_chunk=8)
    topts = lm.TrainOptions(loss=loss, remat=remat, attn_chunk=8)
    params = jlm.init_params(jax.random.PRNGKey(0), jc)
    tile = jsam.id_tile_init(jax.random.PRNGKey(1), jc.vocab,
                             jc.heat.tile_size)._replace(
        step=jnp.asarray(jc.heat.refresh_interval - 1, jnp.int32))
    tokens = np.random.default_rng(0).integers(0, jc.vocab, (2, 16)).astype(np.int32)
    rng = jax.random.PRNGKey(5)
    (want, _), want_g = jax.value_and_grad(
        lambda p: jlm.forward_train(p, {"tokens": jnp.asarray(tokens)}, jc,
                                    jopts, rng, tile), has_aux=True)(params)
    if loss == "heat":
        _record_draws(replay, jc, params["out_embed"], tile, rng)
    items = [(n, torch.as_tensor(a).requires_grad_())
             for n, a in _tree(params).items()]
    ccl_similarity.SHARED_BWD_LAUNCHES.reset()
    got, _ = lm.forward_train(tree_from_items(items),
                              {"tokens": torch.as_tensor(tokens, dtype=torch.int64)},
                              tc, topts, 5, _port_tile(tile))
    grads = torch.autograd.grad(got, [a for _, a in items])
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    want_grads = _tree(want_g)
    assert [n for n, _ in items] == list(want_grads)
    errs = {name: float(np.abs(g.numpy() - want_grads[name]).max())
            for (name, _), g in zip(items, grads)}
    for name, err in errs.items():
        assert err <= (EMBED_ATOL if name == "embed" else ATOL), (name, err)
    assert ccl_similarity.SHARED_BWD_LAUNCHES.count("cpu") == (
        loss == "heat" and backend == "pallas")


@pytest.mark.parametrize("arch", MOE)
def test_moe_state_roundtrips_through_convert(arch):
    """The reference's AdamW state of an MoE model carries over by name and
    back, bit for bit (the interleaved stacks' ``dense``/``moe_blk`` names
    included)."""
    jc = jget_config(arch).reduced()
    jstate = jtrainer.init_lm_state(jax.random.PRNGKey(4), jc, jlm.TrainOptions(),
                                    joptim.get_optimizer("adamw"))
    want = _tree(jstate)
    assert any("/moe/w_gate" in n for n in want)
    got = convert.lm_state_to_numpy(convert.lm_state_from_numpy(want))
    assert list(got) == list(want)
    for n in want:
        assert got[n].dtype == want[n].dtype, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_train_lm_trains_the_moe_stacks_on_cpu():
    """``train_lm`` and the CLI's ``--arch`` take the MoE configs: finite
    losses, and one shared-stats and one shared-backward launch a step on
    the ``pallas`` head."""
    for arch in MOE:
        cfg = get_config(arch).reduced()
        cfg = dataclasses.replace(cfg, heat=dataclasses.replace(cfg.heat,
                                                                backend="pallas"))
        for c in (ccl_similarity.SHARED_STATS_LAUNCHES,
                  ccl_similarity.SHARED_BWD_LAUNCHES):
            c.reset()
        _, losses = trainer.train_lm(
            cfg, lm.TrainOptions(attn_chunk=8),
            trainer.TrainerConfig(steps=3, lr=1e-2, batch_size=2, seq_len=16,
                                  log_every=0), device="cpu", log=lambda *_: None)
        assert len(losses) == 3 and np.all(np.isfinite(losses)), losses
        assert ccl_similarity.SHARED_STATS_LAUNCHES.count("cpu") == 3
        assert ccl_similarity.SHARED_BWD_LAUNCHES.count("cpu") == 3
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "llama4-maverick-400b-a17b", "--reduced",
                        "--steps", "2", "--device", "cpu"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1].startswith("done: 2 steps, final loss")
