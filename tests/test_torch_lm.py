"""The port's LM training path against the JAX package, at
``get_config("smollm-360m").reduced()`` (2 layers, d=64, 4 heads, 2 KV
heads, vocab 256).

The reference's initial parameters and tile are carried into the port with
``convert.py``; tokens are made with numpy from a seed.  The port cannot
reproduce JAX's threefry draws, so the HEAT head's negatives come from a
replay sampler registered for the test, loaded with the ids the reference's
tile sampler drew from the same key, and tile refreshes replay the
reference's new tile ids through ``samplers.sample_unique``.  The JAX side's
``pallas`` backend runs its Pallas kernels in interpret mode; the port runs
the kernels' plain versions on these CPU tensors.  Tolerance: 1e-5 absolute
in fp32, the ROADMAP's tolerance for fp32 results; restarts within the port
are held bit for bit.
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

from repro.configs import get_config as jget_config
from repro.core import engine as jeng
from repro.core import samplers as jsam
from repro.data import pipeline as jpipeline
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import optimizers as joptim
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro.train.checkpoint import _flatten_with_paths
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import engine as teng
from repro_torch.core import samplers as tsam
from repro_torch.core import tiling
from repro_torch.data import pipeline
from repro_torch.kernels import ccl_similarity
from repro_torch.models import layers, lm
from repro_torch.models.params import count_params, tree_from_items, tree_items
from repro_torch.optim import optimizers
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer

ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def _cfgs(**heat):
    jc = jget_config("smollm-360m").reduced()
    tc = get_config("smollm-360m").reduced()
    if heat:
        jc = dataclasses.replace(jc, heat=dataclasses.replace(jc.heat, **heat))
        tc = dataclasses.replace(tc, heat=dataclasses.replace(tc.heat, **heat))
    return jc, tc


def _tree(jtree) -> dict:
    return {name: np.array(leaf) for name, leaf in _flatten_with_paths(jtree)}


def _tokens(seed=0, b=B, s=S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


class ReplaySampler:
    """Returns, call by call, the draws it was loaded with (ids and tile
    slots), gathering rows through the live table."""

    name = "replay"

    def __init__(self):
        self.draws = []

    def sample(self, state, gen, shape):
        ids, local = self.draws.pop(0)
        assert tuple(ids.shape) == tuple(shape)
        return teng.NegSample(ids, tiling.gather_rows(state.table, ids), state,
                              local_idx=local)


@pytest.fixture
def replay(monkeypatch):
    """A replay sampler registered as ``replay``, and ``sample_unique``
    replaying the reference's refreshed tile ids."""
    sampler = ReplaySampler()
    sampler.refreshes = []
    teng.register_sampler("replay")(sampler)
    monkeypatch.setattr(tsam, "sample_unique",
                        lambda gen, num, n: sampler.refreshes.pop(0))
    yield sampler
    del teng.SAMPLERS["replay"]
    assert not sampler.draws and not sampler.refreshes, "a draw was not replayed"


def _record_draws(sampler, jcfg, table, tile, rng):
    """Load ``sampler`` with the reference head's draw (and refresh) for
    ``rng`` and return the reference's tile after the step."""
    r_neg, r_tile = jax.random.split(rng)
    drawn = jeng.SAMPLERS["tile"].sample(
        jeng.SampleContext(table=table, tile=tile), r_neg,
        (jcfg.heat.num_negatives,))
    sampler.draws.append((torch.as_tensor(np.array(drawn.ids), dtype=torch.int64),
                          torch.as_tensor(np.array(drawn.local_idx),
                                          dtype=torch.int64)))
    new = jsam.tile_refresh(tile, r_tile, table, jcfg.heat.refresh_interval)
    if int(new.step) == 0:
        sampler.refreshes.append(torch.as_tensor(np.array(new.tile_ids),
                                                 dtype=torch.int64))
    return new


def _port_tile(jtile):
    return tsam.TileState(torch.as_tensor(np.array(jtile.tile_ids),
                                          dtype=torch.int64), None,
                          int(jtile.step))


# --------------------------------------------------------------------------
# Configs and parameters
# --------------------------------------------------------------------------

def test_config_is_the_reference_config():
    for reduce in (False, True):
        jc, tc = jget_config("smollm-360m"), get_config("smollm-360m")
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.head_dim == jc.head_dim
    full = get_config("smollm-360m")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab) == (32, 960, 15, 5, 64, 2560,
                                                      49152)
    assert get_config("smollm_360m") == full
    with pytest.raises(ValueError, match="waits"):
        get_config("mamba2-370m")
    with pytest.raises(ValueError, match="unknown"):
        get_config("no-such-model")


@pytest.mark.parametrize("mlp_kind", ["swiglu", "gelu"])
def test_param_tree_is_the_reference_tree(mlp_kind):
    jc, tc = _cfgs()
    jc = dataclasses.replace(jc, mlp_kind=mlp_kind)
    tc = dataclasses.replace(tc, mlp_kind=mlp_kind)
    want = {n: a.shape for n, a in _tree(jlm.init_params(
        jax.random.PRNGKey(0), jc)).items()}
    params = lm.init_params(7, tc, device="cpu")
    got = {n: tuple(a.shape) for n, a in tree_items(params)}
    assert got == want
    assert count_params(params) == count_params(lm.model_defs(tc)) \
        == sum(int(np.prod(s)) for s in want.values())
    assert torch.equal(params["final_norm"], torch.ones(tc.d_model))
    assert abs(params["embed"].std().item() - 0.02) < 0.002
    wq = params["blocks"]["attn"]["wq"]          # fan-in: the second-to-last dim,
    assert abs(wq.std().item() * wq.shape[-2] ** 0.5 - 1.0) < 0.1  # as in the reference
    again = lm.init_params(7, tc, device="cpu")
    assert all(torch.equal(a, again_a) for (_, a), (_, again_a)
               in zip(tree_items(params), tree_items(again)))


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rms_norm_and_rope_match_reference():
    x, scale = _x((2, 5, 16)), _x((16,), 1)
    np.testing.assert_allclose(
        layers.rms_norm(torch.as_tensor(x), torch.as_tensor(scale)).numpy(),
        np.asarray(jlayers.rms_norm(x, scale)), atol=ATOL)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    cos, sin = layers.rope_cos_sin(torch.as_tensor(pos), 8, 10000.0)
    jcos, jsin = jlayers.rope_cos_sin(jnp.asarray(pos), 8, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=ATOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=ATOL)
    q = _x((2, 5, 3, 8), 2)
    np.testing.assert_allclose(
        layers.apply_rope(torch.as_tensor(q), cos, sin).numpy(),
        np.asarray(jlayers.apply_rope(q, jcos, jsin)), atol=ATOL)


@pytest.mark.parametrize("mlp_kind", ["swiglu", "gelu"])
def test_mlp_matches_reference(mlp_kind):
    jc, tc = _cfgs()
    jc = dataclasses.replace(jc, mlp_kind=mlp_kind)
    tc = dataclasses.replace(tc, mlp_kind=mlp_kind)
    p = {k: _x(d.shape, i) / d.shape[0] ** 0.5     # the scaled fan-in init
         for i, (k, d) in enumerate(sorted(layers.mlp_defs(tc, 0).items()))}
    x = _x((2, 5, tc.d_model), 9)
    want = jlayers.mlp_apply(p, x, jc)
    got = layers.mlp_apply({k: torch.as_tensor(v) for k, v in p.items()},
                           torch.as_tensor(x), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [16, 6])
def test_chunked_attention_matches_reference(causal, chunk):
    q, k, v = _x((2, 16, 4, 8), 0), _x((2, 16, 2, 8), 1), _x((2, 16, 2, 8), 2)
    want = jlayers.chunked_attention(q, k, v, causal=causal, chunk=chunk)
    got = layers.chunked_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                   causal=causal, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_attn_block_matches_reference():
    jc, tc = _cfgs()
    # Weights at 1/sqrt of each projection's contraction width, so the
    # softmax is not near one-hot: at the reference's init (wq's fan-in is
    # Hq) the logits are of order 16 and the attention nearly hard-max.
    width = {"wq": tc.d_model, "wk": tc.d_model, "wv": tc.d_model,
             "wo": tc.n_heads * tc.head_dim}
    p = {k: _x(d.shape, i) / width[k] ** 0.5
         for i, (k, d) in enumerate(sorted(layers.attn_defs(tc, 0).items()))}
    x = _x((2, 16, tc.d_model), 5)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    jcos, jsin = jlayers.rope_cos_sin(jnp.asarray(pos), jc.head_dim,
                                      jc.rope_theta)
    want, _ = jlayers.attn_apply(p, x, jcos, jsin, jc, attn_chunk=8)
    cos, sin = layers.rope_cos_sin(torch.as_tensor(pos), tc.head_dim,
                                   tc.rope_theta)
    got, _ = layers.attn_apply({k: torch.as_tensor(v) for k, v in p.items()},
                               torch.as_tensor(x), cos, sin, tc, attn_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# --------------------------------------------------------------------------
# forward_train, one step, the optimizers
# --------------------------------------------------------------------------

CASES = [("heat", "fused", "full"), ("heat", "autodiff", "none"),
         ("heat", "pallas", "full"), ("heat", "pallas", "none"),
         ("softmax", "fused", "none")]


@pytest.mark.parametrize("loss,backend,remat", CASES)
def test_forward_train_loss_and_grads_match_reference(replay, loss, backend,
                                                      remat):
    jc, tc = _cfgs(backend=backend)
    tc = dataclasses.replace(tc, heat=dataclasses.replace(tc.heat,
                                                          sampler="replay"))
    jopts = jlm.TrainOptions(loss=loss, remat=remat, attn_chunk=8)
    topts = lm.TrainOptions(loss=loss, remat=remat, attn_chunk=8)
    params = jlm.init_params(jax.random.PRNGKey(0), jc)
    tile = jsam.id_tile_init(jax.random.PRNGKey(1), jc.vocab,
                             jc.heat.tile_size)._replace(
        step=jnp.asarray(jc.heat.refresh_interval - 1, jnp.int32))
    batch = {"tokens": jnp.asarray(_tokens())}
    rng = jax.random.PRNGKey(5)
    (want, want_tile), want_g = jax.value_and_grad(
        lambda p: jlm.forward_train(p, batch, jc, jopts, rng, tile),
        has_aux=True)(params)
    if loss == "heat":
        _record_draws(replay, jc, params["out_embed"], tile, rng)

    items = [(n, torch.as_tensor(a).requires_grad_())
             for n, a in _tree(params).items()]
    ccl_similarity.SHARED_BWD_LAUNCHES.reset()
    got, got_tile = lm.forward_train(
        tree_from_items(items),
        {"tokens": torch.as_tensor(_tokens(), dtype=torch.int64)}, tc, topts,
        5, _port_tile(tile))
    grads = torch.autograd.grad(got, [a for _, a in items])
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    want_grads = _tree(want_g)
    assert [n for n, _ in items] == list(want_grads)
    for (name, _), g in zip(items, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name], atol=ATOL,
                                   err_msg=name)
    if loss == "heat":
        assert ccl_similarity.SHARED_BWD_LAUNCHES.count("cpu") == (
            backend == "pallas")
        assert got_tile.step == int(want_tile.step) == 0    # refreshed
        np.testing.assert_array_equal(got_tile.tile_ids.numpy(),
                                      np.asarray(want_tile.tile_ids))
    else:
        assert got_tile.step == int(want_tile.step)


#: the reference trainer tests' learning rate.  At init the gradient of the
#: 0.02-scale embedding passes through RMSNorm (1/rms ~ 50) and the
#: attention logits are large (the fan-in of ``wq`` is Hq, as the reference
#: initializes it), so two fp32 orderings of the same gradient differ by a
#: few 1e-5 on ``embed``: the reference's own eager and jitted gradients
#: differ by 3.3e-5 there at ``PRNGKey(0)``.  The step moves a parameter by
#: ``LR`` times that.
LR = 1e-2


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_sgd_step_matches_reference(replay, grad_accum):
    jc, tc = _cfgs(backend="pallas")
    tc = dataclasses.replace(tc, heat=dataclasses.replace(tc.heat,
                                                          sampler="replay"))
    opts = dict(loss="heat", remat="full", attn_chunk=8)
    jopt = joptim.get_optimizer("sgd")
    jstate = jtrainer.init_lm_state(jax.random.PRNGKey(2), jc,
                                    jlm.TrainOptions(**opts), jopt)
    jstate = jstate._replace(tile=jstate.tile._replace(
        step=jnp.asarray(2, jnp.int32)))
    tokens = _tokens(seed=3, b=4)
    rng = jax.random.PRNGKey(8)
    table, tile = jstate.params["out_embed"], jstate.tile
    for i in range(grad_accum):
        tile = _record_draws(replay, jc, table, tile,
                             rng if grad_accum == 1 else jax.random.fold_in(rng, i))
    step = jtrainer.make_lm_train_step_raw(jc, jlm.TrainOptions(**opts), jopt,
                                           LR, grad_accum)
    want_state, want_loss = step(jstate, {"tokens": jnp.asarray(tokens)}, rng)

    state = convert.lm_state_from_numpy(_tree(jstate))
    port_step = trainer.make_lm_train_step_raw(
        tc, lm.TrainOptions(**opts), optimizers.get_optimizer("sgd"), LR,
        grad_accum)
    got_state, got_loss = port_step(
        state, {"tokens": torch.as_tensor(tokens, dtype=torch.int64)}, 8)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), atol=ATOL)
    got, want = convert.lm_state_to_numpy(got_state), _tree(want_state)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=ATOL,
                                   err_msg=name)


def _opt_inputs(seed=0):
    r = np.random.default_rng(seed)
    shapes = {"a": (4, 5), "b": {"c": (3,), "d": (2, 2, 3)}}

    def make(scale=1.0, positive=False):
        def leaf(shape):
            x = scale * r.standard_normal(shape).astype(np.float32)
            return np.abs(x) if positive else x
        return jax.tree.map(leaf, shapes, is_leaf=lambda x: isinstance(x, tuple))
    return make(), make(0.1), make(0.01), make(0.001, positive=True)


@pytest.mark.parametrize("name,kw", [("adamw", {}),
                                     ("adamw", {"weight_decay": 0.01}),
                                     ("sgd", {}), ("sgd", {"momentum": 0.9})])
def test_optimizer_update_matches_reference(name, kw):
    params, grads, mu, nu = _opt_inputs()
    jopt, topt = joptim.get_optimizer(name, **kw), optimizers.get_optimizer(
        name, **kw)

    def port(tree):
        return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)

    count = 3
    if name == "adamw":
        jmom = jax.tree.map(joptim.AdamMoments, mu, nu)
        tmom = jax.tree.map(lambda m, v: optimizers.AdamMoments(
            torch.as_tensor(m), torch.as_tensor(v)), mu, nu)
    elif kw:
        jmom, tmom = mu, port(mu)
    else:
        jmom = tmom = None
    jstate = joptim.OptState(jmom, jnp.asarray(count, jnp.int32))
    tstate = optimizers.OptState(tmom, torch.tensor(count, dtype=torch.int32))
    want_p, want_s = jopt.update(grads, jstate, params, 0.05)
    got_p, got_s = topt.update(port(grads), tstate, port(params), 0.05)
    for got_tree, want_tree in ((got_p, want_p), (got_s, want_s)):
        want = _tree(want_tree)
        got = {n: ckpt.leaf_to_numpy(x)
               for n, x in ckpt.named_leaves(got_tree)}
        assert list(got) == list(want)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], atol=ATOL, err_msg=n)
    fresh = topt.init(port(params))
    assert int(fresh.count) == 0 and fresh.count.dtype == torch.int32
    with pytest.raises(ValueError, match="waits"):
        optimizers.get_optimizer("adafactor")


# --------------------------------------------------------------------------
# Data, state interchange, the trainer
# --------------------------------------------------------------------------

def test_lm_batch_is_pure_in_seed_and_step():
    a = pipeline.lm_batch(5, 8, 256, 100, seed=1)["tokens"]
    assert a.shape == (8, 256) and a.dtype == torch.int64
    assert torch.equal(a, pipeline.lm_batch(5, 8, 256, 100, seed=1)["tokens"])
    assert not torch.equal(a, pipeline.lm_batch(6, 8, 256, 100, seed=1)["tokens"])
    assert not torch.equal(a, pipeline.lm_batch(5, 8, 256, 100, seed=2)["tokens"])
    assert int(a.min()) >= 0 and int(a.max()) < 100
    # Token t equals token t-1 when t copies base[t-1] and t-1 does not
    # (1/4), or by chance (about 1/V): the reference's statistic.
    copies = (a[:, 1:] == a[:, :-1]).float().mean().item()
    ref = jpipeline.lm_batch(5, 8, 256, 100, seed=1)["tokens"]
    ref_copies = float(np.mean(np.asarray(ref[:, 1:] == ref[:, :-1])))
    assert abs(copies - 0.2575) < 0.03 and abs(ref_copies - 0.2575) < 0.03


def test_lm_state_roundtrips_through_convert():
    jc, _ = _cfgs()
    for opt in ("adamw", "sgd"):
        jstate = jtrainer.init_lm_state(
            jax.random.PRNGKey(4), jc, jlm.TrainOptions(),
            joptim.get_optimizer(opt))
        want = _tree(jstate)
        state = convert.lm_state_from_numpy(want)
        assert state.tile.tile_ids.dtype == torch.int64
        assert isinstance(state.step, int) and isinstance(state.tile.step, int)
        got = convert.lm_state_to_numpy(state)
        assert list(got) == list(want)
        for n in want:
            assert got[n].dtype == want[n].dtype, n
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def _tcfg(**kw):
    base = dict(steps=10, lr=1e-2, batch_size=2, seq_len=16, log_every=0,
                ckpt_every=4, steps_per_dispatch=3)
    base.update(kw)
    return trainer.TrainerConfig(**base)


def _reduced_pallas():
    _, tc = _cfgs(backend="pallas")
    return tc


def test_train_lm_restart_is_bit_identical(tmp_path):
    """A failure at step 6 healed from the step-4 checkpoint ends on the
    bits of the uninterrupted run (across tile refreshes every 4 steps)."""
    cfg, opts = _reduced_pallas(), lm.TrainOptions(remat="full", attn_chunk=8)
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
    assert "tile/tile_ids" in names and "opt_state/moments/embed/nu" in names
    assert clean.step == 10 and int(clean.opt_state.count) == 10
    # A run resumed from the last checkpoint of another also ends there.
    resumed, _ = trainer.train_lm(cfg, opts, _tcfg(ckpt_dir=str(tmp_path)),
                                  device="cpu", log=logs.append)
    assert logs[-1] == "[trainer] resumed from step 8"
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_items(resumed.params), tree_items(clean.params)))


def test_lm_checkpoint_restores_in_the_reference(tmp_path):
    cfg, opts = _reduced_pallas(), lm.TrainOptions(attn_chunk=8)
    state, _ = trainer.train_lm(cfg, opts, _tcfg(steps=4, ckpt_dir=str(tmp_path)),
                                device="cpu", log=lambda *_: None)
    jc, _ = _cfgs(backend="pallas")
    target = jtrainer.init_lm_state(jax.random.PRNGKey(0), jc,
                                    jlm.TrainOptions(),
                                    joptim.get_optimizer("adamw"))
    restored, step, _ = jckpt.restore(str(tmp_path), target)
    assert step == 4
    want = convert.lm_state_to_numpy(state)
    got = _tree(restored)
    assert list(got) == list(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_train_lm_learns_a_fixed_batch():
    cfg, opts = _reduced_pallas(), lm.TrainOptions(loss="softmax",
                                                   attn_chunk=8)
    _, losses = trainer.train_lm(
        cfg, opts, _tcfg(steps=25, lr=0.3, fixed_batch=True, optimizer="sgd",
                         batch_size=4), device="cpu", log=lambda *_: None)
    assert losses[-1] < 0.7 * losses[0], losses


def test_lm_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = _reduced_pallas()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train_lm(cfg, lm.TrainOptions(), _tcfg(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.init_lm_state(0, cfg, lm.TrainOptions(),
                              optimizers.get_optimizer("sgd"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "smollm-360m", "--reduced", "--steps", "2"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120,
                       env=_env())
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_cli_trains_the_reduced_lm_on_cpu():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "smollm-360m", "--reduced", "--steps", "3",
                        "--backend", "pallas", "--remat", "full",
                        "--device", "cpu"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300,
                       env=_env())
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("[launch] LM head engine: pallas+scatter_add+auto")
    assert lines[-1].startswith("done: 3 steps, final loss")
    bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", "qwen2-vl-2b", "--device", "cpu"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env=_env())
    assert bad.returncode != 0 and "waits" in bad.stderr
