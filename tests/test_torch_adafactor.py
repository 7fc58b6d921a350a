"""The port's Adafactor (``optim/optimizers.py::make_adafactor``) against the
JAX package's.

The same numpy parameters, gradients and moments go through both
packages' ``update``: three steps on leaves of every kind the models hold
(rank 1, rank 2, a stacked norm (L, d), rank 3, rank 4, and shapes whose
last dimension is 1, which keep a full second moment), with and without
``bf16_step``, parameters and moments to 1e-5.  Leaves of rank 3 or more
take the port's two-pass sliced update, held to the one-pass form at 1e-6
(they differ only in the order of the clipping norm's sum).  Whole LM
steps (reduced smollm-360m and reduced whisper-medium, numpy parameters
with the attention projections at 1/sqrt of their contraction width, the
HEAT head on ``pallas`` fed the reference's draws) are held to the
reference's step on the loss and every parameter and moment at 1e-5; an
Adafactor run healed from a checkpoint ends on the uninterrupted run's
bits, and its checkpoint restores in the reference.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_families import _batches, _np_params
from test_torch_lm import (  # noqa: F401  (replay is a fixture)
    _record_draws,
    _tcfg,
    _tree,
    replay,
)

from repro.configs import get_config as jget_config
from repro.core import samplers as jsam
from repro.models import lm as jlm
from repro.models.params import abstract as jabstract
from repro.optim import optimizers as joptim
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ccl_similarity
from repro_torch.models import lm
from repro_torch.models.params import tree_from_items, tree_items
from repro_torch.optim import optimizers
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer

ATOL = 1e-5
SLICED_ATOL = 1e-6
#: leaf name -> shape: every kind of leaf the LMs hold.
SHAPES = {"rank1": (7,), "rank2": (6, 5), "stacked_norm": (3, 8),
          "rank3": (3, 4, 6), "rank4": (2, 5, 3, 4), "last_dim_1": (4, 1),
          "rank3_last_dim_1": (3, 5, 1)}


def _leaves(seed: int, scale: float = 1.0) -> dict:
    r = np.random.default_rng(seed)
    return {n: (scale * r.standard_normal(s)).astype(np.float32)
            for n, s in SHAPES.items()}


def _port(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _named(tree) -> dict:
    return {n: ckpt.leaf_to_numpy(x) for n, x in ckpt.named_leaves(tree)}


@pytest.mark.parametrize("bf16_step", [False, True])
def test_update_matches_reference_over_three_steps(bf16_step):
    """Parameters and moments after each of three steps to 1e-5, every
    leaf kind: the factored moments of (L, d), rank 3 and rank 4 leaves
    over their last two dimensions, full ``v`` for rank 1 and last-dim-1
    leaves, and with ``bf16_step`` the step and ``lr`` rounded to bf16."""
    jopt = joptim.get_optimizer("adafactor", bf16_step=bf16_step)
    topt = optimizers.get_optimizer("adafactor", bf16_step=bf16_step)
    jp = {n: jnp.asarray(a) for n, a in _leaves(0).items()}
    tp = _port(jp)
    js, ts = jopt.init(jp), topt.init(tp)
    assert _tree(js).keys() == _named(ts).keys()
    for step in range(3):
        g = _leaves(10 + step, scale=0.1)
        jp, js = jopt.update({n: jnp.asarray(a) for n, a in g.items()}, js, jp,
                             1e-3)
        tp, ts = topt.update({n: torch.as_tensor(a) for n, a in g.items()}, ts,
                             tp, 1e-3)
        for got_tree, want_tree in ((tp, jp), (ts, js)):
            want, got = _tree(want_tree), _named(got_tree)
            assert list(got) == list(want)
            for n in want:
                np.testing.assert_allclose(got[n], want[n], atol=ATOL,
                                           err_msg=f"step {step}: {n}")
    assert int(ts.count) == 3 and ts.count.dtype == torch.int32
    fm = ts.moments
    assert fm["rank4"].vr.shape == (2, 5, 3) and fm["rank4"].vc.shape == (2, 5, 4)
    assert fm["stacked_norm"].vr.shape == (3,) and fm["stacked_norm"].vc.shape == (8,)
    for n in ("rank1", "last_dim_1", "rank3_last_dim_1"):
        assert fm[n].vr is None and fm[n].v.shape == SHAPES[n]


@settings(max_examples=20, deadline=None)
@given(lead=st.integers(1, 5), mid=st.integers(1, 4), rows=st.integers(1, 6),
       cols=st.integers(1, 6), rank4=st.booleans(), bf16_step=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_sliced_update_matches_the_one_pass_form(lead, mid, rows, cols, rank4,
                                                 bf16_step, seed):
    """The two-pass sliced update of a leaf of rank 3 or 4 (factored or
    not) against the one-pass form on the same inputs, parameters and
    moments to 1e-6, after a first step so the moments are not zeros."""
    shape = (lead, mid, rows, cols) if rank4 else (lead, rows, cols)
    r = np.random.default_rng(seed)
    p0 = r.standard_normal(shape).astype(np.float32)
    grads = [(0.1 * r.standard_normal(shape)).astype(np.float32) for _ in range(2)]
    results = []
    for leaf in (optimizers._adafactor_leaf, optimizers._adafactor_leaf_sliced):
        p = torch.as_tensor(p0.copy())
        fm = optimizers.make_adafactor().init({"w": p}).moments["w"]
        for g in grads:
            fm = leaf(p, torch.as_tensor(g), fm, 1e-2, 0.99, 1e-30, 1.0,
                      bf16_step)
        results.append([p] + [m for m in fm if m is not None])
    for a, b in zip(*results, strict=True):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=SLICED_ATOL)


def test_factored_state_is_sublinear_and_counts_as_the_reference():
    """As ``tests/test_optim.py``: a (512, 512) leaf keeps 2 x 512 moment
    elements; granite-8b's factored state (over the port's
    ``model_defs``) has the reference's element count, 70.7M fp32 values
    (0.28 GB) against 8.25B parameters."""
    state = optimizers.get_optimizer("adafactor").init({"w": torch.zeros(512, 512)})
    assert sum(x.numel() for _, x in ckpt.named_leaves(state.moments)) <= 2 * 512 + 4
    cfg = get_config("granite-8b")
    meta = tree_from_items([(n, torch.empty(d.shape, device="meta"))
                            for n, d in tree_items(lm.model_defs(cfg))])
    moments = optimizers.make_adafactor().init(meta).moments
    got = sum(x.numel() for _, x in ckpt.named_leaves(moments))
    jdefs = jlm.model_defs(jget_config("granite-8b"))
    want = sum(x.size for x in jax.tree.leaves(jabstract(
        joptim.make_adafactor().state_defs(jdefs).moments)))
    assert got == want
    assert 70.0e6 < got < 71.0e6
    assert sum(math.prod(d.shape) for _, d in tree_items(lm.model_defs(cfg))) > 8.2e9


def _cfgs(arch: str):
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    jc = dataclasses.replace(jc, heat=dataclasses.replace(jc.heat, backend="pallas"))
    tc = dataclasses.replace(tc, heat=dataclasses.replace(tc.heat, backend="pallas",
                                                          sampler="replay"))
    return jc, tc


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-medium"])
def test_lm_step_matches_reference(replay, arch):
    """One ``make_lm_train_step_raw`` step under Adafactor from a state
    carried over by ``convert`` (whisper's batch with its frames), the HEAT
    head's negatives replayed: the loss, every parameter and every moment
    (``vr``/``vc``, and ``v`` of the final norms) to 1e-5, and one launch
    of each shared-layout kernel's plain version."""
    jc, tc = _cfgs(arch)
    opts = dict(loss="heat", remat="full", attn_chunk=8)
    jopt = joptim.get_optimizer("adafactor")
    jp = jax.tree.map(jnp.asarray, tree_from_items(list(_np_params(tc).items())))
    tile = jsam.id_tile_init(jax.random.PRNGKey(1), jc.vocab,
                             jc.heat.tile_size)._replace(step=jnp.asarray(2, jnp.int32))
    jstate = jtrainer.LMTrainState(jp, jopt.init(jp), tile, jnp.asarray(0, jnp.int32))
    jb, tb = _batches(tc, s=16, seed=3)
    rng = jax.random.PRNGKey(8)
    _record_draws(replay, jc, jp["out_embed"], tile, rng)
    step = jtrainer.make_lm_train_step_raw(jc, jlm.TrainOptions(**opts), jopt, 1e-2)
    want_state, want_loss = step(jstate, jb, rng)

    state = convert.lm_state_from_numpy(_tree(jstate))
    assert isinstance(state.opt_state.moments["final_norm"], optimizers.FactoredMoment)
    for c in (ccl_similarity.SHARED_STATS_LAUNCHES, ccl_similarity.SHARED_BWD_LAUNCHES):
        c.reset()
    port_step = trainer.make_lm_train_step_raw(
        tc, lm.TrainOptions(**opts), optimizers.get_optimizer("adafactor"), 1e-2)
    got_state, got_loss = port_step(state, tb, 8)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), atol=ATOL)
    got, want = convert.lm_state_to_numpy(got_state), _tree(want_state)
    assert list(got) == list(want)
    assert "opt_state/moments/blocks/attn/wq/vr" in want
    assert "opt_state/moments/final_norm/v" in want
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, err_msg=name)
    assert ccl_similarity.SHARED_STATS_LAUNCHES.count("cpu") == 1
    assert ccl_similarity.SHARED_BWD_LAUNCHES.count("cpu") == 1


def test_restart_is_bit_identical_and_restores_in_the_reference(tmp_path):
    """Reduced whisper under Adafactor: a failure at step 6 healed from
    the step-4 checkpoint ends on the bits of the uninterrupted run,
    factored moments included; the reference restores the last checkpoint
    into its own Adafactor state with the same numbers."""
    tc = get_config("whisper-medium").reduced()
    tc = dataclasses.replace(tc, heat=dataclasses.replace(tc.heat, backend="pallas"))
    opts = lm.TrainOptions(remat="full", attn_chunk=8)
    extras = {"frames": ((2, tc.encoder_seq, tc.d_model), torch.float32)}
    clean, losses = trainer.train_lm(tc, opts, _tcfg(optimizer="adafactor"), extras,
                                     device="cpu", log=lambda *_: None)
    logs = []
    healed, healed_losses = trainer.train_lm(
        tc, opts, _tcfg(optimizer="adafactor", ckpt_dir=str(tmp_path),
                        fail_at_step=6), extras, device="cpu", log=logs.append)
    assert logs == ["[trainer] injected failure at step 6 -> restoring "
                    "latest checkpoint"]
    assert len(losses) == 10 and healed_losses[-4:] == losses[-4:]
    assert np.all(np.isfinite(losses))
    names = []
    for (n, a), (m, b) in zip(ckpt.named_leaves(clean), ckpt.named_leaves(healed),
                              strict=True):
        assert n == m
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), n
        names.append(n)
    for n in ("opt_state/moments/blocks/cross/wq/vr",
              "opt_state/moments/encoder/mlp/w_up/vc", "opt_state/moments/enc_norm/v"):
        assert n in names
    jc = jget_config("whisper-medium").reduced()
    target = jtrainer.init_lm_state(jax.random.PRNGKey(0), jc, jlm.TrainOptions(),
                                    joptim.get_optimizer("adafactor"))
    restored, step, _ = jckpt.restore(str(tmp_path), target)
    assert step == 8
    want = convert.lm_state_to_numpy(trainer.train_lm(
        tc, opts, _tcfg(steps=8, optimizer="adafactor"), extras, device="cpu",
        log=lambda *_: None)[0])
    got = _tree(restored)
    assert list(got) == list(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_convert_carries_a_reference_adafactor_state():
    """The reference's Adafactor state after one step (reduced whisper:
    encoder, cross-attention and factored moments) through
    ``lm_state_from_numpy`` and back: ``FactoredMoment`` leaves with their
    None fields where the reference has none, every name, dtype and value
    unchanged."""
    jc = jget_config("whisper-medium").reduced()
    opts = jlm.TrainOptions(loss="softmax", attn_chunk=8)
    jopt = joptim.get_optimizer("adafactor")
    jstate = jtrainer.init_lm_state(jax.random.PRNGKey(4), jc, opts, jopt)
    jb, _ = _batches(get_config("whisper-medium").reduced(), s=16)
    step = jtrainer.make_lm_train_step_raw(jc, opts, jopt, 1e-2)
    jstate, _ = step(jstate, jb, jax.random.PRNGKey(5))
    want = _tree(jstate)
    state = convert.lm_state_from_numpy(want)
    m = state.opt_state.moments
    assert m["blocks"]["cross"]["wk"].v is None and m["blocks"]["cross"]["wk"].vr.shape == (
        jc.n_layers, jc.d_model, jc.n_kv_heads)
    assert m["enc_norm"].vr is None and m["enc_norm"].v.shape == (jc.d_model,)
    got = convert.lm_state_to_numpy(state)
    assert list(got) == list(want)
    for n in want:
        assert got[n].dtype == want[n].dtype, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert float(np.abs(want["opt_state/moments/blocks/cross/wq/vr"]).max()) > 0
