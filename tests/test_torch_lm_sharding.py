"""LM training under a mesh over ``torch.distributed``: gloo ranks on the
CPU started by ``launch/mesh.py::run_ranks``, held to the JAX package and
to the port's unsharded runs.

The reference's own sharded LM tests cannot run on the installed jax
(``tests/test_distributed.py::test_reduced_arch_trains_on_mesh``,
``tests/test_multidevice.py``), so the port is held to the reference's
single-device step and to the stated contract of ``tests/test_multidevice.py``:

* the spec trees: ``partition_specs`` and ``fsdpify`` of ``model_defs`` for
  every config, and the ``state_defs`` of AdamW with ZeRO-1 and of
  Adafactor, equal to the reference's on three meshes;
* AdamW's bf16 step against the reference's update, and its ZeRO-1 update
  over 2 ranks against the unsharded update, bit for bit;
* the expert-parallel MoE on (data=2, model=2), forward and gradient: at
  capacity factor E / k against the reference's meshless layer, at the
  config's 1.25 (tokens dropped, capacity counted per data shard) against
  the reference's own sharded layer, run with 8 forced host devices in a
  subprocess as ``tests/test_distributed.py`` runs it; under data axes
  alone the capacity is the whole batch's, as in the reference's meshless
  layer;
* ``train_lm`` of reduced smollm (HEAT head on ``pallas``), moonshot (MoE)
  and zamba2 (hybrid) under (data=2), (model=2) and (data=2, model=2)
  within 1e-5 of the port's unsharded run at every step and in the final
  state, and one replayed sharded step against the reference's
  single-device ``make_lm_train_step_raw`` fed the reference's batch and
  draws (as ``tests/test_torch_lm.py`` replays them);
* a crash resumed bit for bit on (data=2, model=2), elastic restores from
  4 ranks to 1 and from 1 to 2, and the CLI's ``--mesh host --mesh-data 2``
  for an LM.

The multi-rank work runs in three ``run_ranks`` calls (module fixtures).
The rank bodies are module-level functions, so a spawned rank imports this
module by name; it imports no jax at module level.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))   # for the ranks

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import samplers as tsam  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, run_ranks  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models import lm_distributed as lmd  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.optim import quantization as qz  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
#: the MoE layer's gradients, as ``tests/test_torch_moe.py`` holds them.
EMBED_ATOL = 1e-4
TIMEOUT = 240.0
ARCHS = {"smollm": "smollm-360m", "moonshot": "moonshot-v1-16b-a3b",
         "zamba2": "zamba2-2.7b"}
MESHES = {"data2": (2, 1), "model2": (1, 2), "mesh22": (2, 2)}
STEPS, WINDOW, B, S, LR = 4, 2, 4, 16, 1e-3
SPEC_MESHES = {"d2m2": {"data": 2, "model": 2},
               "d16m16": {"data": 16, "model": 16},
               "p2d16m16": {"pod": 2, "data": 16, "model": 16}}
#: the MoE layer's inputs: E / k capacity (dropless) on (4, 16) tokens;
#: the config's 1.25 on (4, 160) tokens routed mostly to one expert, so
#: each data shard's 320 tokens overflow its 256 slots.
MOE_SMALL, MOE_DROP = (4, 16), (4, 160)


def _cfg(arch: str, **heat):
    cfg = get_config(ARCHS[arch]).reduced()
    heat = {"backend": "pallas", **heat}
    return dataclasses.replace(cfg, heat=dataclasses.replace(cfg.heat, **heat))


def _opts():
    return lm.TrainOptions(loss="heat", remat="full", attn_chunk=8)


def _tree(state) -> dict:
    return {n: (x.numpy().copy() if isinstance(x, torch.Tensor) else x)
            for n, x in ckpt.named_leaves(state)}


def _train(arch: str, mesh=None, **tkw):
    """``train_lm`` on the CPU; the whole final state (gathered under a
    mesh) as numpy, and the losses."""
    cfg = _cfg(arch, **tkw.pop("heat", {}))
    tcfg = trainer.TrainerConfig(steps=STEPS, lr=LR, batch_size=B, seq_len=S,
                                 log_every=0, steps_per_dispatch=WINDOW,
                                 mesh=mesh, **tkw)
    state, losses = trainer.train_lm(cfg, _opts(), tcfg, device="cpu",
                                     log=lambda *_: None)
    if mesh is not None:
        plan = lmd.LMShardingPlan(cfg, mesh,
                                  optimizers.get_optimizer(tcfg.optimizer))
        state = plan.gather_state(state)
    return _tree(state), losses


def _assert_close(got, want, atol=ATOL):
    (tree, losses), (want_tree, want_losses) = got, want
    np.testing.assert_allclose(losses, want_losses, atol=atol, rtol=0)
    assert sorted(tree) == sorted(want_tree)
    for name in want_tree:
        np.testing.assert_allclose(np.asarray(tree[name], np.float64),
                                   np.asarray(want_tree[name], np.float64),
                                   atol=atol, rtol=0, err_msg=name)


def _assert_same(got, want):
    (tree, losses), (want_tree, want_losses) = got, want
    assert losses == want_losses
    assert sorted(tree) == sorted(want_tree)
    for name in want_tree:
        np.testing.assert_array_equal(tree[name], want_tree[name],
                                      err_msg=name)


# --------------------------------------------------------------------------
# The MoE layer, on the ranks
# --------------------------------------------------------------------------

def _moe_inputs(tokens, drop: bool, seed: int = 5) -> dict:
    """One MoE layer of reduced moonshot, its input and a cotangent (that
    of a mean over the tokens, so the gradients are of order one); with
    ``drop`` the inputs lean to expert 0, so capacity binds."""
    cfg = get_config(ARCHS["moonshot"]).reduced()
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    r = np.random.default_rng(seed)
    p = {"router": r.standard_normal((d, e)).astype(np.float32) / d ** 0.5,
         "w_gate": r.standard_normal((e, d, f)).astype(np.float32) / d ** 0.5,
         "w_up": r.standard_normal((e, d, f)).astype(np.float32) / d ** 0.5,
         "w_down": r.standard_normal((e, f, d)).astype(np.float32) / f ** 0.5}
    x = r.standard_normal(tokens + (d,)).astype(np.float32)
    if drop:
        p["router"][:, 0] += 0.5
        x += 1.0
    cot = r.standard_normal(x.shape).astype(np.float32) / (tokens[0] * tokens[1])
    return {"p": p, "x": x, "cot": cot}


def _moe_rank_part(mesh, inputs, capacity_factor):
    """This rank's MoE output rows and gradients under ``mesh``: the
    experts sliced over the model axis, the rows over the data axes."""
    cfg = dataclasses.replace(get_config(ARCHS["moonshot"]).reduced(),
                              capacity_factor=capacity_factor)
    data, model = mesh.group(shd.DATA_AXES), mesh.group(shd.MODEL_AXIS)
    lo, hi = shd.shard_bounds(inputs["x"].shape[0], data.size)[data.index]
    spec = shd.P(shd.MODEL_AXIS, None, None)
    leaves = {"router": torch.tensor(inputs["p"]["router"], requires_grad=True)}
    view = {"router": leaves["router"]}
    for k in ("w_gate", "w_up", "w_down"):
        leaves[k] = tparams.slice_leaf(torch.tensor(inputs["p"][k]), spec,
                                       mesh).requires_grad_()
        view[k] = tparams.Shard(leaves[k], spec) if model.size > 1 else leaves[k]
    x = torch.tensor(inputs["x"][lo:hi], requires_grad=True)
    with shd.use_mesh(mesh):
        y = moe.moe_apply(view, x, cfg)
        grads = torch.autograd.grad(
            (y * torch.tensor(inputs["cot"][lo:hi])).sum(),
            [leaves[k] for k in sorted(leaves)] + [x])
    names = sorted(leaves) + ["x"]
    out = dict(zip(names, grads))
    for k in sorted(leaves):            # each data rank saw its rows only
        out[k] = shd.sum_over([out[k]], data)[0]
    return {"y": y.detach().numpy(), **{k: v.numpy() for k, v in out.items()}}


def _assemble_moe(parts: list, mesh_shape: tuple) -> dict:
    """The whole output and gradients from every rank's parts (rank-major
    over (data, model))."""
    d, m = mesh_shape
    grid = [[parts[i * m + j] for j in range(m)] for i in range(d)]
    out = {"y": np.concatenate([row[0]["y"] for row in grid]),
           "x": np.concatenate([row[0]["x"] for row in grid]),
           "router": grid[0][0]["router"]}
    for k in ("w_gate", "w_up", "w_down"):
        out[k] = np.concatenate([grid[0][j][k] for j in range(m)])
    for row in grid:                    # model ranks agree bit for bit
        for part in row[1:]:
            for k in ("y", "x", "router"):
                np.testing.assert_array_equal(part[k], row[0][k], err_msg=k)
    return out


# --------------------------------------------------------------------------
# Rank bodies
# --------------------------------------------------------------------------

class ReplaySampler:
    """Returns, call by call, the draws it was loaded with (ids and tile
    slots), gathering rows through the live table (owner-masked when the
    table's rows are sharded)."""

    name = "replay"

    def __init__(self, draws):
        self.draws = list(draws)

    def sample(self, state, gen, shape):
        ids, local = self.draws.pop(0)
        assert tuple(ids.shape) == tuple(shape)
        return teng.NegSample(ids, qz.gather_rows(state.table, ids), state,
                              local_idx=local)


def _replay_step(case: dict, mesh) -> dict:
    """The reference's state, batch and draws through the port's sharded
    step; the whole new state as numpy, and the loss."""
    draws = [(torch.as_tensor(i), torch.as_tensor(j)) for i, j in case["draws"]]
    teng.register_sampler("replay")(ReplaySampler(draws))
    refreshes = [torch.as_tensor(t) for t in case["refreshes"]]
    plain = tsam.sample_unique
    tsam.sample_unique = lambda gen, num, n: refreshes.pop(0)
    try:
        cfg = _cfg("smollm", sampler="replay")
        opt = optimizers.get_optimizer("sgd")
        plan = lmd.LMShardingPlan(cfg, mesh, opt)
        whole = convert.lm_state_from_numpy(case["state"])
        state = plan.place_state(whole)
        step = trainer.make_lm_train_step_raw(cfg, _opts(), opt, case["lr"],
                                              case["grad_accum"], plan)
        with shd.use_mesh(mesh):
            state, loss = step(state, {"tokens": torch.as_tensor(
                case["tokens"], dtype=torch.int64)}, 8)
            loss = plan.reduce_losses(loss[None])[0]
            whole = plan.gather_state(state)
    finally:
        tsam.sample_unique = plain
        del teng.SAMPLERS["replay"]
    return {"tree": convert.lm_state_to_numpy(whole), "loss": float(loss)}


def _mesh22_rank(moe_cases, replay_cases, tmp: str) -> dict:
    """The four ranks of (data=2, model=2)."""
    mesh = make_host_mesh(2, 2)
    out = {"coords": dict(mesh.coords)}
    out["moe"] = {name: _moe_rank_part(mesh, inputs, cf)
                  for name, (inputs, cf) in moe_cases.items()}
    out["replay"] = [_replay_step(case, mesh) for case in replay_cases]
    out["train"] = {arch: _train(arch, mesh) for arch in ARCHS}
    out["in_batch"] = _train("smollm", mesh, heat={"sampler": "in_batch"})
    out["llama4"] = _train_llama4(mesh)
    out["adafactor"] = _train("smollm", mesh, optimizer="adafactor")
    crash = os.path.join(tmp, "crash")
    out["crash"] = _train("smollm", mesh, ckpt_dir=crash, ckpt_every=2,
                          fail_at_step=3)
    return out if dist_rank() == 0 else {"coords": out["coords"],
                                         "moe": out["moe"]}


def _mesh2_rank(moe_cases, elastic_dir: str) -> dict:
    """The two ranks of a (data=2) mesh and of a (model=2) mesh over the
    same process group."""
    data2, model2 = make_host_mesh(2, 1), make_host_mesh(1, 2)
    out = {"train": {(arch, name): _train(arch, mesh)
                     for arch in ARCHS
                     for name, mesh in (("data2", data2), ("model2", model2))}}
    out["moe_data2"] = _moe_rank_part(data2, *moe_cases["drop"])
    out["zero1"] = _zero1_rank(data2)
    out["elastic"] = _train("smollm", data2, ckpt_dir=elastic_dir,
                            ckpt_every=2)
    return out if dist_rank() == 0 else {"moe_data2": out["moe_data2"]}


def _train_llama4(mesh):
    """Reduced llama4 (fsdp, interleaved MoE) on ``mesh``: its data-sharded
    leaves gather on use and reduce-scatter their gradients."""
    cfg = get_config("llama4-maverick-400b-a17b").reduced()
    tcfg = trainer.TrainerConfig(steps=2, lr=LR, batch_size=B, seq_len=S,
                                 log_every=0, steps_per_dispatch=2, mesh=mesh)
    state, losses = trainer.train_lm(cfg, _opts(), tcfg, device="cpu",
                                     log=lambda *_: None)
    if mesh is not None:
        state = lmd.LMShardingPlan(cfg, mesh, optimizers.get_optimizer(
            "adamw")).gather_state(state)
    return _tree(state), losses


def _zero1_inputs(seed: int = 0):
    r = np.random.default_rng(seed)
    shapes = {"a": (4, 6), "b": {"c": (3,), "d": (2, 5, 4)}, "e": (3, 5)}

    def make(scale=1.0):
        return _map_tree(shapes, lambda s: torch.tensor(
            scale * r.standard_normal(s), dtype=torch.float32))
    return make(), [make(0.1) for _ in range(3)]


def _map_tree(tree, fn):
    """``fn`` of every leaf of a nested dict (tuples are leaves)."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _zero1_rank(mesh) -> dict:
    """Three AdamW updates with ZeRO-1 over the data group against the
    unsharded update, with and without the bf16 step: every parameter
    and the moments' bits."""
    out = {}
    for bf16 in (False, True):
        params, grads = _zero1_inputs()
        params_z = tparams.tree_map(torch.clone, params)
        plain = optimizers.make_adamw(weight_decay=0.01, bf16_step=bf16)
        z1 = optimizers.make_adamw(weight_decay=0.01, bf16_step=bf16,
                                   zero1=True, data_shards=2)
        s_plain, s_z1 = plain.init(params), z1.init(params_z)
        with shd.use_mesh(mesh):
            for g in grads:
                params, s_plain = plain.update(g, s_plain, params, 1e-2)
                params_z, s_z1 = z1.update(g, s_z1, params_z, 1e-2)
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tparams.tree_items(params), tparams.tree_items(params_z)))
        sliced = {name: tuple(m.shape) for name, m in
                  ckpt.named_leaves(s_z1.moments)}
        data = mesh.group(shd.DATA_AXES)
        moments_match = all(
            torch.equal(mz, tparams.slice_leaf(mp, _zero1_spec(mp, mz), mesh))
            for (_, mp), (_, mz) in zip(ckpt.named_leaves(s_plain.moments),
                                        ckpt.named_leaves(s_z1.moments)))
        out[bf16] = {"same": same, "sliced": sliced, "moments": moments_match,
                     "index": data.index}
    return out


def _zero1_spec(whole, part):
    return shd.P(*(shd.DATA_AXES if a != b else None
                   for a, b in zip(whole.shape, part.shape)))


def dist_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


# --------------------------------------------------------------------------
# The reference's sharded MoE, in a subprocess with 8 host devices
# --------------------------------------------------------------------------

REFERENCE_MOE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.launch.mesh import make_host_mesh
from repro.models import moe as moe_mod
import dataclasses

src, dst = sys.argv[1], sys.argv[2]
z = np.load(src)
cfg0 = get_config("moonshot-v1-16b-a3b").reduced()
out = {}
mesh = make_host_mesh(data=2, model=4)
for name in ("ek", "drop"):
    cfg = dataclasses.replace(cfg0, capacity_factor=float(z[name + "_cf"]))
    p = {k: jnp.asarray(z[name + "_" + k]) for k in
         ("router", "w_gate", "w_up", "w_down")}
    x, cot = jnp.asarray(z[name + "_x"]), jnp.asarray(z[name + "_cot"])
    f = lambda p, x: jnp.sum(moe_mod.moe_apply(p, x, cfg) * cot)
    fwd = lambda p, x: moe_mod.moe_apply(p, x, cfg)
    for tag, ctx in (("local", None), ("mesh", mesh)):
        if ctx is None:
            y, (gp, gx) = fwd(p, x), jax.grad(f, argnums=(0, 1))(p, x)
        else:
            with shd.use_mesh(ctx):
                y = jax.jit(fwd)(p, x)
                gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(p, x)
        out[f"{name}_{tag}_y"] = np.asarray(y)
        out[f"{name}_{tag}_x"] = np.asarray(gx)
        for k, v in gp.items():
            out[f"{name}_{tag}_{k}"] = np.asarray(v)
np.savez(dst, **out)
print("reference_moe_ok")
"""


# --------------------------------------------------------------------------
# Fixtures
# --------------------------------------------------------------------------

def _moe_cases() -> dict:
    cfg = get_config(ARCHS["moonshot"]).reduced()
    return {"ek": (_moe_inputs(MOE_SMALL, False),
                   cfg.moe_experts / cfg.moe_top_k),
            "drop": (_moe_inputs(MOE_DROP, True), cfg.capacity_factor)}


@pytest.fixture(scope="module")
def moe_cases():
    return _moe_cases()


@pytest.fixture(scope="module")
def reference_moe(moe_cases, tmp_path_factory):
    """The reference's MoE layer at E / k and at 1.25, meshless and on a
    (data=2, model=4) mesh of forced host devices."""
    tmp = tmp_path_factory.mktemp("reference_moe")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    arrays = {}
    for name, (inputs, cf) in moe_cases.items():
        arrays[name + "_cf"] = np.asarray(cf)
        arrays[name + "_x"], arrays[name + "_cot"] = inputs["x"], inputs["cot"]
        for k, v in inputs["p"].items():
            arrays[f"{name}_{k}"] = v
    np.savez(src, **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", REFERENCE_MOE, str(src),
                          str(dst)], capture_output=True, text=True, env=env,
                         timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(dst))


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The unsharded runs (smollm with its step-2 checkpoint kept)."""
    tmp = tmp_path_factory.mktemp("single")
    out = {arch: _train(arch) for arch in ARCHS}
    out["ckpt"] = str(tmp / "smollm")
    out["smollm_ckpt"] = _train("smollm", ckpt_dir=out["ckpt"], ckpt_every=2)
    out["in_batch"] = _train("smollm", heat={"sampler": "in_batch"})
    out["llama4"] = _train_llama4(None)
    out["adafactor"] = _train("smollm", optimizer="adafactor")
    return out


@pytest.fixture(scope="module")
def replay_cases():
    """The reference's SGD step on reduced smollm (HEAT head on pallas, the
    tile refreshed), with and without 2 micro-batches; its draws recorded
    for the port's replay sampler."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.core import engine as jeng
    from repro.core import samplers as jsam
    from repro.models import lm as jlm
    from repro.optim import optimizers as joptim
    from repro.train import trainer as jtrainer
    from repro.train.checkpoint import _flatten_with_paths

    jc = jget_config("smollm-360m").reduced()
    jc = dataclasses.replace(jc, heat=dataclasses.replace(jc.heat,
                                                          backend="pallas"))
    opts = jlm.TrainOptions(loss="heat", remat="full", attn_chunk=8)
    jopt = joptim.get_optimizer("sgd")
    cases = []
    for grad_accum in (1, 2):
        jstate = jtrainer.init_lm_state(jax.random.PRNGKey(2), jc, opts, jopt)
        jstate = jstate._replace(tile=jstate.tile._replace(
            step=jnp.asarray(jc.heat.refresh_interval - grad_accum,
                             jnp.int32)))
        tokens = np.random.default_rng(3).integers(0, jc.vocab, (B, S)).astype(
            np.int32)
        rng = jax.random.PRNGKey(8)
        table, tile = jstate.params["out_embed"], jstate.tile
        draws, refreshes = [], []
        for i in range(grad_accum):
            r = rng if grad_accum == 1 else jax.random.fold_in(rng, i)
            r_neg, r_tile = jax.random.split(r)
            drawn = jeng.SAMPLERS["tile"].sample(
                jeng.SampleContext(table=table, tile=tile), r_neg,
                (jc.heat.num_negatives,))
            draws.append((np.array(drawn.ids).astype(np.int64),
                          np.array(drawn.local_idx).astype(np.int64)))
            tile = jsam.tile_refresh(tile, r_tile, table,
                                     jc.heat.refresh_interval)
            if int(tile.step) == 0:
                refreshes.append(np.array(tile.tile_ids).astype(np.int64))
        assert refreshes, "the replayed step must refresh the tile"
        step = jtrainer.make_lm_train_step_raw(jc, opts, jopt, 1e-2, grad_accum)
        want, want_loss = step(jstate, {"tokens": jnp.asarray(tokens)}, rng)
        tree = {n: np.array(a) for n, a in _flatten_with_paths(jstate)}
        cases.append({"state": tree, "tokens": tokens, "draws": draws,
                      "refreshes": refreshes, "lr": 1e-2,
                      "grad_accum": grad_accum,
                      "want": {n: np.array(a)
                               for n, a in _flatten_with_paths(want)},
                      "want_loss": float(want_loss)})
    return cases


@pytest.fixture(scope="module")
def mesh22(moe_cases, replay_cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh22")
    ranks = run_ranks(_mesh22_rank, 4, args=(moe_cases, [
        {k: v for k, v in c.items() if k not in ("want", "want_loss")}
        for c in replay_cases], str(tmp)), timeout=TIMEOUT, threads=1,
        store_dir=str(tmp))
    return {"ranks": ranks, "crash_dir": str(tmp / "crash"), **ranks[0]}


@pytest.fixture(scope="module")
def mesh2(moe_cases, single, tmp_path_factory):
    """The 2-rank runs; the elastic run restores the unsharded run's step-2
    checkpoint (its later checkpoints removed) and trains on."""
    tmp = tmp_path_factory.mktemp("mesh2")
    elastic = str(tmp / "elastic")
    shutil.copytree(os.path.join(single["ckpt"], "step_00000002"),
                    os.path.join(elastic, "step_00000002"))
    ranks = run_ranks(_mesh2_rank, 2, args=(moe_cases, elastic),
                      timeout=TIMEOUT, threads=1, store_dir=str(tmp))
    return {"ranks": ranks, **ranks[0]}


# --------------------------------------------------------------------------
# Spec trees against the reference's
# --------------------------------------------------------------------------

def _norm(spec) -> tuple:
    def one(a):
        if isinstance(a, (tuple, list)):
            a = tuple(a)
            return a[0] if len(a) == 1 else a
        return a
    return tuple(one(a) for a in spec)


def _jnames(tree) -> dict:
    import jax
    from jax.sharding import PartitionSpec as JP

    from repro.train.checkpoint import _key_str
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(_key_str(k) for k in path) or "root": _norm(leaf)
            for path, leaf in flat}


def _tnames(tree, prefix: str = "") -> dict:
    """The port's spec tree by leaf name, as the reference's checkpoint
    names a tree (dict keys, NamedTuple fields, tuple indices)."""
    if isinstance(tree, shd.PartitionSpec):
        return {prefix or "root": _norm(tree)}
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    else:
        items = list(enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_tnames(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("mesh_name", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_trees_are_the_reference_trees(arch, mesh_name):
    """``partition_specs`` and ``fsdpify`` of ``model_defs``, and the
    ``state_defs`` of AdamW with ZeRO-1 and of Adafactor, fitted to the
    mesh: the reference's spec trees, leaf for leaf."""
    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro.models import params as jparams
    from repro.optim import optimizers as joptim

    mesh = SPEC_MESHES[mesh_name]
    dshards = mesh.get("pod", 1) * mesh["data"]
    jdefs, tdefs = jlm.model_defs(jget_config(arch)), lm.model_defs(
        get_config(arch))
    pairs = [(jparams.partition_specs(jdefs, mesh),
              tparams.partition_specs(tdefs, mesh)),
             (jparams.partition_specs(jparams.fsdpify(jdefs, dshards), mesh),
              tparams.partition_specs(tparams.fsdpify(tdefs, dshards), mesh))]
    for name, kw in (("adamw", dict(zero1=True, data_shards=dshards)),
                     ("adafactor", {})):
        jsd = joptim.get_optimizer(name, **kw).state_defs(jdefs)
        tsd = optimizers.get_optimizer(name, **kw).state_defs(tdefs)
        pairs.append((jparams.partition_specs(jsd, mesh),
                      tparams.partition_specs(tsd, mesh)))
    for want, got in pairs:
        want, got = _jnames(want), _tnames(got)
        assert got == want


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_logical_specs_are_the_reference_specs(arch):
    """The unfitted spec of every def of ``model_defs`` (``fsdpify``-ed for
    llama4, as the reference's is) and of ``cache_defs``."""
    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro.models import params as jparams

    jc, tc = jget_config(arch), get_config(arch)
    assert _tnames(tparams.partition_specs(lm.model_defs(tc))) == _jnames(
        jparams.partition_specs(jlm.model_defs(jc)))
    got = _tnames(tparams.partition_specs(lm.cache_defs(tc, 2, 8)))
    want = _jnames(jparams.partition_specs(jlm.cache_defs(jc, 2, 8)))
    assert got == want


# --------------------------------------------------------------------------
# Optimizers
# --------------------------------------------------------------------------

def test_adamw_bf16_step_matches_reference():
    """``make_adamw(bf16_step=True)`` against the reference's update over
    three steps, weight decay on, to 1e-5."""
    import jax.numpy as jnp

    from repro.optim import optimizers as joptim
    params, grads = _zero1_inputs(1)
    jopt = joptim.make_adamw(weight_decay=0.01, bf16_step=True)
    topt = optimizers.make_adamw(weight_decay=0.01, bf16_step=True)
    jp = _map_tree(params, lambda t: jnp.asarray(t.numpy()))
    js = jopt.init(jp)
    ts = topt.init(params)
    for g in grads:
        jp, js = jopt.update(_map_tree(g, lambda t: jnp.asarray(t.numpy())),
                             js, jp, 1e-2)
        params, ts = topt.update(g, ts, params, 1e-2)
    for (name, got), (_, want) in zip(tparams.tree_items(params),
                                      tparams.tree_items(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("bf16", [False, True])
def test_zero1_over_two_ranks_is_the_unsharded_update(mesh2, bf16):
    got = mesh2["zero1"][bf16]
    assert got["same"] and got["moments"]
    # every moment of rank 2 or more is split on a free dimension
    assert got["sliced"]["a/mu"] == (4, 3)
    assert got["sliced"]["b/d/nu"] == (2, 5, 2)
    assert got["sliced"]["b/c/mu"] == (3,)


# --------------------------------------------------------------------------
# The expert-parallel MoE
# --------------------------------------------------------------------------

def _moe_close(got: dict, want: dict, atol=ATOL):
    for k in ("y", "x", "router", "w_gate", "w_up", "w_down"):
        tol = EMBED_ATOL if k == "router" else atol
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                   err_msg=k)


def _ref(reference_moe, name, tag) -> dict:
    return {k: reference_moe[f"{name}_{tag}_{k}"] for k in
            ("y", "x", "router", "w_gate", "w_up", "w_down")}


def test_moe_mesh22_at_ek_matches_reference_meshless(mesh22, reference_moe):
    got = _assemble_moe([r["moe"]["ek"] for r in mesh22["ranks"]], (2, 2))
    _moe_close(got, _ref(reference_moe, "ek", "local"))


def test_moe_mesh22_with_drops_matches_reference_sharded(mesh22,
                                                         reference_moe):
    """At 1.25 each data shard drops its own overflow, as the reference's
    ``shard_map`` does: the port on (data=2, model=2) against the
    reference on (data=2, model=4), which differs from its meshless
    layer."""
    got = _assemble_moe([r["moe"]["drop"] for r in mesh22["ranks"]], (2, 2))
    want = _ref(reference_moe, "drop", "mesh")
    _moe_close(got, want)
    assert np.abs(want["y"] - reference_moe["drop_local_y"]).max() > 1e-2


def test_moe_data_axes_alone_count_the_whole_batch(mesh2, reference_moe):
    """Under (data=2) alone the reference's layer is its meshless one on
    the whole batch: the port's capacity and positions are the batch's."""
    got = {"y": np.concatenate([r["moe_data2"]["y"] for r in mesh2["ranks"]]),
           "x": np.concatenate([r["moe_data2"]["x"] for r in mesh2["ranks"]])}
    for k in ("router", "w_gate", "w_up", "w_down"):
        got[k] = mesh2["ranks"][0]["moe_data2"][k]
    _moe_close(got, _ref(reference_moe, "drop", "local"))


def test_reference_moe_gradient_under_its_mesh_is_the_meshless_one(
        reference_moe):
    """The probe of the reference's ``shard_map`` transpose (its
    ``check_vma=False``): at E / k its gradient under (data=2, model=4)
    equals the meshless one, so the port is held to either."""
    _moe_close(_ref(reference_moe, "ek", "mesh"),
               _ref(reference_moe, "ek", "local"))


# --------------------------------------------------------------------------
# train_lm under meshes
# --------------------------------------------------------------------------

def test_mesh22_coordinates(mesh22):
    assert [r["coords"] for r in mesh22["ranks"]] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_mesh22_tracks_single_device(arch, mesh22, single):
    _assert_close(mesh22["train"][arch], single[arch])


@pytest.mark.parametrize("mesh_name", ["data2", "model2"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_two_rank_meshes_track_single_device(arch, mesh_name, mesh2, single):
    _assert_close(mesh2["train"][(arch, mesh_name)], single[arch])


def test_in_batch_negatives_draw_from_the_whole_batch(mesh22, single):
    _assert_close(mesh22["in_batch"], single["in_batch"])


def test_fsdp_arch_trains_on_mesh22(mesh22, single):
    """Reduced llama4: ``fsdpify``-ed leaves (gathered over data, their
    gradients reduce-scattered) and interleaved MoE groups."""
    _assert_close(mesh22["llama4"], single["llama4"])


def test_adafactor_updates_sharded_leaves_whole(mesh22, single):
    """Adafactor's factored moments and clipping norm span a leaf: each
    sharded leaf is gathered, updated whole and sliced again."""
    _assert_close(mesh22["adafactor"], single["adafactor"])


@pytest.mark.parametrize("case", [0, 1], ids=["grad_accum1", "grad_accum2"])
def test_replayed_sharded_step_matches_reference(case, mesh22, replay_cases):
    got = mesh22["replay"][case]
    want = replay_cases[case]
    np.testing.assert_allclose(got["loss"], want["want_loss"], atol=ATOL)
    assert sorted(got["tree"]) == sorted(want["want"])
    for name, arr in want["want"].items():
        np.testing.assert_allclose(got["tree"][name], arr, atol=ATOL, rtol=0,
                                   err_msg=name)


def test_mesh22_crash_resume_is_bit_exact(mesh22):
    """A failure at step 3 heals from the step-2 checkpoint: the state and
    the losses of the uninterrupted (data=2, model=2) run, bit for bit
    (the replayed step's loss is logged again)."""
    tree, losses = mesh22["crash"]
    clean_tree, clean = mesh22["train"]["smollm"]
    assert losses[:3] + losses[4:] == clean
    _assert_same((tree, clean), (clean_tree, clean))


def test_elastic_restore_four_ranks_to_one(mesh22, single, tmp_path):
    """The (data=2, model=2) run's step-2 checkpoint, in the unsharded
    layout, restored by one process and trained to the end."""
    src = os.path.join(mesh22["crash_dir"], "step_00000002")
    with open(os.path.join(src, "manifest.json")) as f:
        assert '"params/embed"' in f.read()
    shutil.copytree(src, tmp_path / "step_00000002")
    got = _train("smollm", ckpt_dir=str(tmp_path), ckpt_every=100)
    assert len(got[1]) == STEPS - 2
    _assert_close(got, (single["smollm"][0], single["smollm"][1][2:]))


def test_elastic_restore_one_rank_to_two(mesh2, single):
    tree, losses = mesh2["elastic"]
    assert len(losses) == STEPS - 2
    _assert_close((tree, losses), (single["smollm"][0],
                                   single["smollm"][1][2:]))


def test_lm_state_on_a_one_rank_mesh_is_the_unsharded_state():
    """A mesh of one rank: the same init bits and the same step bits."""
    cfg = _cfg("smollm")
    opt = optimizers.get_optimizer("adamw")
    plan = lmd.LMShardingPlan(cfg, make_host_mesh(1, 1), opt)
    got = trainer.init_lm_state(0, cfg, _opts(), opt, device="cpu", plan=plan)
    want = trainer.init_lm_state(0, cfg, _opts(), opt, device="cpu")
    for (name, a), (_, b) in zip(ckpt.named_leaves(got),
                                 ckpt.named_leaves(want)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), name
    _assert_same(_train("smollm", make_host_mesh(1, 1)), _train("smollm"))


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------

def test_cli_trains_an_lm_on_a_data_mesh():
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--reduced", "--steps", "2", "--seq", "16",
         "--batch", "4", "--mesh", "host", "--mesh-data", "2",
         "--dist-backend", "gloo", "--device", "cpu",
         "--steps-per-dispatch", "2"],
        capture_output=True, text=True, timeout=TIMEOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert any("LM head engine" in l and "devices=2" in l for l in lines), \
        run.stdout
    assert any(l.startswith("done: 2 steps") for l in lines), run.stdout
