"""The dry run (``launch/specs.py``, ``launch/dryrun.py``, the ``meta``
builds) and sharded serving, held to the reference's pure functions.

The reference's own dry run cannot run on the installed jax
(``tests/test_distributed.py::test_dryrun_entrypoint_tiny``, ROADMAP C.4),
so the port is held to what the two packages compute without a mesh or a
compiler:

* ``bytes_per_device`` over raw, fitted and ``fsdpify``-ed defs at 2 and 4
  bytes, for all 10 configs on both production mesh shapes;
* ``arch_optimizer``'s choice and its state's spec trees (ZeRO-1 over the
  data shards, Adafactor for fsdp archs), ``batch_specs`` per family,
  ``MF_SHAPES``, the skip reasons of all 40 (arch x shape) pairs, and
  ``abstract_params`` leaf by leaf;
* one rank's ``meta`` slices on a fake 256-rank process group: their bytes
  are ``bytes_per_device`` of the fitted defs, one config per family;
* the CLI on one cell (the reference's tiny entry-point test), the MF
  cells on a 1x1 mesh for both engines (``tests/test_engine.py``'s
  lowerability tests), the cells of reduced configs on a fake 2x2 mesh;
* sharded prefill and decode on four gloo ranks (data=2 x model=2) within
  1e-5 of the unsharded port, which the decode tests hold to the
  reference.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))   # for the ranks

from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.core import mf  # noqa: E402
from repro_torch.core import mf_distributed as mfd  # noqa: E402
from repro_torch.core.engine import resolve_engine  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import ccl_similarity, embedding_update  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_host_mesh,
    make_production_mesh,
    run_ranks,
)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import lm_distributed as lmd  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PROD_MESHES = {"single_pod_16x16": {"data": 16, "model": 16},
               "multi_pod_2x16x16": {"pod": 2, "data": 16, "model": 16}}
#: one config per family for the meta build's bytes.
FAMILY_ARCHS = ("smollm-360m", "moonshot-v1-16b-a3b", "mamba2-370m",
                "zamba2-2.7b", "qwen2-vl-2b", "whisper-medium")
SERVE_ATOL = 1e-5


def _jcfg(arch):
    from repro.configs import get_config as jget_config
    return jget_config(arch)


def _norm(spec) -> tuple:
    def one(a):
        if isinstance(a, (tuple, list)):
            a = tuple(a)
            return a[0] if len(a) == 1 else a
        return a
    return tuple(one(a) for a in spec)


def _jnames(tree, is_leaf) -> dict:
    import jax

    from repro.train.checkpoint import _key_str
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(_key_str(k) for k in path): leaf for path, leaf in flat}


def _tnames(tree, prefix: str = "") -> dict:
    """Leaves by name (dict keys, NamedTuple fields, tuple indices), a
    PartitionSpec, tensor or ParamDef being a leaf."""
    if tree is None:
        return {}
    if isinstance(tree, (shd.PartitionSpec, torch.Tensor, tparams.ParamDef)) \
            or not isinstance(tree, (dict, tuple, list)):
        return {prefix: tree}
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


# --------------------------------------------------------------------------
# The reference's pure functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(PROD_MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_bytes_per_device_is_the_reference_arithmetic(arch, mesh_name):
    """Raw defs (the logical specs, floor division included), fitted defs
    and, at the mesh's data shards, ``fsdpify``-ed defs, at 2 and 4 bytes."""
    import jax

    from repro.models import lm as jlm
    from repro.models import params as jparams

    ms = PROD_MESHES[mesh_name]
    dshards = ms.get("pod", 1) * ms["data"]
    jdefs, tdefs = jlm.model_defs(_jcfg(arch)), lm.model_defs(get_config(arch))

    def jfit(defs):
        return jax.tree.map(lambda d: dataclasses.replace(
            d, spec=jparams.fit_spec(d.shape, d.spec, ms)), defs,
            is_leaf=jparams.is_def)

    pairs = [(jdefs, tdefs), (jfit(jdefs), tparams.fitted_defs(tdefs, ms)),
             (jfit(jparams.fsdpify(jdefs, dshards)),
              tparams.fitted_defs(tparams.fsdpify(tdefs, dshards), ms))]
    for jd, td in pairs:
        for b in (2, 4):
            assert tparams.bytes_per_device(td, ms, b) == \
                jparams.bytes_per_device(jd, ms, b)
    assert tparams.is_def(tparams.def_leaves(tdefs)[0])
    assert not tparams.is_def(shd.P())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_optimizer_is_the_reference_choice(arch):
    """Adafactor for fsdp archs, else AdamW with ZeRO-1 over the active
    mesh's data shards: the name and the state's spec trees fitted to the
    16 x 16 mesh, with no mesh (1 data shard) and under a fake 256-rank
    production mesh (16 data shards) against the reference's optimizer at
    16 shards."""
    from repro.launch import specs as jspecs
    from repro.models import lm as jlm
    from repro.models import params as jparams
    from repro.optim import optimizers as joptim

    ms = PROD_MESHES["single_pod_16x16"]
    jcfg, tcfg = _jcfg(arch), get_config(arch)
    jdefs, tdefs = jlm.model_defs(jcfg), lm.model_defs(tcfg)
    is_p = lambda x: isinstance(x, jparams.P)     # noqa: E731

    def same(jopt, topt):
        assert topt.name == jopt.name
        want = _jnames(jparams.partition_specs(jopt.state_defs(jdefs), ms),
                       is_p)
        got = _tnames(tparams.partition_specs(topt.state_defs(tdefs), ms))
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}

    same(jspecs.arch_optimizer(jcfg), specs.arch_optimizer(tcfg))
    with dryrun.fake_process_group(256):
        mesh = make_production_mesh()
        with shd.use_mesh(mesh):
            topt = specs.arch_optimizer(tcfg)
    jopt = (joptim.get_optimizer("adafactor", bf16_step=jcfg.opt_bf16_step)
            if jcfg.fsdp else joptim.get_optimizer(
                "adamw", zero1=True, data_shards=16,
                bf16_step=jcfg.opt_bf16_step))
    same(jopt, topt)
    assert topt.name == ("adafactor" if tcfg.fsdp else "adamw")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_specs_and_skips_are_the_reference_ones(arch):
    """``batch_specs`` per family at train_4k and prefill_32k (shapes and
    specs; the port's tokens are int64 and its modality inputs fp32), and
    the skip reason of every shape."""
    from repro.launch import specs as jspecs
    from repro.models.config import SHAPES as JSHAPES

    jcfg, tcfg = _jcfg(arch), get_config(arch)
    for name in ("train_4k", "prefill_32k"):
        jb, js = jspecs.batch_specs(jcfg, JSHAPES[name])
        tb, ts = specs.batch_specs(tcfg, SHAPES[name])
        assert sorted(tb) == sorted(jb)
        for k in tb:
            assert tuple(tb[k].shape) == tuple(jb[k].shape)
            assert tb[k].device.type == "meta"
            assert _norm(ts[k]) == _norm(js[k])
        assert tb["tokens"].dtype == torch.int64
    assert list(SHAPES) == list(JSHAPES)
    for name in SHAPES:
        assert SHAPES[name] == ShapeConfig(*dataclasses.astuple(JSHAPES[name]))
        assert tcfg.skip_reason(name) == jcfg.skip_reason(name)


def test_mf_shapes_and_abstract_trees_are_the_reference_ones():
    """``MF_SHAPES``, and ``abstract_state`` / ``abstract_batch`` of AMAZON
    (shapes leaf by leaf, on meta)."""
    import jax

    from repro.configs.heat_mf import AMAZON as JAMAZON
    from repro.core import mf_distributed as jmfd
    from repro_torch.configs.heat_mf import AMAZON

    assert {k: dataclasses.astuple(v) for k, v in mfd.MF_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jmfd.MF_SHAPES.items()}
    is_s = lambda x: isinstance(x, jax.ShapeDtypeStruct)   # noqa: E731
    for jt, tt in ((jmfd.abstract_state(JAMAZON), mfd.abstract_state(AMAZON)),
                   (jmfd.abstract_batch(JAMAZON, 65536),
                    mfd.abstract_batch(AMAZON, 65536))):
        want = {k: tuple(v.shape) for k, v in _jnames(jt, is_s).items()
                if hasattr(v, "shape")}
        leaves = _tnames(tt)       # the port's counters are host ints: ()
        got = {k: tuple(v.shape) if isinstance(v, torch.Tensor) else ()
               for k, v in leaves.items()}
        assert got == want
        assert all(v.device.type == "meta" for v in leaves.values()
                   if isinstance(v, torch.Tensor))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_are_the_reference_shapes(arch):
    import jax

    from repro.models import lm as jlm
    want = {k: tuple(v.shape) for k, v in _jnames(
        jlm.abstract_params(_jcfg(arch)),
        lambda x: isinstance(x, jax.ShapeDtypeStruct)).items()}
    got = lm.abstract_params(get_config(arch))
    assert {k: tuple(v.shape) for k, v in _tnames(got).items()} == want
    assert all(v.device.type == "meta" and v.dtype == torch.float32
               for v in _tnames(got).values())


@pytest.mark.parametrize("multi", [False, True])
def test_meta_slices_are_bytes_per_device_of_the_fitted_defs(multi):
    """One rank of a fake production process group: its ``meta`` slices
    (built at their local shapes) hold ``bytes_per_device`` of the fitted
    defs, for one config per family (fsdp archs fsdpify under the mesh)."""
    with dryrun.fake_process_group(512 if multi else 256, rank=37):
        mesh = make_production_mesh(multi_pod=multi)
        with shd.use_mesh(mesh):
            for arch in FAMILY_ARCHS + ("llama4-maverick-400b-a17b",):
                cfg = get_config(arch)
                local = lm.abstract_params(cfg, torch.float32, mesh)
                fitted = tparams.fitted_defs(lm.model_defs(cfg), mesh.shape)
                got = dryrun.tree_bytes(local)
                assert got == tparams.bytes_per_device(fitted, mesh.shape, 4)
                assert got < tparams.count_params(fitted) * 4 / 8, arch


def test_dryrun_entrypoint_tiny():
    """The module itself, as its own process, for one cheap cell (the
    reference's ``test_dryrun_entrypoint_tiny``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "decode_32k", "--mesh", "multi"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout and "0 failures" in out.stdout


def _mf_cfg(**kw):
    base = dict(num_users=64, num_items=128, emb_dim=16, num_negatives=8)
    base.update(kw)
    return mf.MFConfig(**base)


@pytest.mark.parametrize("engine", ["fused", "pallas_tile"])
def test_mf_cell_runs_on_meta(engine):
    """``build_mf_cell`` on a 1x1 mesh with the fused engine and with the
    pallas engine over a tile (``tests/test_engine.py``'s lowerability
    tests): one step on ``meta``, the kernel wrappers called on ``meta``
    (no launch, no plain version) and the state's shapes kept."""
    cfg = (_mf_cfg(tile_size=16, refresh_interval=100, backend="pallas",
                   update_impl="pallas") if engine == "pallas_tile"
           else _mf_cfg())
    counters = (ccl_similarity.STATS_LAUNCHES, ccl_similarity.BWD_LAUNCHES,
                embedding_update.GATHER_FMA_LAUNCHES)
    for c in counters:
        c.reset()
    mesh = make_host_mesh(1, 1)
    fn, args, spec_trees, donate = mfd.build_mf_cell(
        cfg, mesh, 16,
        engine=resolve_engine(cfg, backend="fused") if engine == "fused"
        else resolve_engine(cfg))
    state, loss = fn(*args)
    assert donate == (0,) and loss.device.type == "meta" and loss.shape == ()
    assert state.params.user_table.shape == (64, 16)
    assert spec_trees[0] == mfd.state_specs(cfg, mesh)
    calls = [(c.count("meta"), c.count("cpu"), c.count("cuda"))
             for c in counters]
    if engine == "pallas_tile":
        assert calls == [(1, 0, 0), (1, 0, 0), (2, 0, 0)]
    else:
        assert calls == [(0, 0, 0)] * 3


def test_mf_record_on_a_fake_mesh_counts_its_exchanges():
    """``lower_mf_cell`` of the Amazon config cut to 1024 users and 2048
    items as rank 5 of a fake 8-rank (data=4, model=2) mesh: the record's
    keys, its exchanges (all-gathers only), and the bounded update list of
    the row-sharded tables."""
    with dryrun.fake_process_group(8, rank=5):
        mesh = shd.Mesh({"data": 4, "model": 2})
        rec = dryrun.lower_mf_cell("mf_train_64k", mesh, users=1024,
                                   items=2048)
    assert rec["mode"] == "meta" and rec["rank"] == 5
    assert rec["bounded"] == ["RowShard.owned"]
    assert rec["collective_bytes"]["all-gather"] > 0
    assert set(rec["collective_bytes"]) == set(shd.EXCHANGE_KINDS)
    assert sum(rec["collective_bytes"].values()) == \
        rec["collective_bytes"]["all-gather"]
    assert rec["flops_excludes"] == [] and rec["kernels"] == {}
    assert rec["bytes_accessed"] is None
    assert rec["memory"]["temp_bytes"] is None
    parts = rec["memory"]["argument_parts"]
    assert parts["state"] >= (1024 // 4 + 2048 // 2) * 128 * 4
    assert parts["batch"] == 65536 * (8 + 8 + 100 * 8 + 100 * 4)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["smollm-360m", "moonshot-v1-16b-a3b",
                                  "zamba2-2.7b", "whisper-medium"])
def test_reduced_cells_run_on_a_fake_mesh(arch, kind):
    """``build_cell`` of a reduced config at a small shape on a fake
    (data=2, model=2) mesh: the step runs on ``meta``, its parameter bytes
    are ``bytes_per_device`` of the fitted defs, and a sharded step
    exchanges."""
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("t", 16, 4, kind)
    with dryrun.fake_process_group(4, rank=3):
        mesh = make_host_mesh(2, 2)
        with shd.use_mesh(mesh):
            prog = specs.build_cell(cfg, shape, mesh)
            with shd.ExchangeCounter() as ex:
                out = prog.fn(*prog.args)
            fitted = tparams.fitted_defs(lm.model_defs(cfg), mesh.shape)
    assert dryrun.tree_bytes(prog.args[0]) == tparams.bytes_per_device(
        fitted, mesh.shape, 4)
    assert ex.total > 0
    if kind == "decode":
        logits, cache = out
        assert logits.shape == (4, 1, cfg.vocab)
        assert _sharded_leaves(cache) > 0
    elif kind == "prefill":
        assert out[0].shape == (4, cfg.vocab)
        assert _sharded_leaves(out[1]) > 0


# --------------------------------------------------------------------------
# Sharded serving on gloo ranks
# --------------------------------------------------------------------------

def _sharded_leaves(cache) -> int:
    """Leaves of a decode cache that the mesh splits."""
    return sum(any(a is not None for a in spec)
               for spec in _tnames(lmd.cache_specs(cache)).values())


SERVE_ARCHS = ("smollm-360m", "moonshot-v1-16b-a3b", "zamba2-2.7b",
               "whisper-medium")


def _serve_rank(archs):
    """One of four gloo ranks (data=2 x model=2): each reduced config served
    unsharded and sharded from the same init, the prefill and 3 decode
    steps' largest logit differences, and the cache gathered back against
    the unsharded cache."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(2, 2)
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        whole = lm.init_params(0, cfg, device="cpu")
        local = lm.init_params(0, cfg, device="cpu", mesh=mesh)
        view = lmd.LMShardingPlan(cfg, mesh).view(local)
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (4, 11), generator=gen)
        batch = {"tokens": toks[:, :8]}
        if cfg.family == "audio":
            batch["frames"] = torch.randn(4, cfg.encoder_seq, cfg.d_model,
                                          generator=gen) * 0.1
        lg0, c0 = lm.prefill(whole, batch, cfg, device="cpu")
        c0 = lm.pad_cache(c0, cfg, 11)
        with shd.use_mesh(mesh):
            lg1, c1 = lm.prefill(view, batch, cfg, device="cpu")
            sharded = _sharded_leaves(c1)
            c1 = lmd.place_cache(lm.pad_cache(lmd.gather_cache(c1, mesh),
                                              cfg, 11), mesh)
        errs = [float((lg0 - lg1).abs().max())]
        data_bytes = []
        for p in range(8, 11):
            d0, c0 = lm.decode_step(whole, c0, toks[:, p:p + 1], p, cfg,
                                    device="cpu")
            with shd.use_mesh(mesh), shd.ExchangeCounter() as ex:
                d1, c1 = lm.decode_step(view, c1, toks[:, p:p + 1], p, cfg,
                                        device="cpu")
            data_bytes.append(sum(n for axes, n in ex.by_axes.items()
                                  if "data" in axes))
            errs.append(float((d0 - d1).abs().max()))
        with shd.use_mesh(mesh):
            back = lmd.gather_cache(c1, mesh)
        cache_err = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(_tnames(back).values(),
                                        _tnames(c0).values()))
        out[arch] = {"errs": errs, "cache": cache_err,
                     "placed": _sharded_leaves(c1), "shards": sharded,
                     "data_bytes": data_bytes, "vocab": cfg.vocab}
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return run_ranks(_serve_rank, 4, args=(SERVE_ARCHS,), threads=1,
                     timeout=300,
                     store_dir=str(tmp_path_factory.mktemp("serve")))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_match_the_unsharded_run(served, arch):
    """Every rank's logits and gathered cache within 1e-5 of the unsharded
    run's; each data rank serves its own 2 of the 4 rows, so a decode
    step's only exchange over the data group is the logits' gather
    (4 x V fp32), never the cache."""
    for rank in served:
        got = rank[arch]
        assert max(got["errs"]) <= SERVE_ATOL, got["errs"]
        assert got["cache"] <= SERVE_ATOL
        assert got["shards"] > 0 and got["placed"] == got["shards"]
        assert got["data_bytes"] == [4 * got["vocab"] * 4] * 3
