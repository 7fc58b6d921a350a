"""The port's sharding helpers against the JAX package, on the CPU, with no
process group: the pure functions of the mesh slice.

* ``fit_spec`` over a grid of shapes, specs and mesh shapes, equal to the
  reference's (its ``PartitionSpec`` read as a tuple);
* ``state_specs`` and ``batch_specs`` on the reference's mesh shapes, and the
  int8 refusal with the reference's message;
* ``shard_bounds`` and ``partitioned_batch``, equal bit for bit;
* ``cf_batch_shard``: the concatenated shards equal the port's global batch
  bit for bit, over uneven remainders (hypothesis);
* the compression quantizers: int8 codes bit for bit, scales to 1e-7
  relative, the error feedback;
* ``ShardedTileState``: per-shard distinct sorted ids, rows equal to the
  table's, independent shards, the refresh schedule;
* the mesh context helpers against the reference's on a one-device mesh, and
  a one-rank plan and ``train_mf(mesh=)`` equal to the unsharded run bit
  for bit.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as JP

from repro.core import mf as jmf
from repro.core import mf_distributed as jmfd
from repro.data import pipeline as jpipe
from repro.distributed import sharding as jshd
from repro.models.params import fit_spec as jfit_spec
from repro.optim import compression as jcomp
from repro_torch.core import mf
from repro_torch.core import mf_distributed as mfd
from repro_torch.core import samplers
from repro_torch.data import pipeline
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_data_mesh, make_host_mesh
from repro_torch.models.params import fit_spec
from repro_torch.optim import compression
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer

USERS, ITEMS, DIM, BATCH = 256, 512, 16, 64


def _fake_jax_mesh(shape: dict):
    """What the reference's spec functions read of a mesh: axis names and
    the device grid's shape."""
    return types.SimpleNamespace(axis_names=tuple(shape),
                                 devices=np.empty(tuple(shape.values())))


def _fake_mesh(shape: dict):
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape),
                                 size=int(np.prod(list(shape.values()))))


def _as_tuple(spec):
    return None if spec is None else tuple(spec)


MESH_SHAPES = [{"data": 1, "model": 1}, {"data": 4, "model": 2},
               {"data": 8, "model": 1}, {"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16}, {"data": 3, "model": 5}]
SPECS = [(("pod", "data"), None), ("model", None), (None, "model"),
         (None, None, "model"), ("data",), (("data", "model"), None),
         (None, ("pod", "data"), "model")]
SHAPES = [(256, 16), (250, 16), (15, 64), (5, 64, 7), (64,), (12, 30, 16),
          (1, 1), (48, 48, 48)]


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES,
                         ids=lambda m: "x".join(map(str, m.values())))
def test_fit_spec_matches_reference(mesh_shape):
    for shape in SHAPES:
        for spec in SPECS:
            want = jfit_spec(shape, JP(*spec), mesh_shape)
            got = fit_spec(shape, spec, mesh_shape)
            assert isinstance(got, shd.PartitionSpec)
            assert tuple(got) == tuple(want), (shape, spec, mesh_shape)


def _spec_tree(tree):
    """Nested NamedTuples of specs -> nested tuples (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(_spec_tree(x) for x in tree)
    return tuple(tree)


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES[:5],
                         ids=lambda m: "x".join(map(str, m.values())))
@pytest.mark.parametrize("kw", [
    {}, {"tile_size": 32}, {"history_len": 4},
    {"history_len": 4, "aggregation_kind": "self_attn", "tile_size": 32},
    {"num_users": 250, "num_items": 30},
], ids=["plain", "tile", "history", "attn+tile", "ragged"])
def test_state_and_batch_specs_match_reference(mesh_shape, kw):
    base = dict(num_users=USERS, num_items=ITEMS, emb_dim=DIM)
    base.update(kw)
    jcfg, tcfg = jmf.MFConfig(**base), mf.MFConfig(**base)
    want = jmfd.state_specs(jcfg, _fake_jax_mesh(mesh_shape))
    got = mfd.state_specs(tcfg, _fake_mesh(mesh_shape))
    assert _spec_tree(got) == _spec_tree(want)
    for gb in (BATCH, 52):
        want_b = jmfd.batch_specs(jcfg, _fake_jax_mesh(mesh_shape), gb)
        got_b = mfd.batch_specs(tcfg, _fake_mesh(mesh_shape), gb)
        assert tuple(_as_tuple(x) for x in got_b) == \
            tuple(_as_tuple(x) for x in want_b)


def test_int8_tables_are_refused_with_the_reference_message():
    cfg = dict(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
               table_format="int8")
    with pytest.raises(NotImplementedError) as want:
        jmfd.state_specs(jmf.MFConfig(**cfg), mesh=None)
    with pytest.raises(NotImplementedError) as got:
        mfd.state_specs(mf.MFConfig(**cfg), mesh=None)
    assert str(got.value) == str(want.value)
    assert "table_format='fp32' only" in str(got.value)


@pytest.mark.parametrize("rows", [0, 1, 7, 52, 64, 400_000])
def test_shard_bounds_match_reference(rows):
    for shards in (1, 2, 3, 4, 7, 8, 9):
        assert pipeline.shard_bounds(rows, shards) == \
            jpipe.shard_bounds(rows, shards)
    for fn in (pipeline.shard_bounds, jpipe.shard_bounds):
        with pytest.raises(ValueError, match="num_shards"):
            fn(rows, 0)


@pytest.mark.parametrize("step", [0, 7, 1001])
def test_partitioned_batch_bit_identical(step):
    for gb, shards, seed in ((64, 8, 0), (52, 4, 3), (1024, 2, 11)):
        want = jmfd.partitioned_batch(None, step, gb, USERS, shards, seed)
        got = mfd.partitioned_batch(None, step, gb, USERS, shards, seed)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        rows = USERS // shards
        per = gb // shards
        for s in range(shards):
            part = got[s * per:(s + 1) * per]
            assert part.min() >= s * rows and part.max() < (s + 1) * rows


_DS = pipeline.synth_cf_dataset(USERS, ITEMS, interactions_per_user=8)
_DDS = pipeline.device_cf_dataset(_DS, "cpu")


@settings(max_examples=25, deadline=None)
@given(batch=st.integers(1, 48), shards=st.integers(1, 9),
       seed=st.integers(0, 3), step=st.integers(0, 1000))
def test_cf_batch_shard_partitions_exactly(batch, shards, seed, step):
    whole = pipeline.cf_batch_device(_DDS, seed, step, batch, 2)
    parts = [pipeline.cf_batch_shard(_DDS, seed, step, batch, s, shards,
                                     history_len=2) for s in range(shards)]
    sizes = [int(p.user_ids.shape[0]) for p in parts]
    assert sum(sizes) == batch
    assert max(sizes) - min(sizes) <= 1
    assert sorted(sizes, reverse=True) == sizes      # remainder on low shards
    for i, field in enumerate(whole):
        cat = torch.cat([p[i] for p in parts])
        assert cat.dtype == field.dtype
        assert torch.equal(cat, field)


def _quant_inputs():
    r = np.random.default_rng(5)
    x = r.standard_normal((6, 33)).astype(np.float32) * 3
    x[1] = 0.0                                       # the scale floor
    x[2, :5] = [127.0, -63.5, 0.5, -0.5, 1.5]        # exact halves: to even
    x[3] *= 1e-9
    return x


def test_quantize_int8_codes_bit_identical():
    x = _quant_inputs()
    jq, js = (np.asarray(a) for a in jcomp.quantize_int8(jax.numpy.asarray(x)))
    tq, ts = compression.quantize_int8(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-7, atol=0)
    np.testing.assert_array_equal(
        compression.dequantize_int8(tq, ts).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))


def test_compress_with_feedback_matches_reference():
    x = _quant_inputs()
    r = np.random.default_rng(6)
    err = (r.standard_normal(x.shape) * 0.01).astype(np.float32)
    jq, js, jst = jcomp.compress_with_feedback(
        jax.numpy.asarray(x), jcomp.CompressionState(jax.numpy.asarray(err)))
    tq, ts, tst = compression.compress_with_feedback(
        torch.as_tensor(x), compression.CompressionState(torch.as_tensor(err)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    np.testing.assert_allclose(tst.error.numpy(), np.asarray(jst.error),
                               rtol=0, atol=1e-7)
    init = compression.compression_init(torch.as_tensor(x))
    assert init.error.dtype == torch.float32 and not init.error.any()


def test_compressed_psum_over_one_rank_is_the_dequantized_grad():
    g = torch.as_tensor(_quant_inputs())
    st0 = compression.compression_init(g)
    total, st1 = compression.compressed_psum(g, st0, make_data_mesh(1).group(
        "pod"))
    q, s = compression.quantize_int8(g)
    assert torch.equal(total, compression.dequantize_int8(q, s))
    assert torch.equal(st1.error, g - total)


def test_sharded_tiles_distinct_sorted_and_independent():
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(10_000, 8, generator=gen)
    st8 = samplers.sharded_tile_init(gen, table, 64, num_shards=8)
    assert st8.tile_ids.shape == (8, 64) and st8.tile_emb.shape == (8, 64, 8)
    assert st8.step == 0
    assert bool((st8.tile_ids.diff(dim=-1) > 0).all())       # distinct, sorted
    assert torch.equal(st8.tile_emb, table[st8.tile_ids])
    assert len({tuple(row.tolist()) for row in st8.tile_ids}) > 1
    small = torch.zeros(300, 4)
    sh = samplers.sharded_tile_init(gen, small, 16, num_shards=4)
    seen = [sh.tile_ids]
    for _ in range(6):
        sh = samplers.sharded_tile_refresh(sh, gen, small, refresh_interval=2)
        assert bool((sh.tile_ids.diff(dim=-1) > 0).all())
        seen.append(sh.tile_ids)
    # refresh every 2nd call: steps 1, 0, 1, 0, ...
    assert [torch.equal(a, b) for a, b in zip(seen, seen[1:])] == \
        [True, False, True, False, True, False]


def test_mesh_context_helpers_match_reference():
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          devices=jax.devices()[:1])
    specs = [JP(("pod", "data"), None), JP("model", None), JP(None, "pod"),
             JP(("pod",), "data")]
    fake = _fake_mesh({"data": 4, "model": 2})
    with jshd.use_mesh(jmesh), shd.use_mesh(fake):
        assert shd.get_mesh() is fake
        assert shd.mesh_axes() == jshd.mesh_axes()
        for sp in specs:
            assert tuple(shd.resolve(tuple(sp))) == tuple(jshd.resolve(sp))
        assert tuple(shd.batch_spec(None)) == \
            tuple(jshd.resolve(jshd.batch_spec(None)))
        assert shd.data_shards() == 4 and shd.model_shards() == 2
        assert shd.active_mesh() is fake
    assert shd.get_mesh() is None and shd.active_mesh() is None
    assert shd.data_shards() == 1 and shd.model_shards() == 1
    one = make_host_mesh(1, 1)
    with shd.use_mesh(one):
        assert shd.active_mesh() is None          # one rank cannot shard
    assert one.shape == {"data": 1, "model": 1} and one.coords == {
        "data": 0, "model": 0}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_host_mesh(2, 1)
    with pytest.raises(ValueError, match="distinct names"):
        shd.Mesh({"rows": 1})


def _leaves(state):
    return [(n, x) for n, x in ckpt.named_leaves(state)]


@pytest.mark.parametrize("kw", [
    dict(backend="fused", tile_size=32, refresh_interval=5),
    dict(backend="pallas", update_impl="pallas", sampler="uniform"),
    dict(backend="fused", history_len=4, aggregation_kind="self_attn",
         flush_every=3, tile_size=32),
], ids=["fused-tile", "pallas-uniform", "self_attn"])
def test_one_rank_mesh_equals_unsharded_bit_for_bit(kw):
    """A mesh of one rank runs the sharded step with no exchange: the same
    bits as the unsharded step, and the same launches."""
    cfg = mf.MFConfig(num_users=USERS, num_items=ITEMS, emb_dim=DIM,
                      num_negatives=8, **kw)
    runs = [trainer.train_mf(cfg, _DS, 8, batch_size=BATCH,
                             steps_per_dispatch=4, mesh=m, device="cpu",
                             log=lambda *_: None)
            for m in (None, make_data_mesh(1))]
    (s0, l0), (s1, l1) = runs
    assert l0 == l1
    for (n0, a), (n1, b) in zip(_leaves(s0), _leaves(s1), strict=True):
        assert n0 == n1
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, n0
    plan = mfd.make_sharding_plan(cfg, make_data_mesh(1))
    assert plan.users.own == (0, USERS) and plan.items.own == (0, ITEMS)
    assert plan.batch_rows(BATCH) == (0, BATCH)
    whole = plan.gather_state(s1)
    assert whole.params.user_table is s1.params.user_table
    placed = plan.place_state(whole)
    assert torch.equal(placed.params.item_table, s1.params.item_table)
    assert placed.params.item_table.data_ptr() != \
        s1.params.item_table.data_ptr()                  # a copy


def test_plan_refuses_a_batch_smaller_than_the_data_axes():
    plan = dataclasses.replace(
        mfd.make_sharding_plan(mf.MFConfig(num_users=8, num_items=8),
                               make_data_mesh(1)),
        batch_group=shd.AxisGroup(("data",), (0, 1, 2), 0, None))
    with pytest.raises(ValueError, match="cannot be split"):
        plan.batch_rows(2)
    with pytest.raises(ValueError, match="cannot be split"):
        shd.RowShard(shd.AxisGroup(("data",), (0, 1, 2), 0, None), 2)
