"""Production-mesh dry run: every (arch x shape x mesh) cell built and run
once on ``meta`` by one rank of a fake 256- or 512-rank process group (the
port of ``src/repro/launch/dryrun.py``).

The reference lowers and compiles one global program per cell under 512
forced host devices and reads XLA's memory and cost analyses and the HLO's
collectives.  The port has no compiler to ask: each rank runs its own
program, so the dry run *is* one rank's step, with empty ``meta`` tensors
at its slices' shapes (``launch/specs.py``).  Nothing is allocated and
nothing is computed, and the step goes through the same code, exchanges
and kernel wrappers as a real rank's.  The process joins a process group
of the ``fake`` backend (``torch.testing._internal.distributed.fake_pg``),
whose collectives return at once, as rank ``--rank`` of 256
(``single_pod_16x16``) or 512 (``multi_pod_2x16x16``), and builds the mesh
with ``launch/mesh.py::make_production_mesh``.  No card and no other
process is needed.

Each record keeps the reference's keys where their meaning carries over:
``flops`` is the step's FLOPs on this rank by ``torch.utils.flop_counter``'s
formulas (:class:`FlopCounter`; the dense compute is replicated over the
model ranks, ``models/lm.py``), ``collective_bytes`` the result bytes of its
exchanges by kind (``sharding.ExchangeCounter``: every exchange of the port
is an all-gather, so the other kinds are 0), ``memory.argument_bytes`` the
bytes of its inputs on this rank (parameters, optimizer state, batch or
cache; ``memory.argument_parts`` by input) and ``memory.output_bytes`` those
of its outputs.  ``bytes_accessed``, ``memory.temp_bytes`` and
``memory.generated_code_bytes`` have no counterpart on ``meta`` and are
null.  Added: ``mode: "meta"``, the ``dtype`` of each input kind,
``build_s`` and ``run_s``, ``kernels`` (the kernel wrappers' calls on
``meta``), ``flops_excludes`` (the kernels whose work ``flops`` leaves out:
a wrapper's ``meta`` branch computes nothing, and on the card a kernel is a
C call the counter does not see) and ``bounded``, the places whose size the
data decides and that took an upper bound on ``meta``
(``sharding.note_bounded``): a record that names one counts that place's
bytes as the whole list's.

Usage (the process must not already hold a process group of another
size):

  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  ... --mesh multi            # 2x16x16 only
  ... --arch heat-mf          # the paper's MF model only
  ... --layers 2              # L-override, as the reference's
  ... --out dryrun.json --rank 5
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ccl_similarity, embedding_update, flash_attention
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models import lm
from repro_torch.models.config import SHAPES
from repro_torch.models.params import Shard

#: the production meshes: ``--mesh`` name -> (record name, multi_pod, ranks).
MESHES = {"single": ("single_pod_16x16", False, 256),
          "multi": ("multi_pod_2x16x16", True, 512)}

_COUNTERS = (ccl_similarity.STATS_LAUNCHES, ccl_similarity.BWD_LAUNCHES,
             ccl_similarity.SHARED_STATS_LAUNCHES,
             ccl_similarity.SHARED_BWD_LAUNCHES,
             embedding_update.GATHER_FMA_LAUNCHES,
             embedding_update.GATHER_DEQUANT_LAUNCHES,
             flash_attention.FLASH_LAUNCHES)


class FlopCounter(TorchDispatchMode):
    """FLOPs of the ops run under it, by ``FlopCounterMode``'s formulas
    (its registry), counted as each op runs.  ``FlopCounterMode`` itself
    runs an op it has no formula for through the op's decomposition
    (``silu_backward`` is one), which changes that op's arithmetic, so a
    real step counted under it is not the step it counts; this counter
    runs every op as it is, so a counted step keeps its bits and a real
    step's count equals the dry run's.  The totals are equal wherever no
    decomposition holds a counted op (none does on these paths)."""

    def __init__(self):
        super().__init__()
        self.registry = FlopCounterMode(display=False).flop_registry
        self.total = 0

    def get_total_flops(self) -> int:
        """FLOPs counted so far."""
        return self.total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


@contextlib.contextmanager
def fake_process_group(world: int, rank: int = 0):
    """This process as rank ``rank`` of a ``fake``-backend process group of
    ``world`` ranks, destroyed on exit; a group of that size already
    joined is used as it is, one of another size refused."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"this process already holds a process group of "
                f"{dist.get_world_size()} ranks; the dry run needs {world}: "
                "run it as its own process (python -m "
                "repro_torch.launch.dryrun)")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def collective_bytes(counter: shd.ExchangeCounter) -> dict:
    """The counter's result bytes by collective kind (the reference's
    ``collective_bytes`` of a compiled program's HLO)."""
    return dict(counter.bytes)


def _tensors(tree):
    """The tensors of a tree of dicts, NamedTuples, tuples and lists (a
    ``Shard`` counts its local slice)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Shard):
        return [tree.local]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree, each storage once (this rank's
    slices under a mesh)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        key = (t.data_ptr(), t.nbytes) if t.device.type != "meta" else id(t)
        if key not in seen:
            seen.add(key)
            total += t.nbytes
    return total


def _run_once(fn, args):
    """``fn(*args)`` under the flop and exchange counters; returns
    ``(outputs, flops, counter, kernel calls, seconds)``."""
    for c in _COUNTERS:
        c.reset()
    t0 = time.perf_counter()
    with shd.ExchangeCounter() as counter, FlopCounter() as flops:
        out = fn(*args)
    secs = time.perf_counter() - t0
    calls = {c.name: c.count("meta") for c in _COUNTERS if c.count("meta")}
    return out, flops.get_total_flops(), counter, calls, secs


def _record(fields: dict, args, names, out, flops, counter, calls,
            build_s: float, run_s: float, mesh) -> dict:
    parts = {n: tree_bytes(a) for n, a in zip(names, args)}
    rec = dict(fields)
    rec.update({
        "mesh": dict(mesh.shape), "rank": mesh.rank, "mode": "meta",
        "build_s": round(build_s, 3), "run_s": round(run_s, 3),
        "flops": int(flops), "flops_excludes": sorted(calls),
        "bytes_accessed": None,
        "collective_bytes": collective_bytes(counter),
        "bounded": sorted(counter.bounded), "kernels": calls,
        "memory": {"argument_bytes": sum(parts.values()),
                   "argument_parts": parts, "output_bytes": tree_bytes(out),
                   "temp_bytes": None, "generated_code_bytes": None}})
    return rec


def lower_cell(arch: str, shape_name, mesh, *, layers=None,
               opts: lm.TrainOptions | None = None,
               overrides: dict | None = None, optimizer=None) -> dict:
    """One cell's record: ``arch``'s step at ``shape_name`` (a name of
    ``SHAPES`` or a ``ShapeConfig``) built and run once on ``meta`` as this
    rank of ``mesh``.  ``overrides``: ArchConfig field replacements;
    ``layers``: the reference's L-override (enc-dec archs scale both
    stacks; rounded up to whole groups of a hybrid or an interleaved MoE
    stack, whose groups the port's stack runs whole); ``optimizer``: the train step's (``specs.arch_optimizer`` by
    default)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if layers is not None:
        # whole groups: a hybrid stack runs in groups of shared_attn_every
        # layers, an interleaved MoE stack in groups of moe_every
        group = (cfg.shared_attn_every if cfg.family == "hybrid" else
                 cfg.moe_every if cfg.family == "moe" and cfg.moe_every > 1
                 else 1)
        layers = -(-layers // group) * group
        cfg = dataclasses.replace(
            cfg, n_layers=layers,
            encoder_layers=layers if cfg.encoder_layers else 0)
    opts = opts or lm.TrainOptions()
    t0 = time.perf_counter()
    with shd.use_mesh(mesh):
        prog = build_cell(cfg, shape, mesh, opts=opts, optimizer=optimizer)
        build_s = time.perf_counter() - t0
        out, flops, counter, calls, run_s = _run_once(prog.fn, prog.args)
    dtype = {"params": "float32", "tokens": "int64"}
    if shape.kind == "train":
        dtype["opt_state"] = "float32"
    if shape.kind == "decode":
        dtype["cache"] = str(opts.cache_dtype).replace("torch.", "")
    return _record({"arch": arch, "shape": shape.name, "layers": cfg.n_layers,
                    "dtype": dtype}, prog.args, prog.names, out, flops,
                   counter, calls, build_s, run_s, mesh)


def lower_mf_cell(shape_name: str, mesh, *, users=None, items=None) -> dict:
    """One record of the paper's own model (sharded HEAT MF,
    ``core/mf_distributed.py``) at Amazon Product Reviews scale
    (``AMAZON``; ``users``/``items`` resize it) on ``mesh``."""
    from repro_torch.configs.heat_mf import AMAZON
    from repro_torch.core.mf_distributed import MF_SHAPES, build_mf_cell

    cfg = AMAZON
    if users or items:
        cfg = dataclasses.replace(cfg, num_users=users or cfg.num_users,
                                  num_items=items or cfg.num_items)
    shape = MF_SHAPES[shape_name]
    t0 = time.perf_counter()
    with shd.use_mesh(mesh):
        fn, args, _, _ = build_mf_cell(cfg, mesh, shape.global_batch)
        build_s = time.perf_counter() - t0
        out, flops, counter, calls, run_s = _run_once(fn, args)
    return _record({"arch": "heat-mf-amazon", "shape": shape_name,
                    "dtype": {"tables": cfg.dtype, "ids": "int64"}},
                   args, ("state", "batch", "rng"), out, flops, counter,
                   calls, build_s, run_s, mesh)


def _ok_line(tag: str, rec: dict) -> str:
    return (f"[dryrun] OK    {tag}  build={rec['build_s']}s "
            f"run={rec['run_s']}s flops={rec['flops']:.3e} "
            f"coll={sum(rec['collective_bytes'].values()):.3e}B "
            f"args={rec['memory']['argument_bytes']:.3e}B"
            + (f" bounded={rec['bounded']}" if rec["bounded"] else ""))


def run(args) -> int:
    """Run the selected cells on the selected production meshes, one fake
    process group per mesh; returns a process exit code."""
    meshes = [MESHES[m] for m in (("single", "multi") if args.mesh == "both"
                                  else (args.mesh,))]
    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    shapes = [args.shape] if args.shape else list(SHAPES)
    results, failures = [], []

    from repro_torch.core.mf_distributed import MF_SHAPES
    mf_shapes = []
    if args.arch in (None, "heat-mf"):
        mf_shapes = ([args.shape] if args.shape in MF_SHAPES
                     else list(MF_SHAPES)
                     if args.arch == "heat-mf" or not args.shape else [])
    if args.arch == "heat-mf":
        archs = []
    cells = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            reason = cfg.skip_reason(shape_name)
            if reason:
                results.append({"arch": arch, "shape": shape_name,
                                "mode": "meta", "status": "skip",
                                "reason": reason})
                print(f"[dryrun] SKIP  {arch} x {shape_name}: {reason}")
                continue
            cells.append((arch, shape_name))

    def attempt(tag, fields, make, mesh_name):
        try:
            rec = make()
            rec.update(status="ok", mesh_name=mesh_name)
            results.append(rec)
            print(_ok_line(tag, rec), flush=True)
            if args.verbose:
                print(json.dumps(rec["memory"]))
        except Exception as e:  # noqa: BLE001 — report, keep going
            failures.append(tag)
            results.append(dict(fields, mesh_name=mesh_name, mode="meta",
                                status="fail",
                                error=f"{type(e).__name__}: {e}"))
            print(f"[dryrun] FAIL  {tag}: {type(e).__name__}: {e}", flush=True)
            if args.verbose:
                traceback.print_exc()

    for mesh_name, multi, world in meshes:
        with fake_process_group(world, args.rank):
            mesh = make_production_mesh(multi_pod=multi)
            for shape_name in mf_shapes:
                attempt(f"heat-mf-amazon x {shape_name} x {mesh_name}",
                        {"arch": "heat-mf-amazon", "shape": shape_name},
                        lambda: lower_mf_cell(shape_name, mesh), mesh_name)
            for arch, shape_name in cells:
                attempt(f"{arch} x {shape_name} x {mesh_name}",
                        {"arch": arch, "shape": shape_name},
                        lambda: lower_cell(arch, shape_name, mesh,
                                           layers=args.layers), mesh_name)
            del mesh

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.out} ({len(results)} records)")
    print(f"[dryrun] {len(failures)} failures"
          + (f": {failures}" if failures else ""))
    return 1 if failures else 0


def main():
    """CLI entry: parse the arguments and run the dry run."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None,
                   help="an arch id, or heat-mf for the MF model alone")
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--rank", type=int, default=0,
                   help="the rank of the fake process group this process is")
    p.add_argument("--verbose", action="store_true")
    sys.exit(run(p.parse_args()))


if __name__ == "__main__":
    main()
