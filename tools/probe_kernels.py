#!/usr/bin/env python3
"""Where the time of the port's redesigned kernels goes, on one CUDA card.

    python3 tools/probe_kernels.py [--parts stats,bwd,bwd_mf,stats_mf,flash,ties,dequant,
                                            segment_sum,launches,step_stats,l2] [--earlier DIR]

Each part prints one line per measurement with the card's name and power
limit; the last line is the card alone.  Needs the card; imports nothing of
JAX.  Kernel times are taken as chip_smoke.py takes them (the median of 30
CUDA-event timings, the L2 cache evicted first), unless a part says
otherwise.

- ``stats``: ``src/repro_torch/csrc/ccl_stats_shared.cu`` at the LM head's
  shape (T = 8,184, K = 960, n = 64, as in chip_smoke.py phase 11) with two
  copies of it: "loads only", whose K loop streams u, p and the negatives
  through its ring and computes nothing, and "compute only", whose K loop
  computes on whatever the ring holds and loads nothing (its results are
  garbage; only its time is read); ``torch.matmul(u, negs.T)`` and
  ``torch.add(u, p)`` (a plain pass that reads u and p); at phase 3's
  row-update shape (2,048 ids into a 400,000 x 128 table) the gather-FMA
  kernel and ``index_add_``; and a one-element kernel, the floor of this
  way of timing.  Each once after each of two ways of evicting the 50 MB
  L2: writing a 256 MB buffer (chip_smoke.py's flush, which leaves the L2
  full of dirty lines that a kernel's reads must first write back) and
  reading it (clean lines).
- ``bwd``: ``csrc/ccl_bwd_shared.cu`` at the same shape, and copies of it
  built with ``-DPROBE_NO_COMPUTE`` (its loads and stores, no MMAs),
  ``-DPROBE_NO_LOADS`` (its MMAs and stores, none of the loads of u, p and
  the ring) and both (neither: what is left is its skeleton of barriers,
  u_hat staging, epilogue arithmetic and stores), both flushes; and the
  device time of each of its three passes from torch.profiler over 20
  calls.
- ``bwd_mf``: ``csrc/ccl_bwd.cu`` (the per-example backward) at the MF
  step's shape (B = 1,024, n = 64, K = 128, as in chip_smoke.py phase 3),
  and copies of it built with ``-DPROBE_NO_LOADS`` (no negatives read),
  ``-DPROBE_NO_STORES`` (no ``dn`` written) and both, beside
  ``torch.add(u, p)`` and ``negs.clone()`` as stream references, both
  flushes.  With ``--earlier``, the earlier checkout's kernel too, and the
  two timed in alternation.
- ``stats_mf``: ``csrc/ccl_stats.cu`` (the per-example stats) at the MF
  step's shape (B = 1,024, n = 64, K = 128), and copies of it built with
  ``-DPROBE_NO_LOADS`` (no negatives read), ``-DPROBE_NO_STORES`` (no
  ``nn``/``un`` written) and both, and the variants of
  ``STATS_MF_VARIANTS`` (text edits of the source), beside
  ``einsum("bk,bnk->bn")`` (``un`` alone) and
  ``torch.linalg.vector_norm(negs, dim=-1)`` (one read of the negatives),
  both flushes; each whole kernel is checked against its plain version and
  called twice for the same bits.  With ``--earlier``, the earlier
  checkout's kernel too, and the two timed in alternation after each flush.
- ``flash``: ``csrc/flash_attention.cu`` (fp32 on the SIMT pipes), copies
  of it without the FMAs of q k^T and without those of P v (garbage
  results; only their time is read), at smollm-360m's attention
  shape (B=8, Hq=15, Hkv=5, S=1,024, D=64), causal and full: each one's
  time, and its largest error against the plain version
  (``ref.attention_ref``) and whether every element is within
  chip_smoke.py's 1e-6 + 1e-5*|plain|, on unit-normal q, k, v and on q, k
  scaled by 4 (logits 16 times larger, as the model's own are: chip_smoke.py
  phase 12).
- ``ties``: the two kernels whose times PR 15 found level with their
  library calls, timed in alternation (kernel, library, library, kernel)
  over 100 repetitions, with the median and the 10th and 90th percentiles
  of each: the gather-dequant kernel at the int8 ``AMAZON`` step's user
  gather (1,024 ids into a 20,980,000 x 128 int8 table) against
  ``q.index_select``, and the per-example stats kernel at the MF step's
  shape (B = 1,024, n = 64, K = 128) against ``einsum("bk,bnk->bn")``.
- ``dequant``: the gather-dequant kernel at the int8 ``AMAZON`` step's three
  gathers, on random int8 tables of the model's sizes and uniform ids: user
  (1,024 ids into 20,980,000 x 128), positive (1,024 into 9,350,000 x 128)
  and history (16,384 into 9,350,000 x 128), each checked bit for bit
  against its plain version, then timed in alternation with
  ``q.index_select`` and a one-element kernel (the floor of this way of
  timing), as ``ties`` does; with ``--earlier``, the earlier checkout's
  kernel joins the alternation.
- ``segment_sum``: ``csrc/segment_sum.cu`` (kernel #8) at the three shapes
  of the benchmark's segment sums, on sorted ids read through a random
  permutation: the int8 item update's duplicate pre-reduce at batch 16,384
  (1,655,808 positions, one run of 1,589,248, num_segments = positions) and
  at batch 1,024 (104,448 positions, one run of 99,328), and the slot
  reduction at batch 65,536 (4,194,304 positions into 1,024 slots), K = 128.
  Each shape: the kernel, its variants (``SEGMENT_VARIANTS``), the kernel
  at the other pieces of ``SEGMENT_PIECES`` and on values already in sorted
  order, each checked bit for bit against the plain version on the CPU at
  its piece and with its device time split by operation (torch.profiler, 5
  calls), then the kernel as shipped,
  its plain version and the library path it replaced
  (``sorted_segment_sum_library``: the sorted copy and ``segment_reduce``),
  each the median of 30 timings.
- ``launches``: the fp32 ``MF_100M_PALLAS`` step (chip_smoke.py phase 5's
  configuration and dataset) profiled over three 16-step windows, with
  ``sorted_segment_sum`` as it is, as the library path it replaced
  (``sorted_segment_sum_library``), and as it is again: device events per
  step (also as chip_smoke.py phase 7 counts them), and for each operator
  that launched any (with its parent operators) its launches per step and
  their kernels' names.
- ``step_stats`` (needs ``--earlier``): the same step profiled over 16-step
  windows with the current and the earlier checkout's ``ccl_stats.cu``, in
  the order current, earlier, earlier, current: the step's device time and
  the stats kernel's, per step.

- ``l2``: the L2's read rate, which sets ``core/tiling.py``'s
  ``HardwareModel.cache_bandwidth``: a kernel (``L2_READ_SRC``, built here)
  whose threads reread a buffer that fits in the L2 with 16-byte loads that
  bypass L1 (``__ldcg``), at each of ``L2_SIZES_MB`` and launch shapes
  ``L2_LAUNCHES``, in two sweeps (sizes rising, then falling), and at 1 GB
  (from HBM) for comparison; bytes read (4 GB a call, after a warm-up
  call) over the median, p10 and p90 of 20 CUDA-event timings, beside the
  card's ``L2_cache_size``.  Its last line is the default: the median over
  ``L2_DEFAULT_MB`` of each size's best launch shape, mean of the sweeps.

``--earlier DIR`` names the root of an earlier checkout of this repository
(for example ``git archive`` of a parent commit unpacked under ``build/``):
parts ``bwd_mf``, ``stats_mf``, ``step_stats`` and ``dequant`` then also
build that checkout's ``ccl_bwd.cu``, ``ccl_stats.cu`` and
``gather_dequant.cu`` and time them beside the current ones in the same
run.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT_DIR = os.path.join(ROOT, "build", "probe_kernels")
T, K, N_NEG = 8 * 1023, 960, 64
ROWS, B = 400_000, 1024
AMAZON_USERS = 20_980_000
AMAZON_ITEMS = 9_350_000
PARTS = ("stats", "bwd", "bwd_mf", "stats_mf", "flash", "ties", "dequant", "segment_sum",
         "launches", "step_stats", "l2")
_BWD_MF_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
    ctypes.c_void_p]
_DEQUANT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_STATS_MF_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
#: variants of ``csrc/ccl_stats.cu`` that part ``stats_mf`` also times:
#: label -> ((text of the source, its replacement), ...).
_GROUP = "constexpr int kGroup = 4;"
_LOAD, _LDCS = "nb[(size_t)j * KV + col]", "__ldcs(nb + (size_t)j * KV + col)"
STATS_MF_VARIANTS = {
    "ccl_stats, plain loads": ((_LDCS, _LOAD),),
    "ccl_stats, last-use loads": ((_LDCS, "__ldlu(nb + (size_t)j * KV + col)"),),
    "ccl_stats, 2 negatives a warp": ((_GROUP, "constexpr int kGroup = 2;"),),
    "ccl_stats, 8 negatives a warp": ((_GROUP, "constexpr int kGroup = 8;"),),
    "ccl_stats, 16 negatives a warp": ((_GROUP, "constexpr int kGroup = 16;"),),
    "ccl_stats, 16 negatives a warp, plain loads (the first design)": (
        (_GROUP, "constexpr int kGroup = 16;"), (_LDCS, _LOAD)),
}

_COMPUTE = "    const float* su = ring + (c % STAGES) * STAGE_FLOATS;"
_LOOP_END = "  cp_async_wait<0>();"
_LOADS = ("if (c + STAGES - 1 < chunks) load(c + STAGES - 1);", "if (c < chunks) load(c);")


def stats_variants(src: str) -> dict[str, tuple[str, tuple[str, ...]]]:
    """The stats kernel's source and its "loads only" and "compute only"
    copies, each with no extra compiler flags."""
    for anchor in (_COMPUTE, _LOOP_END, *_LOADS):
        if anchor not in src:
            raise ValueError(f"ccl_stats_shared.cu no longer contains {anchor!r}")
    i0 = src.index(_COMPUTE)
    i1 = src.index(_LOOP_END, i0)
    loads_only = (src[:i0]
                  + "    acc[0][0][0] += ring[(c % STAGES) * STAGE_FLOATS + tid];\n  }\n"
                  + src[i1:])
    compute_only = src
    for anchor in _LOADS:
        compute_only = compute_only.replace(anchor, "")
    return {"ccl_stats_shared": (src, ()),
            "ccl_stats_shared, loads only": (loads_only, ()),
            "ccl_stats_shared, compute only": (compute_only, ())}


def bwd_variants(src: str) -> dict[str, tuple[str, tuple[str, ...]]]:
    """The shared backward's source as it is, without its MMAs, without its
    loads, and without either (the source's ``PROBE_NO_*`` switches)."""
    for macro in ("PROBE_NO_COMPUTE", "PROBE_NO_LOADS"):
        if macro not in src:
            raise ValueError(f"ccl_bwd_shared.cu no longer reads {macro}")
    return {"ccl_bwd_shared": (src, ()),
            "ccl_bwd_shared, loads only": (src, ("-DPROBE_NO_COMPUTE",)),
            "ccl_bwd_shared, compute only": (src, ("-DPROBE_NO_LOADS",)),
            "ccl_bwd_shared, neither": (src, ("-DPROBE_NO_LOADS", "-DPROBE_NO_COMPUTE"))}


def bwd_mf_variants(src: str) -> dict[str, tuple[str, tuple[str, ...]]]:
    """The per-example backward's source as it is, without its negatives
    loads, without its ``dn`` stores, and without either."""
    for macro in ("PROBE_NO_LOADS", "PROBE_NO_STORES"):
        if macro not in src:
            raise ValueError(f"ccl_bwd.cu no longer reads {macro}")
    return {"ccl_bwd": (src, ()),
            "ccl_bwd, no negatives loads": (src, ("-DPROBE_NO_LOADS",)),
            "ccl_bwd, no dn stores": (src, ("-DPROBE_NO_STORES",)),
            "ccl_bwd, neither": (src, ("-DPROBE_NO_LOADS", "-DPROBE_NO_STORES"))}


def stats_mf_variants(src: str) -> dict[str, tuple[str, tuple[str, ...]]]:
    """The per-example stats kernel's source as it is, without its negatives
    loads, without its ``nn``/``un`` stores, without either, and the text
    variants of :data:`STATS_MF_VARIANTS`."""
    for macro in ("PROBE_NO_LOADS", "PROBE_NO_STORES"):
        if macro not in src:
            raise ValueError(f"ccl_stats.cu no longer reads {macro}")
    out = {"ccl_stats": (src, ()),
           "ccl_stats, no negatives loads": (src, ("-DPROBE_NO_LOADS",)),
           "ccl_stats, no nn/un stores": (src, ("-DPROBE_NO_STORES",)),
           "ccl_stats, neither": (src, ("-DPROBE_NO_LOADS", "-DPROBE_NO_STORES"))}
    for name, edits in STATS_MF_VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise ValueError(f"ccl_stats.cu no longer contains {old!r}")
            text = text.replace(old, new)
        out[name] = (text, ())
    return out


def earlier_source(earlier: str | None, name: str) -> dict[str, tuple[str, tuple[str, ...]]]:
    """``{label: (source, ())}`` for ``csrc/<name>.cu`` of the earlier
    checkout at ``earlier``, or nothing when none was given."""
    if not earlier:
        return {}
    with open(os.path.join(earlier, "src", "repro_torch", "csrc", f"{name}.cu")) as f:
        return {f"{name} (earlier checkout)": (f.read(), ())}


def bind(lib: ctypes.CDLL, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``lib.symbol`` with its argument types and an int result."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def build(variants: dict[str, tuple[str, tuple[str, ...]]], tag: str,
          logs: dict | None = None) -> dict[str, ctypes.CDLL]:
    """Compile every variant in parallel, one nvcc each, and load them;
    each compiler output goes into ``logs`` when one is given."""
    from repro_torch.kernels import _build
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for i, (name, (src, flags)) in enumerate(variants.items()):
        cu, so = (os.path.join(OUT_DIR, f"{tag}{i}{ext}") for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if logs is not None:
            logs[name] = log
        libs[name] = ctypes.CDLL(so)
    return libs


def read_source(name: str) -> str:
    """``csrc/<name>.cu`` as text."""
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        return f.read()


def sorted_segment_sum_library(sidx, values, num_segments: int, order=None):
    """``core/tiling.py::sorted_segment_sum`` as the library path that kernel
    #8 replaced: the sorted copy ``values[order]``, then one
    ``segment_reduce`` that sums each run in order."""
    from repro_torch.kernels import segment_sum
    return segment_sum.sequential_sum(sidx, values if order is None else values[order],
                                      num_segments)


class Timer:
    """CUDA-event timings of single calls after an L2 eviction."""

    def __init__(self, dev):
        import torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB > L2

    def once(self, fn, evict) -> float:
        """One timing (ms) of ``fn()``: ``evict()``, a device-side sleep that
        holds the stream while the host enqueues, then the events."""
        import torch
        evict()
        torch.cuda._sleep(4_000_000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def median(self, fn, evict=None, reps: int = 30) -> float:
        """Median of ``reps`` timings after 3 warm-up calls (default eviction:
        the written flush)."""
        evict = evict or self.flush.zero_
        for _ in range(3):
            fn()
        return statistics.median(self.once(fn, evict) for _ in range(reps))


def card_line() -> str:
    """``name, power.limit`` of card 0 as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def both_flushes(calls: dict, timer: Timer, card: str) -> None:
    """Print each call's median after a written and after a read flush."""
    for name, fn in calls.items():
        dirty = timer.median(fn, timer.flush.zero_)
        clean = timer.median(fn, timer.flush.sum)
        print(f"{name}: {1e3 * dirty:.1f} us after a written flush, {1e3 * clean:.1f} us "
              f"after a read flush | {card}", flush=True)


def shared_inputs(dev):
    """u, p, negs at the LM head's shape, and their stats."""
    import torch
    from repro_torch.kernels import ccl_similarity
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = torch.randn(T, K, generator=gen, device=dev)
    p = 0.1 * torch.randn(T, K, generator=gen, device=dev)
    negs = 0.1 * torch.randn(N_NEG, K, generator=gen, device=dev)
    return u, p, negs, ccl_similarity.ccl_stats_shared_plain(u, p, negs)


def part_stats(dev, timer: Timer, card: str) -> None:
    """The step-shared stats kernel and its copies; the gather-FMA kernel."""
    import torch
    from repro_torch.kernels import embedding_update
    libs = build(stats_variants(read_source("ccl_stats_shared")), "stats")
    u, p, negs, _ = shared_inputs(dev)
    outs = [torch.empty(T, 1, device=dev) for _ in range(3)] + [
        torch.empty(1, N_NEG, device=dev), torch.empty(T, N_NEG, device=dev)]
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, lib in libs.items():
        fn = lib.ccl_stats_shared
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        args = (u.data_ptr(), p.data_ptr(), negs.data_ptr(), *(o.data_ptr() for o in outs),
                T, N_NEG, K, stream)
        if fn(*args) != 0:
            raise RuntimeError(f"{name}: launch failed")
        calls[name] = lambda fn=fn, args=args: fn(*args)
    calls["torch.matmul(u, negs.T)"] = lambda: torch.matmul(u, negs.T)
    calls["torch.add(u, p)"] = lambda: torch.add(u, p)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = 0.1 * torch.randn(ROWS, 128, generator=gen, device=dev)
    tile_ids = torch.randperm(ROWS, generator=gen, device=dev)[:B]
    ids = torch.cat([tile_ids[torch.randint(0, B, (B // 2,), generator=gen, device=dev)],
                     torch.randint(0, ROWS, (B // 2,), generator=gen, device=dev),
                     tile_ids])                 # chip_smoke.py phase 3's 2,048 ids
    grads = torch.randn(2 * B, 128, generator=gen, device=dev)
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    calls["gather_fma"] = lambda: embedding_update.gather_fma_rows_(table, sids, order,
                                                                     grads, 0.05)
    calls["index_add_"] = lambda: table.index_add_(0, ids, grads, alpha=-0.05)
    one = torch.zeros(1, device=dev)
    calls["one-element kernel"] = lambda: one.add_(1)
    both_flushes(calls, timer, card)


def part_bwd(dev, timer: Timer, card: str) -> None:
    """The shared backward and its copies without compute and without loads;
    the device time of each of its passes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ccl_similarity
    libs = build(bwd_variants(read_source("ccl_bwd_shared")), "bwd")
    u, p, negs, stats = shared_inputs(dev)
    w = torch.full((T, 1), 1.0 / T, device=dev)
    g = torch.full((1,), float(T), device=dev)
    du, dp, dn = torch.empty_like(u), torch.empty_like(p), torch.empty_like(negs)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, lib in libs.items():
        nbytes_fn = lib.ccl_bwd_shared_scratch_bytes
        nbytes_fn.argtypes = [ctypes.c_int] * 3
        nbytes_fn.restype = ctypes.c_size_t
        scratch = torch.empty(int(nbytes_fn(T, N_NEG, K)), dtype=torch.uint8, device=dev)
        fn = lib.ccl_bwd_shared
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        args = (u.data_ptr(), p.data_ptr(), negs.data_ptr(),
                *(x.data_ptr() for x in stats), w.data_ptr(), g.data_ptr(), du.data_ptr(),
                dp.data_ptr(), dn.data_ptr(), scratch.data_ptr(), T, N_NEG, K, 1.0, 0.0,
                stream)
        if fn(*args) != 0:
            raise RuntimeError(f"{name}: launch failed")
        calls[name] = lambda fn=fn, args=args, scratch=scratch: fn(*args)
    calls["torch.add(u, p)"] = lambda: torch.add(u, p)
    both_flushes(calls, timer, card)

    bwd_args = (u, p, negs, *stats, w, g)
    for _ in range(3):
        ccl_similarity.ccl_bwd_shared(*bwd_args, mu=1.0, theta=0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            timer.flush.zero_()
            ccl_similarity.ccl_bwd_shared(*bwd_args, mu=1.0, theta=0.0)
        torch.cuda.synchronize()
    passes = {e.key: e.self_device_time_total / e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and any(k in e.key for k in ("scalars_kernel", "tile_kernel", "reduce_kernel"))}
    if not passes:
        print("ccl_bwd_shared passes: the profiler saw no device time: not measured")
    for name, us in passes.items():
        print(f"ccl_bwd_shared pass {name[:60]}: {us:.1f} us per call (profiler, after "
              f"a written flush) | {card}", flush=True)


def alternate(timer: Timer, calls: dict, reps: int = 100, evict=None) -> dict:
    """Timings (ms) of each of ``calls`` taken in their order and then in the
    reverse order (kernel, library, library, kernel for two), ``reps``
    times, each after ``evict()`` (default: the written flush)."""
    evict = evict or timer.flush.zero_
    for _ in range(3):
        for fn in calls.values():
            fn()
    times = {name: [] for name in calls}
    order = list(calls) + list(calls)[::-1]
    for _ in range(reps):
        for name in order:
            times[name].append(timer.once(calls[name], evict))
    return times


def spread(xs) -> str:
    """Median and the 10th and 90th percentiles, in us."""
    q = statistics.quantiles(xs, n=10)
    return (f"median {1e3 * statistics.median(xs):.2f} us (p10 {1e3 * q[0]:.2f}, "
            f"p90 {1e3 * q[-1]:.2f}; {len(xs)} timings)")


_FLASH_CUTS = {
    "flash_attention, no P v FMAs": (
        "            acc[i][c].x = fmaf(pw, vv[c].x, acc[i][c].x);\n"
        "            acc[i][c].y = fmaf(pw, vv[c].y, acc[i][c].y);\n"
        "            acc[i][c].z = fmaf(pw, vv[c].z, acc[i][c].z);\n"
        "            acc[i][c].w = fmaf(pw, vv[c].w, acc[i][c].w);",
        "            acc[i][c].x += pw;"),
    "flash_attention, no q k^T FMAs": (
        "        for (int j = 0; j < KJ; ++j) s[i][j] = dot4(s[i][j], qv[i], kv[j]);",
        "        for (int j = 0; j < KJ; ++j) s[i][j] += qv[i].x + kv[j].x;"),
}


def part_flash(dev, timer: Timer, card: str) -> None:
    """The flash kernel and its cut copies: time and accuracy."""
    import torch
    from repro_torch.kernels import ref
    src = read_source("flash_attention")
    srcs = {"flash_attention": (src, ())}
    for name, (old, new) in _FLASH_CUTS.items():
        if old not in src:
            raise ValueError(f"flash_attention.cu no longer contains {old!r}")
        srcs[name] = (src.replace(old, new), ())
    libs = build(srcs, "flash")
    b, hq, hkv, s, d = 8, 15, 5, 1024, 64
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    q = torch.randn(b, hq, s, d, generator=gen, device=dev)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)
    for causal in (True, False):
        for qk_scale in (1.0, 4.0):
            qq, kk = q * qk_scale, k * qk_scale
            want = ref.attention_ref(qq, kk, v, causal=causal)
            for name, lib in libs.items():
                fn = lib.flash_attention_fwd
                fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
                fn.restype = ctypes.c_int
                args = (qq.data_ptr(), kk.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
                        hkv, s, d, d ** -0.5, int(causal), stream)
                if fn(*args) != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                if name in _FLASH_CUTS:
                    if qk_scale == 1.0:
                        ms = timer.median(lambda fn=fn, args=args: fn(*args))
                        print(f"{name} {'causal' if causal else 'full'}: {1e3 * ms:.1f} us "
                              f"| {card}", flush=True)
                    continue
                diff = (out - want).abs()
                ok = bool((diff <= 1e-6 + 1e-5 * want.abs()).all())
                ms = timer.median(lambda fn=fn, args=args: fn(*args)) if qk_scale == 1.0 else None
                when = f"{1e3 * ms:.1f} us, " if ms is not None else ""
                print(f"{name} {'causal' if causal else 'full'}, q and k x{qk_scale:g}: "
                      f"{when}max abs err {diff.max().item():.3e}, within tolerance: {ok} "
                      f"| {card}", flush=True)


def part_ties(dev, timer: Timer, card: str) -> None:
    """#5's user gather against q.index_select and #1 against einsum."""
    import torch
    from repro_torch.kernels import ccl_similarity, embedding_update
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q8 = torch.randint(-127, 128, (AMAZON_USERS, 128), generator=gen, device=dev,
                       dtype=torch.int8)
    scale = torch.rand(AMAZON_USERS, 1, generator=gen, device=dev) * 1e-2 + 1e-4
    ids = torch.randint(0, AMAZON_USERS, (B,), generator=gen, device=dev)
    ks, ls = alternate(timer, {
        "kernel": lambda: embedding_update.gather_dequant_rows(q8, scale, ids),
        "library": lambda: q8.index_select(0, ids)}).values()
    print(f"tie gather_dequant (user gather, {B} ids into {AMAZON_USERS} x 128 int8): "
          f"kernel {spread(ks)}; q.index_select {spread(ls)} | {card}", flush=True)
    del q8, scale
    u = 0.1 * torch.randn(B, 128, generator=gen, device=dev)
    p = 0.1 * torch.randn(B, 128, generator=gen, device=dev)
    negs = 0.1 * torch.randn(B, N_NEG, 128, generator=gen, device=dev)
    ks, ls = alternate(timer, {
        "kernel": lambda: ccl_similarity.ccl_stats(u, p, negs),
        "library": lambda: torch.einsum("bk,bnk->bn", u, negs)}).values()
    print(f"tie ccl_stats (B={B}, n={N_NEG}, K=128): kernel {spread(ks)}; "
          f"einsum {spread(ls)} | {card}", flush=True)


def part_bwd_mf(dev, timer: Timer, card: str, earlier: str | None) -> None:
    """The per-example backward and its copies without loads or stores, and
    the earlier checkout's kernel where one is given."""
    import torch
    from repro_torch.kernels import ccl_similarity
    variants = bwd_mf_variants(read_source("ccl_bwd"))
    variants.update(earlier_source(earlier, "ccl_bwd"))
    libs = build(variants, "bwd_mf")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = 0.1 * torch.randn(B, 128, generator=gen, device=dev)
    p = 0.1 * torch.randn(B, 128, generator=gen, device=dev)
    negs = 0.1 * torch.randn(B, N_NEG, 128, generator=gen, device=dev)
    stats = ccl_similarity.ccl_stats_plain(u, p, negs)
    g = torch.ones(1, device=dev)
    want = ccl_similarity.ccl_bwd_plain(u, p, negs, *stats, g, mu=1.0, theta=0.0)
    outs = [torch.empty_like(u), torch.empty_like(p), torch.empty_like(negs)]
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, lib in libs.items():
        fn = bind(lib, "ccl_bwd", _BWD_MF_ARGS)
        args = (u.data_ptr(), p.data_ptr(), negs.data_ptr(), *(x.data_ptr() for x in stats),
                g.data_ptr(), *(o.data_ptr() for o in outs), B, N_NEG, 128, 1.0, 0.0, stream)
        if fn(*args) != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        if "," not in name:                     # the whole kernels: check them
            for o, w in zip(outs, want):
                if not bool(((o - w).abs() <= 1e-6 + 1e-5 * w.abs()).all()):
                    raise AssertionError(f"{name} disagrees with ccl_bwd_plain")
        calls[name] = lambda fn=fn, args=args: fn(*args)
    calls["torch.add(u, p)"] = lambda: torch.add(u, p)
    calls["negs.clone()"] = lambda: negs.clone()
    both_flushes(calls, timer, card)
    if earlier:
        pair = {n: calls[n] for n in ("ccl_bwd", "ccl_bwd (earlier checkout)")}
        for name, ts in alternate(timer, pair).items():
            print(f"alternated {name} (B={B}, n={N_NEG}, K=128): {spread(ts)} | {card}",
                  flush=True)


def part_stats_mf(dev, timer: Timer, card: str, earlier: str | None) -> None:
    """The per-example stats kernel, its copies without loads or stores, its
    variants, and the earlier checkout's kernel where one is given."""
    import torch
    from repro_torch.kernels import ccl_similarity
    variants = stats_mf_variants(read_source("ccl_stats"))
    variants.update(earlier_source(earlier, "ccl_stats"))
    logs = {}
    libs = build(variants, "stats_mf", logs)
    for name, log in logs.items():
        regs = [line.split("Used ")[-1].strip() for line in log.splitlines() if "Used" in line]
        print(f"{name}: {' / '.join(regs)} (scalar / float4 path)", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = 0.1 * torch.randn(B, 128, generator=gen, device=dev)
    p = 0.1 * torch.randn(B, 128, generator=gen, device=dev)
    negs = 0.1 * torch.randn(B, N_NEG, 128, generator=gen, device=dev)
    want = ccl_similarity.ccl_stats_plain(u, p, negs)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, lib in libs.items():
        fn = bind(lib, "ccl_stats", _STATS_MF_ARGS)
        outs = [torch.empty(B, 1, device=dev) for _ in range(3)] + [
            torch.empty(B, N_NEG, device=dev) for _ in range(2)]
        args = (u.data_ptr(), p.data_ptr(), negs.data_ptr(), *(o.data_ptr() for o in outs),
                B, N_NEG, 128, 1, stream)
        if fn(*args) != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        if "no " not in name and "neither" not in name:     # whole kernels: check them
            first = [o.clone() for o in outs]
            if fn(*args) != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            for o, o1, w in zip(outs, first, want):
                if not bool(((o - w).abs() <= 1e-6 + 1e-5 * w.abs()).all()):
                    raise AssertionError(f"{name} disagrees with ccl_stats_plain")
                if not torch.equal(o, o1):
                    raise AssertionError(f"{name}: two calls differ")
        calls[name] = lambda fn=fn, args=args, outs=outs: fn(*args)
    calls["einsum(bk,bnk->bn)"] = lambda: torch.einsum("bk,bnk->bn", u, negs)
    calls["vector_norm(negs, dim=-1)"] = lambda: torch.linalg.vector_norm(negs, dim=-1)
    both_flushes(calls, timer, card)
    if earlier:
        pair = {n: calls[n] for n in ("ccl_stats", "ccl_stats (earlier checkout)")}
        for flush, evict in (("written", None), ("read", timer.flush.sum)):
            for name, ts in alternate(timer, pair, evict=evict).items():
                print(f"alternated {name} (B={B}, n={N_NEG}, K=128), after a {flush} flush: "
                      f"{spread(ts)} | {card}", flush=True)


def part_dequant(dev, timer: Timer, card: str, earlier: str | None) -> None:
    """#5 at the int8 AMAZON step's three gathers, in alternation with
    q.index_select, a one-element kernel and the earlier checkout's kernel
    where one is given."""
    import torch
    from repro_torch.kernels import embedding_update
    fns = {name: bind(lib, "gather_dequant_rows", _DEQUANT_ARGS)
           for name, lib in build(earlier_source(earlier, "gather_dequant"),
                                  "dequant").items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    one = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for table, rows in (("user", AMAZON_USERS), ("item", AMAZON_ITEMS)):
        q8 = torch.randint(-127, 128, (rows, 128), generator=gen, device=dev,
                           dtype=torch.int8)
        scale = torch.rand(rows, 1, generator=gen, device=dev) * 1e-2 + 1e-4
        cases = ([("user", B)] if table == "user"
                 else [("positive", B), ("history", 16 * B)])
        for case, n_ids in cases:
            ids = torch.randint(0, rows, (n_ids,), generator=gen, device=dev)
            want = embedding_update.gather_dequant_rows_plain(q8, scale, ids)
            got = embedding_update.gather_dequant_rows(q8, scale, ids)
            if not torch.equal(got, want):
                raise AssertionError(f"gather_dequant {case}: differs from its plain version")
            calls = {"kernel": lambda q8=q8, scale=scale, ids=ids:
                     embedding_update.gather_dequant_rows(q8, scale, ids)}
            for name, fn in fns.items():
                out = torch.empty_like(want)
                args = (q8.data_ptr(), scale.data_ptr(), ids.data_ptr(), out.data_ptr(),
                        n_ids, 128, stream)
                if fn(*args) != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} differs from the plain version")
                calls[name] = lambda fn=fn, args=args, out=out: fn(*args)
            calls["q.index_select"] = lambda q8=q8, ids=ids: q8.index_select(0, ids)
            calls["one-element kernel"] = lambda: one.add_(1)
            for flush, evict in (("written", None), ("read", timer.flush.sum)):
                times = alternate(timer, calls, evict=evict)
                print(f"dequant {case} gather ({n_ids} ids into {rows} x 128 int8, bit for "
                      f"bit), after a {flush} flush: "
                      + "; ".join(f"{name} {spread(ts)}" for name, ts in times.items())
                      + f" | {card}", flush=True)
        del q8, scale
        torch.cuda.empty_cache()


#: the pieces part ``segment_sum`` times the kernel at.
SEGMENT_PIECES = (256, 512, 1024, 2048)
#: variants of ``csrc/segment_sum.cu`` that part ``segment_sum`` also times
#: at the shipped piece: label -> ((text of the source, its replacement), ...).
_ROW_LOAD = "buf[t] = values[o * width + ccol];"
SEGMENT_VARIANTS = {
    "L2-only row loads (__ldcg)": ((_ROW_LOAD, "buf[t] = __ldcg(values + o * width + ccol);"),),
    "streaming row loads (__ldcs)": ((_ROW_LOAD, "buf[t] = __ldcs(values + o * width + ccol);"),),
    "1 warp a block": (("constexpr int WARPS = 4;", "constexpr int WARPS = 1;"),),
    "8 warps a block": (("constexpr int WARPS = 4;", "constexpr int WARPS = 8;"),),
}


def segment_sum_shapes(dev):
    """Part ``segment_sum``'s three shapes: name -> (sorted ids, permutation,
    values, num_segments), built on the card."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def dedup(m, run):
        short = torch.cumsum((torch.rand(m - run, generator=gen, device=dev) < 0.8).long(),
                             0) + 1
        sidx = torch.cat([torch.zeros(run, dtype=torch.int64, device=dev), short])
        return sidx, torch.randperm(m, generator=gen, device=dev), m

    slots = torch.randint(0, 1024, (4_194_304,), generator=gen, device=dev)
    order = torch.argsort(slots, stable=True)
    shapes = {"dedup b16384 (1,655,808 positions, one run of 1,589,248)":
              dedup(1_655_808, 1_589_248),
              "dedup b1024 (104,448 positions, one run of 99,328)": dedup(104_448, 99_328),
              "slot reduction b65536 (4,194,304 positions into 1,024)":
              (slots[order], order, 1024)}
    return {name: (sidx, order, torch.randn(sidx.shape[0], 128, generator=gen, device=dev), n)
            for name, (sidx, order, n) in shapes.items()}


def part_segment_sum(dev, timer: Timer, card: str) -> None:
    """Kernel #8 at the benchmark's three segment-sum shapes: its pieces,
    then the kernel, its plain version and the library path it replaced."""
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import _build, segment_sum
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    src = read_source("segment_sum")
    variants = {}
    for label, edits in SEGMENT_VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise ValueError(f"segment_sum.cu no longer contains {old!r}")
            text = text.replace(old, new)
        variants[label] = (text, ())
    entries = {"shipped": _build.bind("segment_sum", "segment_sum_sorted", segment_sum._ARGS)}
    for label, lib in build(variants, "segment_sum").items():
        entries[label] = bind(lib, "segment_sum_sorted", segment_sum._ARGS)
    engaged = segment_sum.engaged_pieces(dev)
    stream = torch.cuda.current_stream().cuda_stream
    shipped = segment_sum.PIECE
    for name, (sidx, order, values, n) in segment_sum_shapes(dev).items():
        m, k = values.shape
        out = torch.empty(n, k, device=dev)
        want = {}
        runs = [(label, fn, shipped) for label, fn in entries.items()] + [
            ("shipped", entries["shipped"], piece) for piece in SEGMENT_PIECES
            if piece != shipped] + [("shipped, values already sorted (no order)",
                                     entries["shipped"], shipped)]
        for label, fn, piece in runs:
            vals, perm = (values[order], None) if label.endswith("(no order)") else (values,
                                                                                      order)
            chunks = -(-m // piece)
            scratch = torch.empty(chunks, k, device=dev)
            meta = torch.empty(chunks, dtype=torch.int64, device=dev)
            args = (sidx.data_ptr(), None if perm is None else perm.data_ptr(),
                    vals.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), meta.data_ptr(), engaged.data_ptr(), m, n, k, piece,
                    stream)

            def call(fn=fn, args=args):
                _build.check(fn(*args), "segment_sum_sorted")

            call()
            if piece not in want:                       # the plain version, on the CPU
                segment_sum.PIECE = piece
                try:
                    want[piece] = segment_sum.sorted_segment_sum_plain(
                        sidx.cpu(), values.cpu(), n, order.cpu())
                finally:
                    segment_sum.PIECE = shipped
            same = torch.equal(out.cpu(), want[piece])
            took = timer.median(call)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
            parts = "; ".join(f"{e.key[:40]} {e.self_device_time_total / 5:.1f}"
                              for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
            print(f"segment_sum {name}: {label}, piece {piece}: {1e3 * took:.1f} us, "
                  f"{'equal to' if same else 'DIFFERS from'} the plain version bit for bit "
                  f"(device us a call: {parts or 'not measured'}) | {card}", flush=True)
            del scratch, meta, vals, perm
        calls = {"kernel": lambda: tiling.sorted_segment_sum(sidx, values, n, order=order),
                 "plain (on the card its index_add_ adds with atomics)":
                 lambda: segment_sum.sorted_segment_sum_plain(sidx, values, n, order),
                 "library (sorted copy + segment_reduce)":
                 lambda: sorted_segment_sum_library(sidx, values, n, order)}
        reps = 5 if m > 1_000_000 else 30
        print(f"segment_sum {name}, piece {shipped}: "
              + "; ".join(f"{label} {1e3 * timer.median(c, reps=reps):.1f} us"
                          for label, c in calls.items())
              + f" (medians of {reps}) | {card}", flush=True)
        del out, want
        torch.cuda.empty_cache()


MF_WINDOW = 16


def mf_fp32_executor(dev):
    """chip_smoke.py phase 5's fp32 ``MF_100M_PALLAS`` step as an executor
    of ``MF_WINDOW``-step windows, after one warm-up window: (executor,
    state)."""
    from repro_torch.configs.heat_mf import MF_100M_PALLAS
    from repro_torch.core import mf
    from repro_torch.data import pipeline
    from repro_torch.train import trainer
    cfg = MF_100M_PALLAS
    dds = pipeline.device_cf_dataset(pipeline.synth_cf_dataset(4096, cfg.num_items), dev)
    state = mf.init_mf(0, cfg, device=dev)
    body = mf.make_scan_body(cfg, lambda s: pipeline.cf_batch_device(dds, 0, s, B), 0)
    executor = trainer.EpochExecutor(body, MF_WINDOW)
    state, _ = executor.run(state, 0, MF_WINDOW)
    return executor, state


def part_step_stats(dev, card: str, earlier: str | None) -> None:
    """The fp32 MF step's device time with the current and the earlier
    checkout's ccl_stats.cu, profiled in the order current, earlier,
    earlier, current."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    if not earlier:
        print("step_stats: needs --earlier DIR: not measured", flush=True)
        return
    current = _build.library("ccl_stats")
    (then,) = build(earlier_source(earlier, "ccl_stats"), "step_stats").values()
    executor, state = mf_fp32_executor(dev)
    for w, (label, lib) in enumerate((("current", current), ("earlier", then),
                                      ("earlier", then), ("current", current)), start=1):
        _build._LIBS["ccl_stats"] = lib
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, _ = executor.run(state, w * MF_WINDOW, MF_WINDOW)
                torch.cuda.synchronize()
        finally:
            _build._LIBS["ccl_stats"] = current
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / MF_WINDOW
        stats = sum(e.self_device_time_total for e in kern
                    if "ccl_stats_kernel" in e.key) / MF_WINDOW
        if busy <= 0:
            print(f"step_stats {label}: the profiler saw no device time: not measured")
            continue
        print(f"step_stats {label} ccl_stats.cu: fp32 MF step, ccl_stats {stats:.1f} us of "
              f"{busy:.1f} us device time per step ({MF_WINDOW}-step window) | {card}",
              flush=True)


def part_launches(dev, card: str) -> None:
    """The fp32 MF step's device events per step, by the operator that
    launched them, over three profiled 16-step windows."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import tiling
    window = MF_WINDOW
    executor, state = mf_fp32_executor(dev)
    current = tiling.sorted_segment_sum
    for w, (label, form) in enumerate((("current", current),
                                       ("library", sorted_segment_sum_library),
                                       ("current", current)), start=1):
        tiling.sorted_segment_sum = form
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, _ = executor.run(state, w * window, window)
                torch.cuda.synchronize()
        finally:
            tiling.sorted_segment_sum = current
        events = prof.events()
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        by_op = collections.defaultdict(collections.Counter)
        for e in events:
            if e.device_type != DeviceType.CPU or not e.kernels:
                continue
            chain, parent = [e.name], e.cpu_parent
            while parent is not None and len(chain) < 3:
                chain.append(parent.name)
                parent = parent.cpu_parent
            for k in e.kernels:
                by_op[" < ".join(chain)][k.name[:60]] += 1
        attributed = sum(sum(c.values()) for c in by_op.values())
        phase7 = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        print(f"launches window {w} ({label} sorted_segment_sum): {len(device) / window:.2f} "
              f"device events per step ({phase7 / window:.2f} counted as chip_smoke.py phase 7 "
              f"counts them), {attributed / window:.2f} attributed to an operator | {card}",
              flush=True)
        for op in sorted(by_op):
            kinds = "; ".join(f"{name} x{n / window:g}" for name, n in sorted(by_op[op].items()))
            print(f"launches window {w}: {sum(by_op[op].values()) / window:g} per step by "
                  f"{op}: {kinds}", flush=True)


#: part ``l2``: every thread sums the float4s of its grid-stride positions,
#: ``passes`` times over, with L1-bypassing loads (``ld.global.cg``), four
#: loads in flight; one float a thread is written so nothing is elided.
L2_READ_SRC = r"""
#include <cuda_runtime.h>

__global__ void l2_read_kernel(const float4* __restrict__ buf, long long n4,
                               int passes, float* __restrict__ out) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int p = 0; p < passes; ++p) {
    long long i = tid;
    for (; i + 3 * stride < n4; i += 4 * stride) {
      float4 v0 = __ldcg(buf + i), v1 = __ldcg(buf + i + stride);
      float4 v2 = __ldcg(buf + i + 2 * stride), v3 = __ldcg(buf + i + 3 * stride);
      a0 += v0.x + v0.y + v0.z + v0.w;
      a1 += v1.x + v1.y + v1.z + v1.w;
      a2 += v2.x + v2.y + v2.z + v2.w;
      a3 += v3.x + v3.y + v3.z + v3.w;
    }
    for (; i < n4; i += stride) {
      float4 v = __ldcg(buf + i);
      a0 += v.x + v.y + v.z + v.w;
    }
  }
  out[tid] = a0 + a1 + a2 + a3;
}

extern "C" int l2_read(const void* buf, long long n4, int passes, void* out,
                       int blocks, int threads, void* stream) {
  l2_read_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)buf, n4, passes, (float*)out);
  return (int)cudaGetLastError();
}
"""


#: part ``l2``: buffer sizes in MB (all well inside the H100's 50 MB L2,
#: then 1 GB from HBM), launch shapes (blocks an SM, threads a block), the
#: bytes each timed call reads, and the sizes whose rates set the default.
L2_SIZES_MB = (4, 8, 12, 16, 20, 24, 28, 32, 40)
L2_HBM_MB = 1024
L2_LAUNCHES = ((4, 256), (8, 256), (4, 512))
L2_CALL_BYTES = 4 << 30
L2_DEFAULT_MB = (4, 32)


def part_l2(dev, card: str) -> None:
    """The L2's read rate: rereads of buffers that fit in it, at several
    sizes and launch shapes, in two sweeps (sizes rising, then falling) so
    that a difference between sizes can be told from noise; then one
    buffer that does not fit.  Each size's rate is its best launch shape's
    median (the kernel's own limits are not the L2's), the mean of the two
    sweeps; the default is the median of those over ``L2_DEFAULT_MB``."""
    import torch
    fn = bind(build({"l2_read": (L2_READ_SRC, ())}, "l2")["l2_read"], "l2_read",
              [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    out = torch.empty(max(b * t for b, t in L2_LAUNCHES) * sms, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"l2: L2_cache_size {props.L2_cache_size} bytes, {sms} SMs | {card}", flush=True)

    def rate(mb: int, blocks: int, threads: int):
        buf = torch.ones(mb * (1 << 20) // 4, device=dev)
        passes = max(L2_CALL_BYTES // (mb << 20), 1)

        def call():
            rc = fn(buf.data_ptr(), buf.numel() // 4, passes, out.data_ptr(),
                    blocks * sms, threads, stream)
            if rc != 0:
                raise RuntimeError(f"l2_read launch failed: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        assert float(out[:blocks * sms * threads].double().sum()) == \
            float(buf.numel()) * passes, "l2_read misread its buffer"
        times = []
        for _ in range(20):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        nbytes = buf.numel() * 4 * passes
        return (nbytes / (statistics.median(times) / 1e3), nbytes / (times[-3] / 1e3),
                nbytes / (times[2] / 1e3), passes)

    best: dict = {mb: [] for mb in L2_SIZES_MB}
    for sweep, sizes in enumerate((L2_SIZES_MB, L2_SIZES_MB[::-1]), 1):
        for mb in sizes:
            rows = [(rate(mb, b, t), b, t) for b, t in L2_LAUNCHES]
            for (med, lo, hi, passes), b, t in rows:
                print(f"l2: sweep {sweep}, {mb} MB read {passes} times, {b} blocks/SM x {t} "
                      f"threads: {med:.4e} bytes/s median of 20 (p10 {lo:.4e}, p90 "
                      f"{hi:.4e}) | {card}", flush=True)
            best[mb].append(max(r[0][0] for r in rows))
    per_size = {mb: statistics.fmean(v) for mb, v in best.items()}
    for mb, v in per_size.items():
        print(f"l2: {mb} MB best launch shape: {best[mb][0]:.4e} / {best[mb][1]:.4e} "
              f"bytes/s in sweeps 1 / 2, mean {v:.4e} | {card}", flush=True)
    lo_mb, hi_mb = L2_DEFAULT_MB
    chosen = statistics.median(v for mb, v in per_size.items() if lo_mb <= mb <= hi_mb)
    hbm = max(rate(L2_HBM_MB, b, t)[0] for b, t in L2_LAUNCHES)
    print(f"l2: {L2_HBM_MB} MB (from HBM) best launch shape {hbm:.4e} bytes/s | {card}",
          flush=True)
    print(f"l2: read rate {chosen:.4e} bytes/s (median over {lo_mb}-{hi_mb} MB of each "
          f"size's best launch shape; HardwareModel.cache_bandwidth) | {card}", flush=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated subset of {','.join(PARTS)}")
    ap.add_argument("--earlier", default=None,
                    help="root of an earlier checkout whose ccl_bwd.cu, ccl_stats.cu "
                         "and gather_dequant.cu parts bwd_mf, stats_mf and dequant "
                         "also time")
    args = ap.parse_args()
    parts = args.parts.split(",")
    unknown = set(parts) - set(PARTS)
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("probe_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    timer = Timer(dev)
    if "stats" in parts:
        part_stats(dev, timer, card)
    if "bwd" in parts:
        part_bwd(dev, timer, card)
    if "bwd_mf" in parts:
        part_bwd_mf(dev, timer, card, args.earlier)
    if "stats_mf" in parts:
        part_stats_mf(dev, timer, card, args.earlier)
    if "flash" in parts:
        part_flash(dev, timer, card)
    if "ties" in parts:
        part_ties(dev, timer, card)
    if "dequant" in parts:
        part_dequant(dev, timer, card, args.earlier)
    if "segment_sum" in parts:
        part_segment_sum(dev, timer, card)
    if "launches" in parts:
        part_launches(dev, card)
    if "step_stats" in parts:
        part_step_stats(dev, card, args.earlier)
    if "l2" in parts:
        part_l2(dev, card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
