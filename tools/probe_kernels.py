#!/usr/bin/env python3
"""Where the time of the port's redesigned row and statistics kernels goes,
on one CUDA card.

    python3 tools/probe_kernels.py

Builds ``src/repro_torch/csrc/ccl_stats_shared.cu`` with nvcc, with two
copies of it: "loads only", whose K loop streams u, p and the negatives
through its ring and computes nothing, and "compute only", whose K loop
computes on whatever the ring holds and loads nothing (its results are
garbage; only its time is read).  At the LM head's shape (T = 8,184, K = 960,
n = 64, as in chip_smoke.py phase 11) it times the three,
``torch.matmul(u, negs.T)`` and ``torch.add(u, p)`` (a plain pass that reads
u and p); at phase 3's row-update shape (2,048 ids into a 400,000 x 128
table) the gather-FMA kernel and ``index_add_``; and a one-element kernel,
the floor of this way of timing.  Each is timed as chip_smoke.py times
kernels (the median of 30 CUDA-event timings), once after each of two ways
of evicting the 50 MB L2: writing a 256 MB buffer (chip_smoke.py's flush,
which leaves the L2 full of dirty lines that a kernel's reads must first
write back) and reading it (clean lines).  Prints one line per call and the
card's name and power limit.  Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

STATS_SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "ccl_stats_shared.cu")
OUT_DIR = os.path.join(ROOT, "build", "probe_kernels")
T, K, N_NEG = 8 * 1023, 960, 64
ROWS, B = 400_000, 1024

_COMPUTE = "    const float* su = ring + (c % STAGES) * STAGE_FLOATS;"
_LOOP_END = "  cp_async_wait<0>();"
_LOADS = ("if (c + STAGES - 1 < chunks) load(c + STAGES - 1);", "if (c < chunks) load(c);")


def stats_variants(src: str) -> dict[str, str]:
    """The kernel source and its "loads only" and "compute only" copies."""
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
    return {"ccl_stats_shared": src, "ccl_stats_shared, loads only": loads_only,
            "ccl_stats_shared, compute only": compute_only}


def build(variants: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Compile every variant in parallel, one nvcc each, and load them."""
    from repro_torch.kernels import _build
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(variants.items()):
        cu, so = (os.path.join(OUT_DIR, f"v{i}{ext}") for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import embedding_update
    dev = torch.device("cuda")
    with open(STATS_SRC) as f:
        libs = build(stats_variants(f.read()))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = torch.randn(T, K, generator=gen, device=dev)
    p = 0.1 * torch.randn(T, K, generator=gen, device=dev)
    negs = 0.1 * torch.randn(N_NEG, K, generator=gen, device=dev)
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

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB > L2

    def time_ms(fn, evict, reps=30) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            evict()
            torch.cuda._sleep(4_000_000)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    for name, fn in calls.items():
        dirty = time_ms(fn, flush.zero_)
        clean = time_ms(fn, flush.sum)
        print(f"{name}: {1e3 * dirty:.1f} us after a written flush, {1e3 * clean:.1f} us "
              f"after a read flush | {card}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
