#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives its
main path — HEAT MF training with ``MF_100M_PALLAS`` (400k users x 400k
items, K=128, n=64 negatives, tile 1,024) — through ``train_mf``.  Phases,
one line each:

  1. the card (name and power limit from nvidia-smi);
  2. the kernel build, with its seconds and each kernel's registers;
  3. each kernel against its plain PyTorch version at the main path's shapes
     (B=1,024, n=64, K=128; the row update takes 2,048 ids with duplicates
     into the 400,000-row table): max abs error against the stated
     tolerance, and the median of 30 CUDA-event timings of the kernel, the
     plain version and, where one PyTorch call computes the same function,
     that call (``library_ms``), each with the L2 cache flushed first;
  4. the loss through the kernel autograd Function against the plain
     ``ccl_loss_fused``: loss and the three gradients;
  5. ``train_mf`` for 64 steps at batch 1,024 in windows of 16: finite
     losses, a loss on a fixed set of pairs that falls from the initial
     state, the launch counts of the main path, and steps/s;
  6. determinism: two runs of 2 steps (with a tile refresh) from one state,
     compared bit for bit;
  7. a torch.profiler window of the main path: kernel launches and device
     busy time per step, and the kernels that take the most device time.

Then it prints the kernels' JSON line, the card line, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero with no result line; it also refuses to run without a CUDA
device.  It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s
# outside the tensor cores, the rates the kernels' bounds are taken against.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
B, N_NEG, K, ROWS = 1024, 64, 128, 400_000
STEPS, WINDOW = 64, 16
RTOL, ATOL = 1e-5, 1e-6      # |kernel - plain| <= ATOL + RTOL * |plain|


def card_line() -> str:
    """``name, power.limit`` of card 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, flops: float):
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    """Largest |got - want| over matching tensors; raises when any element
    breaks ``ATOL + RTOL * |want|``."""
    import torch
    worst = 0.0
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).abs()
        if not bool(torch.all(diff <= ATOL + RTOL * w.double().abs())):
            raise AssertionError(f"kernel disagrees with its plain version: "
                                 f"max abs err {diff.max().item():.3e}")
        worst = max(worst, diff.max().item())
    return worst


def time_ms(fn, flush, reps: int = 30) -> float:
    """Median device time of ``fn()`` in ms: the L2 cache is flushed, a
    device-side sleep holds the stream while the host enqueues the start
    event, ``fn`` and the end event, so host overhead is not timed."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_window(executor, state, start: int, length: int,
                   t_unprofiled: float) -> str:
    """Profile one more window of the main path: kernel launches and device
    busy time per step, against the unprofiled window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        executor.run(state, start, length)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern) / length
    if not kern or busy_us <= 0:
        return "[7 profile] the profiler saw no device time: not measured"
    launches = sum(e.count for e in kern) / length
    step_us = 1e6 * t_unprofiled / length
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    names = ", ".join(f"{e.key[:48]} {e.self_device_time_total / length:.1f} us"
                      for e in top)
    return (f"[7 profile] per step: {launches:.0f} kernel launches, device "
            f"busy {busy_us:.1f} us of {step_us:.1f} us unprofiled "
            f"({100 * busy_us / step_us:.1f}%); top: {names}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs.heat_mf import MF_100M_PALLAS
    from repro_torch.core import mf
    from repro_torch.core.losses import ccl_loss_fused
    from repro_torch.data import pipeline
    from repro_torch.kernels import _build, ccl_similarity, embedding_update, ops
    from repro_torch.train import trainer

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {kind}", flush=True)

    secs = _build.build_all()
    regs = {n: " ".join(l.split("ptxas info    : Used ")[-1].strip()
                        for l in _build.build_log(n).splitlines()
                        if "Used" in l) for n in _build.sources()}
    print(f"[2 build] {max(secs.values()):.1f} s for {len(secs)} sources in "
          f"parallel; " + "; ".join(f"{n}: {r}" for n, r in regs.items()), flush=True)

    # ---- 3: each kernel against its plain version --------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB > L2
    u = 0.1 * torch.randn(B, K, generator=gen, device=dev)
    p = 0.1 * torch.randn(B, K, generator=gen, device=dev)
    negs = 0.1 * torch.randn(B, N_NEG, K, generator=gen, device=dev)
    kernels = []

    stats = ccl_similarity.ccl_stats(u, p, negs)
    err = max_err(stats, ccl_similarity.ccl_stats_plain(u, p, negs))
    nbytes = 4 * (2 * B * K + B * N_NEG * K) + 4 * (3 * B + 2 * B * N_NEG)
    b_ms, b_by = bound(nbytes, 2 * B * K * (3 + 2 * N_NEG))
    kernels.append(dict(
        name="ccl_stats", route="cuda", source="src/repro_torch/csrc/ccl_stats.cu",
        replaces="src/repro/kernels/ccl_similarity.py:43", max_abs_err=err,
        ms=time_ms(lambda: ccl_similarity.ccl_stats(u, p, negs), flush),
        plain_ms=time_ms(lambda: ccl_similarity.ccl_stats_plain(u, p, negs), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.einsum("bk,bnk->bn", u, negs), flush)))

    g_unit = torch.ones(1, device=dev)     # unit cotangent: O(1) outputs
    bwd_args = (u, p, negs, *stats, g_unit)
    err = max_err(ccl_similarity.ccl_bwd(*bwd_args, mu=1.0, theta=0.0),
                  ccl_similarity.ccl_bwd_plain(*bwd_args, mu=1.0, theta=0.0))
    nbytes = (4 * (2 * B * K + B * N_NEG * K + 3 * B + 2 * B * N_NEG + 1)
              + 4 * (2 * B * K + B * N_NEG * K))
    b_ms, b_by = bound(nbytes, 5 * B * N_NEG * K + 7 * B * K + 10 * B * N_NEG)
    kernels.append(dict(
        name="ccl_bwd", route="cuda", source="src/repro_torch/csrc/ccl_bwd.cu",
        replaces="src/repro/kernels/ccl_similarity.py:248", max_abs_err=err,
        ms=time_ms(lambda: ccl_similarity.ccl_bwd(*bwd_args, mu=1.0, theta=0.0),
                   flush),
        plain_ms=time_ms(lambda: ccl_similarity.ccl_bwd_plain(
            *bwd_args, mu=1.0, theta=0.0), flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    table = 0.1 * torch.randn(ROWS, K, generator=gen, device=dev)
    tile_ids = torch.randperm(ROWS, generator=gen, device=dev)[:B]
    pos_ids = torch.cat([tile_ids[torch.randint(0, B, (B // 2,), generator=gen,
                                                device=dev)],
                         torch.randint(0, ROWS, (B // 2,), generator=gen,
                                       device=dev)])
    ids = torch.cat([pos_ids, tile_ids])          # 2,048 ids, duplicates within and across
    grads = torch.randn(2 * B, K, generator=gen, device=dev)
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    n_ids, n_unique = ids.numel(), int(torch.unique(ids).numel())
    got = embedding_update.gather_fma_rows_(table.clone(), sids, order, grads, 0.05)
    want = embedding_update.gather_fma_rows_plain_(table.clone(), sids, order,
                                                   grads, 0.05)
    err = max_err([got[sids]], [want[sids]])
    assert torch.equal(got, embedding_update.gather_fma_rows_(
        table.clone(), sids, order, grads, 0.05)), "gather-FMA repeat differs"
    del got, want
    nbytes = 4 * n_ids * K + 8 * 2 * n_ids + 4 * 2 * n_unique * K
    b_ms, b_by = bound(nbytes, (n_ids + 2 * n_unique) * K)
    work = table.clone()
    print(f"[3 ids] row update: {n_ids} ids, {n_unique} unique", flush=True)
    kernels.append(dict(
        name="gather_fma", route="cuda", source="src/repro_torch/csrc/gather_fma.cu",
        replaces="src/repro/kernels/embedding_update.py:88", max_abs_err=err,
        ms=time_ms(lambda: embedding_update.gather_fma_rows_(
            work, sids, order, grads, 0.05), flush),
        plain_ms=time_ms(lambda: embedding_update.gather_fma_rows_plain_(
            work, sids, order, grads, 0.05), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: work.index_add_(0, ids, grads, alpha=-0.05),
                           flush)))
    del work, table
    for kd in kernels:
        lib = ("n/a" if kd["library_ms"] is None
               else "%.4f ms" % kd["library_ms"])
        print(f"[3 kernel] {kd['name']}: max abs err {kd['max_abs_err']:.3e} "
              f"(tol {ATOL:g} + {RTOL:g}*|plain|); {kd['ms']:.4f} ms kernel, "
              f"{kd['plain_ms']:.4f} ms plain, bound {kd['bound_ms']:.4f} ms "
              f"({kd['bound_by']}), library {lib} | {card}", flush=True)

    # ---- 4: the kernel loss against the plain fused loss -------------------
    def loss_and_grads(fn):
        leaves = [t.clone().requires_grad_() for t in (u, p, negs)]
        loss = fn(*leaves)
        return [loss.detach()] + [B * g for g in torch.autograd.grad(loss, leaves)]

    got = loss_and_grads(ops.make_ccl_loss_kernel(1.0, 0.0))
    want = loss_and_grads(lambda a, b_, c: ccl_loss_fused(a, b_, c, 1.0, 0.0))
    err = max_err(got, want)
    print(f"[4 loss] kernel loss {got[0].item():.6f} vs plain "
          f"{want[0].item():.6f}; loss and B*gradients max abs err {err:.3e}",
          flush=True)

    # ---- 5: the main path --------------------------------------------------
    t0 = time.perf_counter()
    ds = pipeline.synth_cf_dataset(4096, MF_100M_PALLAS.num_items)
    t_data = time.perf_counter() - t0
    dds = pipeline.device_cf_dataset(ds, dev)

    def eval_loss(state) -> float:
        """CCL loss on a fixed set: 4 batches of (user, train positive)
        pairs drawn with seed 1000, 64 fixed uniform negatives per pair."""
        t = state.params
        total = 0.0
        for s in range(4):
            b = pipeline.cf_batch_device(dds, 1000, s, B)
            neg = torch.randint(0, MF_100M_PALLAS.num_items, (B, N_NEG),
                                generator=mf.generator(mf.fold_in(1000, s), dev),
                                device=dev)
            total += ccl_loss_fused(t.user_table[b.user_ids], t.item_table[b.pos_ids],
                                    t.item_table[neg]).item()
        return total / 4

    eval_before = eval_loss(mf.init_mf(0, MF_100M_PALLAS, device=dev))  # train_mf's init
    counters = (ccl_similarity.STATS_LAUNCHES, ccl_similarity.BWD_LAUNCHES,
                embedding_update.GATHER_FMA_LAUNCHES)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = trainer.train_mf(MF_100M_PALLAS, ds, STEPS, batch_size=B,
                                     steps_per_dispatch=WINDOW, device="cuda")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = {c.name: c.count() for c in counters}
    assert len(losses) == STEPS and all(math.isfinite(x) for x in losses), losses
    first, last = statistics.mean(losses[:WINDOW]), statistics.mean(losses[-WINDOW:])
    # At lr 0.05 a row moves by about lr/B per step, so the window means of
    # the training loss are dominated by batch-to-batch noise; the check of
    # learning is the loss on a fixed set, before and after the 64 steps.
    eval_after = eval_loss(state)
    assert eval_after < eval_before, f"loss did not fall: {eval_before} -> {eval_after}"
    # One stats and one backward launch per step; one gather-FMA launch per
    # table per step (the user update, then the item groups' fused update).
    assert launches == {"ccl_stats": STEPS, "ccl_bwd": STEPS,
                        "gather_fma": 2 * STEPS}, launches
    for kd in kernels:
        kd["launches"] = launches[kd["name"]]
    body = mf.make_scan_body(MF_100M_PALLAS, lambda s: pipeline.cf_batch_device(
        dds, 0, s, B), 0)
    executor = trainer.EpochExecutor(body, WINDOW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, window = executor.run(state, STEPS, WINDOW)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    assert bool(torch.isfinite(window).all())
    print(f"[5 train] MF_100M_PALLAS batch {B}: {STEPS} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (window means {first:.4f} -> "
          f"{last:.4f}); fixed-set loss {eval_before:.6f} -> {eval_after:.6f}; "
          f"launches {launches}; {STEPS / t_train:.1f} steps/s "
          f"including init, {WINDOW / t_steady:.1f} steps/s over one more "
          f"{WINDOW}-step window; dataset {t_data:.1f} s | {card}", flush=True)

    # ---- 6: determinism ----------------------------------------------------
    cfg = dataclasses.replace(MF_100M_PALLAS, refresh_interval=2)
    base = mf.init_mf(1, cfg, device=dev)
    body = mf.make_scan_body(cfg, lambda s: pipeline.cf_batch_device(
        dds, 1, s, B), 1)
    runs = []
    for _ in range(2):
        s = mf.MFState(mf.MFParams(base.params.user_table.clone(),
                                   base.params.item_table.clone()),
                       base.tile, base.step)
        out = []
        for step in range(2):
            s, loss = body(s, step)
            out.append(loss)
        runs.append((s, torch.stack(out)))
    (s0, l0), (s1, l1) = runs
    same = (torch.equal(l0, l1)
            and torch.equal(s0.params.user_table, s1.params.user_table)
            and torch.equal(s0.params.item_table, s1.params.item_table)
            and torch.equal(s0.tile.tile_ids, s1.tile.tile_ids)
            and torch.equal(s0.tile.tile_emb, s1.tile.tile_emb))
    assert same, "two runs from one state differ"
    assert s0.tile.step == 0, "the tile did not refresh in the second step"
    print("[6 determinism] 2 steps (tile refreshed) twice from one state: "
          "losses, both tables and the tile identical bit for bit", flush=True)

    # ---- 7: where a steady step's time goes --------------------------------
    print(profile_window(executor, state, STEPS + WINDOW, WINDOW, t_steady),
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
