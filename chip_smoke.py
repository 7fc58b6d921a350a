#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives its
main paths: through ``train_mf``, HEAT MF training with ``MF_100M_PALLAS``
(400k users x 400k items, K=128, n=64 negatives, tile 1,024) and the
paper-scale ``AMAZON`` model (20.98M users x 9.35M items, K=128, n=64,
behavior aggregation, tile 1,024) with int8 tables; through ``train_lm``,
smollm-360m (32 layers, d=960, vocab 49,152) with the HEAT vocab head on the
kernel backend; the attention dispatcher ``ops.attention`` at
smollm-360m's attention shape; the other MF engines (the SimpleX baseline,
MSE, the popularity and in-batch samplers); top-k serving through the
``BatchingRecommender`` with the exact and the tile-pruned retrieval; and
the streaming service (``StreamingTrainer``: ring ingest, train-on-recent
rounds through kernels #1, #2 and #6, refresh, checkpoints, crash resume,
the divergence guard and the chaos harness); and sharded MF training over
``torch.distributed`` (one NCCL rank, two gloo ranks sharing the card,
shard-aware checkpoints, the CLI's ``--mesh-data``) through kernels #1, #2
and #6 on every rank; and LM serving (prefill, KV-cache decode, the serve
CLI) of smollm-360m, granite-8b and a 4-layer moonshot-v1-16b-a3b, the MoE
model first trained with the HEAT head on kernels #3 and #4; and the SSM,
hybrid and VLM families (mamba2-370m, zamba2-2.7b, qwen2-vl-2b at full width
and depth) trained through kernels #3 and #4, then served; and the audio
family (whisper-medium at full width and depth: its encoder, the
cross-attention and the decode cache of the encoder's K/V) trained through
kernels #3 and #4, then served, and granite-8b trained on the card under
Adafactor.
Phases, one line each (a few print more):

  1. the card (name and power limit from nvidia-smi);
  2. the kernel build, with its seconds and each kernel's registers;
  3. each kernel against its plain PyTorch version at the main path's shapes
     (B=1,024, n=64, K=128; the row update takes 2,048 ids with duplicates
     into the 400,000-row table): max abs error against the stated
     tolerance (the stats and the backward also called twice and compared
     bit for bit),
     and the median of 30 CUDA-event timings of the kernel, the
     plain version and, where one PyTorch call computes the same function,
     that call (``library_ms``), each with the L2 cache flushed first, and
     the kernel's share of its bound (bound over kernel time); the
     gather-dequant kernel on a synthetic 400,000-row int8 table at 1,024 and
     at 16,384 ids, which must agree with its plain version bit for bit;
     the segment-sum kernel (#8) at the int8 item update's duplicate
     pre-reduce at batch 16,384 (1,655,808 positions, one run of 1,589,248)
     and the fp32 slot reduction at batch 65,536 (4,194,304 positions into
     1,024 slots), which must agree with its plain version on the CPU bit
     for bit, give the same bits on two calls and count the pieces past
     each run's first as the host counts them, timed beside its plain
     version on the card and the library path it replaced (the sorted copy
     ``values[order]`` and ``segment_reduce``);
  4. the loss through the kernel autograd Function against the plain
     ``ccl_loss_fused``: loss and the three gradients;
  5. ``train_mf`` for 64 steps at batch 1,024 in windows of 16: finite
     losses, a loss on a fixed set of pairs that falls from the initial
     state, the launch counts of the main path (the segment sum twice a
     step: the slot reduction and the tile write-through), and steps/s;
  6. determinism: two runs of 2 steps (with a tile refresh) from one state,
     compared bit for bit;
  7. (none: where a main-path step's device time goes, and its launches,
     are the benchmark's traced stretch, ``heatbench/``, read through the
     port's own spans);
  8. ``AMAZON`` with int8 tables on the kernel backend at batch 1,024 in
     windows of 16, on the CLI's dataset shape (4,096 users): finite losses,
     the launches per step (gather-dequant 3, stats 1, backward 1,
     gather-FMA 0, segment sum 4: the user and item updates' duplicate
     pre-reduces, the slot reduction, the tile write-through), an int8
     payload after training, a fixed-set loss that falls, steps/s and peak
     device memory; then the
     gather-dequant kernel against its plain version, bit for bit, and
     timed, on the trained tables: at the ids of the run's first batch (the
     user, positive and history gathers, after one line with the run's
     launches of the kernel, which cover all three gathers; the kernels
     line reports the history gather) and at ids across each whole
     table, last rows included;
  9. an int8 restart: ``MF_100M_PALLAS`` with int8 tables, a 16-item
     history and a tile refresh every 8 steps, 32 steps uninterrupted and
     again with a checkpoint every 8 steps and a failure injected at step
     13; every leaf of the two final states must be identical;
 10. smollm-360m at full width and depth, batch 8 x sequence 1,024, AdamW at
     lr 1e-3, ``remat="full"``, the HEAT head (n=64 shared negatives from the
     2,048-id vocab tile) on ``backend="pallas"``: 32 steps through
     ``train_lm`` on one fixed batch, in windows of 8: finite losses, one
     shared-stats and one shared-backward launch per step, three of the
     segment sum (#8, the row gathers' backwards) and no other kernel, the
     loss on that batch (fixed negatives) falling from the
     initial state, steps/s and tokens/s over one more steady window, peak
     device memory;
 11. the shared-layout CCL kernels against their plain versions on the head's
     own inputs from the trained model (a fixed batch: T = 8 x 1,023 rows,
     K = 960, n = 64), with the kernel loss's autograd Function against the
     same Function on the CPU (its plain versions), and
     the flash-attention kernel against its plain version on unit-normal
     q, k, v at smollm-360m's attention shape (B=8, Hq=15, Hkv=5, S=1,024,
     D=64), causal and not: errors, times and bounds as in phase 3 (beside
     the flash kernel's fp32 SIMT bound, that of the same work as three TF32
     products per fp32 product on the tensor cores), and two calls of each
     of the three kernels compared bit for bit;
 12. the attention path: ``ops.attention`` on the trained model's layer-0
     queries, keys and values, against the model's own chunked attention;
 13. an LM restart: smollm-360m at full width and 4 layers, a vocab-tile
     refresh every 4 steps, 8 steps uninterrupted and again with a
     checkpoint every 4 steps and a failure injected at step 6; every
     parameter, moment and tile leaf must be identical;
 14. full-catalog evaluation through ``mf.topk_all_items`` (a running
     top-20 merged with each 65,536-item chunk, so the (users, items) score
     matrix never exists): ``MF_100M_PALLAS`` in its initial state and as
     phases 5-7 trained it, all 4,096 users of the dataset over all 400,000
     items with their training positives excluded, in batches of 1,024:
     Recall@20 and NDCG@20 (finite, in [0, 1]) and ms per 1,024 users; on
     256 users the ids must equal the stable top-20 of ``scores_all_items``
     at the same chunk, and the metrics those of the dense route
     (``metrics.evaluate_ranking``) to 1e-6; ``AMAZON`` with the int8 tables
     phase 8 trained, the first batch's 1,024 users over all 9.35M items,
     dequantized chunk by chunk: ms per 1,024 users and the call's peak
     device memory, which must stay far below the 38 GB score matrix, with
     the same id check on 16 users; a tie check (integer embeddings,
     ``similarity="dot"``, a chunk that does not divide the catalog) against
     numpy's stable argsort; and no launch of the port's kernels (the
     evaluation runs none);
 15. the engines at full width: ``MF_100M_PALLAS`` at batch 1,024 through
     ``train_mf`` for 32 steps in windows of 16 with each of
     simplex_bmm+dense+uniform (the SimpleX baseline of the paper's Table 1),
     fused+scatter_add+uniform, mse_dot+scatter_add+uniform,
     pallas+pallas+popularity, pallas+pallas+in_batch and the config's own
     HEAT engine pallas+pallas+tile: finite losses, the launches of the
     stats, backward and gather-FMA kernels (once, once and twice a step on
     the pallas engines, never on the others) and of the segment sum (the
     tile write-through, the dense update's two, the tile sampler's slot
     reduction), steps/s over two more windows
     and the device time per step over a profiled one; for popularity and
     in_batch two 2-step runs from one state, bit for bit; then ``AMAZON``
     int8 with the popularity sampler (an fp64 CDF over the 9.35M items'
     counts) for 16 steps on phase 8's dataset: finite losses, three
     gather-dequant and three segment-sum launches a step and two 2-step runs bit for bit; and
     Algorithm 1's (``tune_tiling``) plans on the H100 constants beside the
     configs' own (N1, N2);
 16. serving at full width on phase 5's trained ``MF_100M_PALLAS``:
     ``build_retrieval_index`` (512-row tiles, k-means on the card) with its
     seconds; ``topk_pruned`` over every tile against ``topk_all_items``
     (the same id sets for 256 users) and the pruned top-20's recall at 8
     and 32 tiles; a ``BatchingRecommender`` with each of the exact and the
     tile pruner (k=20, max_batch 32, max_wait 2 ms, training positives
     excluded) under 1,024 concurrent single-user requests from threads
     released together: qps, p50, p99, device calls and one call shape,
     ``recommend_many`` of 32 users alone (ms a call) and equal to the direct
     top-k, ``refresh_from`` a second trained state (the answers
     move to its top-k; training it further changes nothing served), a
     wrong-shaped refresh that must leave ``health`` degraded with the
     answers standing, and a good one that restores ok; then the exact
     pruner over the trained int8 ``AMAZON`` tables (9.35M items) for 32
     users, with ms a call; the tile server stays up for phase 17;
 17. streaming at ``MF_100M_PALLAS`` width: (a) a cold-start
     ``StreamingTrainer`` on a drifting ``SyntheticStream`` with a probe
     (user 1 x the last item, 32 times at event 16,384), 16 rounds of 4,096
     events and 32 steps of batch 1,024 over a ring of 32 (recency 0.5), a
     live exact top-10 server refreshed every round and checkpoints every 4
     rounds: ms a round for ingest, train and refresh, steps/s, a
     checkpoint's ms, the loss, events/s, freshness (printed, not asserted),
     peak memory; asserted: finite losses, no guard trip, 32/32/64/64
     launches of the stats, backward, gather-FMA and segment-sum kernels in
     every round, one
     window length, one event shape, one call shape; (b) the same run with a
     failure at event 43,000 (round 11): one restart, and the tables, tile,
     ring, counters and losses equal to (a)'s bit for bit, then two rounds
     with no server attached (their train ms against (a)'s) and one more
     round profiled (device time and launches against (a)'s round wall);
     (c) the popularity sampler fed the live counts for 8 rounds: the same
     launches but 32 of the segment sum (no slot reduction), items first
     ingested in a round drawn as negatives in the next, two 2-round runs
     bit for bit; (d) ``launch/serve.py``'s two warm-started streaming rounds on a clone of phase 5's trained state
     with a cold ring, refreshing phase 16's tile server with its call
     shapes unchanged; (e) ``run_chaos(seed=0, rounds=10)`` on the card with
     no problem; (f) ``launch.stream.main`` at 400,000 x 400,000 x 128 on the
     ``pallas`` backend for 4 rounds, its lines and launches; and the phase's
     seconds;
 18. sharded ``MF_100M_PALLAS`` training over ``torch.distributed`` at batch
     1,024, on phase 5's dataset rows repeated over the 400,000 users (so
     every user shard takes updates), held to an unsharded 32-step run of
     the same seed and its checkpoints at steps 16 and 32: (a) one NCCL
     rank, ``train_mf(mesh=make_data_mesh(1))`` (an all-reduce probe first),
     within 1e-5 and whether bit-identical; (b) two gloo ranks sharing card
     0 (data=2: 200,000 user rows and 512 batch rows a rank) for 32 steps,
     the gathered state and losses within 1e-5, then ms a step on each rank
     over one more window and a window with each exchange timed between two
     synchronizations beside a profiled window's device time; (d) the same
     run with checkpoints every 8 steps crashed at step 20 on both ranks,
     equal to (b) bit for bit, and its step-24 checkpoint trained to step 32
     by one rank within 1e-5; (c) model=2 (200,000 item rows a rank) for 16
     steps within 1e-5 of the unsharded run's step 16; every run asserts 1,
     1, 2 launches of #1, #2, #6 a step on every rank; (e) ``launch.train
     --mf --mesh host --mesh-data 2 --dist-backend gloo`` at full width for
     4 steps, its lines; and the phase's seconds;
 19. LM serving through ``prefill`` -> ``pad_cache`` -> ``decode_step`` at
     full width (fp32 weights from key 0; 8 random prompts of 1,024 tokens;
     ``launch/serve.py``'s options, so a bf16 cache; 64 greedy decode steps
     with the tokens kept on the card): prefill ms and tokens/s, ms a
     decode step and tokens/s against the step's byte bound (every weight
     and cached row read once), peak device memory, no launch of the
     port's kernels, one profiled decode step (launches, busy share), and
     the reference's check that the decode logits at position 1,024 equal
     those of a prefill of 1,025 tokens on 2 prompts (rel < 2e-3 with an
     fp32 cache, the attention projections at 1/sqrt of their contraction
     width and an MoE prefill made dropless; the bf16 cache's rel and the
     reference init's, which fails at full depth, printed): (a)
     smollm-360m (32 layers, d=960), then
     ``launch.serve.main([])`` at its reduced defaults on the card; (b)
     granite-8b (36 layers, d=4,096, 8.25B parameters, 33 GB); (c)
     moonshot-v1-16b-a3b at full width cut to 4 of its 48 layers (64
     experts top-6, vocab 163,840, 2.95B parameters): ``train_lm`` for 8
     AdamW steps at lr 1e-3 on one fixed batch of 4 x 512 with the HEAT head
     on ``pallas`` (finite losses, the fixed-batch loss falling, kernels #3
     and #4 launched once a step, #8 seven times (three row gathers and one
     a layer for the experts' outputs) and nothing else, peak memory), #3 and #4
     against their plain versions on the trained model's head inputs (T =
     2,044, K = 2,048, n = 128: errors, µs, bounds), then the serving run on
     the trained weights; and the phase's seconds;
 20. the SSM, hybrid and VLM families at full width and depth (fp32
     weights, AdamW at lr 1e-3, ``remat="full"``, the HEAT head on
     ``pallas``, one fixed batch): (a) mamba2-370m (48 Mamba2 layers,
     d=1,024, state 128) for 16 steps at 8 x 1,024; (b) zamba2-2.7b (54
     Mamba2 layers in 9 groups, each followed by the one shared attention
     block and MLP) for 4 steps at 2 x 512; (c) qwen2-vl-2b (28 M-RoPE
     layers) for 8 steps at 4 x 512 with 256 patch rows a sequence from
     ``lm_batch(extras=)``: finite losses, the fixed-batch loss falling,
     kernels #3 and #4 launched once a step, #8 three times and nothing
     else, peak memory;
     #3 and #4 against their plain versions on each trained head's inputs
     (errors, µs, bounds, ``torch.matmul`` for ``un``; these entries join
     the kernels line); then phase 19's serving run on the trained weights
     (the VLM's prompts start with 256 random patch rows; the Mamba cache
     stays fp32 under the bf16 ``cache_dtype``), its check held with no
     conditioning for mamba2 and with the attention conditioned for the
     other two; and the seconds of each model and of the phase;
 21. (a) whisper-medium (24 encoder layers over 1,500 frames, 24 decoder
     layers with cross-attention, d=1,024, vocab 51,865, 810,987,520
     parameters) trained as phase 20 trains (AdamW, lr 1e-3, remat full,
     the HEAT head on ``pallas``) for 8 steps on one fixed batch of 8 x 448
     tokens (Whisper's decoder context) with 8 x 1,500 frames from
     ``lm_batch(extras=)``: finite losses, the fixed-batch loss falling,
     #3 and #4 launched once a step, #8 three times and nothing else, peak
     memory and its
     parts; #3 and #4 against their plain versions on the trained head's
     inputs (T = 3,576, K = 1,024, n = 64; these entries join the kernels
     line); then phase 19's serving run on the trained weights: 8 prompts
     of 384 tokens with random frames, 64 greedy steps, the self and the
     encoder's K/V cached in bf16, the step's byte bound counting the
     decoder's weights, the output table and both caches read once, and
     the decode-after-prefill check held with the attention conditioned,
     the cross-attention included; (b) granite-8b (36 layers, d=4,096,
     8.25B parameters) trained under Adafactor for 4 steps on one fixed
     batch of 2 x 512 (its factored moments 0.28 GB; AdamW's would not fit
     the card): finite losses, the loss falling, #3 and #4 once a step, the
     peak memory and its parts (parameters, gradients, Adafactor state,
     the rest), #3 and #4 at its head shape (T = 1,022, K = 4,096; these
     entries join the kernels line); the phase raises if the model does
     not fit; and the seconds of each part and of the phase;
 22. LM training under a mesh (``TrainerConfig.mesh``), #3 and #4 on every
     rank, 4 steps a run in windows of 2 (remat full): (a) smollm-360m at 8
     x 1,024 with AdamW (lr 1e-3) on a one-rank NCCL mesh, bit for bit the
     unsharded ``train_lm``; (b) moonshot-v1-16b-a3b cut to 4 layers at 4 x
     512 on two gloo ranks sharing card 0 at model=2 (experts, the 163,840-
     row vocab tables and the attention leaves split), SGD at lr 10 from
     the conditioned init: at capacity factor E / k within 1e-5 of the
     unsharded run (losses, and 4,096 fixed elements of every parameter
     leaf), and its losses at 1.25; (c) smollm-360m on four gloo ranks at
     data=2 x model=2: SGD from a conditioned step-0 checkpoint within 1e-5
     of the unsharded run, the same run crashed at step 3 and healed from
     its step-2 checkpoint bit for bit on every rank, that checkpoint
     continued by one process within 1e-5, and 2 AdamW steps beside the
     unsharded AdamW run; (d) ``launch.train --arch smollm-360m --mesh host
     --mesh-data 2 --dist-backend gloo`` for 2 steps.  Each run prints ms a
     step and the exchanges' share over its windows (each exchange timed
     as 18b times them), every rank's peak memory and launches of #3 and
     #4 a step; and the phase's seconds.

Then it prints the total seconds, the kernels' JSON line, the card line, and
as its last line ``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero with no result line; it also refuses to run without a CUDA
device.  It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
# Phase 21b trains granite-8b (33 GB of weights, 33 GB of gradients) on the
# 80 GB card: stacking the last layer-stacked gradient needs one 8.46 GB
# block while the per-layer pieces are still held, which the caching
# allocator's fixed segments, fragmented by the backward, cannot find;
# expandable segments map freed pages back into one range.  Set before
# torch is first imported (a caller's own setting is kept).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores (the fp64 tensor cores' rate is the same 67
# TFLOP/s) and dense TF32 FLOP/s on the tensor cores: the rates the kernels'
# bounds are taken against.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
B, N_NEG, K, ROWS = 1024, 64, 128, 400_000
STEPS, WINDOW = 64, 16
INT8_STEPS, RESTART_STEPS = 64, 32
DEQUANT_IDS = (1024, 16384)     # the sizes of AMAZON's user and history gathers
RTOL, ATOL = 1e-5, 1e-6      # |kernel - plain| <= ATOL + RTOL * |plain|
LM_B, LM_S, LM_STEPS, LM_WINDOW, LM_LR = 8, 1024, 32, 8, 1e-3
LM_RESTART_LAYERS, LM_RESTART_STEPS = 4, 8
#: the LM step's segment sums: the backwards of its three row gathers
#: (``tiling.GatherRows``) from the vocab tables; an MoE model adds one a
#: layer (the gather of its experts' outputs).
LM_SEGMENT_SUMS = 3
#: phase 14: top-20 evaluation in chunks of 65,536 items (a chunk that
#: divides neither 400,000 nor 9,350,000), checked against the dense scores
#: on the first EVAL_CHECK_USERS users (16 on the 9.35M-item catalog).
EVAL_K, EVAL_CHUNK, EVAL_CHECK_USERS = 20, 65_536, 256
#: the attention path's check against the model's chunked attention, relative
#: to the output's largest element: two fp32 orders of a softmax whose logits
#: are of order 16 at this init (wq's fan-in is Hq, as in the reference), so
#: an elementwise relative check would fail near-zero outputs.
ATTN_PATH_RTOL = 1e-5


def card_line() -> str:
    """``name, power.limit`` of card 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    """Least time (ms) the card could take for ``nbytes`` of memory traffic
    and ``flops`` operations at ``flop_rate``, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_share(kd: dict) -> str:
    """A kernels-line entry's bound over its measured time, in words."""
    return f"{100 * kd['bound_ms'] / kd['ms']:.1f}% of its bound"


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


def eval_loss(state, cfg, dds, batch: int = B) -> float:
    """The model's CCL loss on a fixed set: 4 batches of (user, train
    positive) pairs drawn with seed 1000 (with their history when the model
    aggregates), 64 fixed uniform negatives per pair."""
    import torch
    from repro_torch.core import aggregation as agg
    from repro_torch.core import mf
    from repro_torch.core.losses import ccl_loss_fused
    from repro_torch.data import pipeline
    from repro_torch.optim import quantization as qz
    t = state.params
    dev = dds.train_pos.device
    total = 0.0
    for s in range(4):
        b = pipeline.cf_batch_device(dds, 1000, s, batch, cfg.history_len)
        neg = torch.randint(0, cfg.num_items, (batch, N_NEG),
                            generator=mf.generator(mf.fold_in(1000, s), dev),
                            device=dev)
        user = qz.gather_rows(t.user_table, b.user_ids)
        if t.aggregator is not None:
            user = agg.aggregate(t.aggregator, user,
                                 qz.gather_rows(t.item_table, b.hist_ids),
                                 b.hist_mask, gate=cfg.gate,
                                 kind=cfg.aggregation_kind)
        total += ccl_loss_fused(user, qz.gather_rows(t.item_table, b.pos_ids),
                                qz.gather_rows(t.item_table, neg)).item()
    return total / 4


def gather_dequant_entry(q, scale, ids, flush) -> dict:
    """The gather-dequant kernel against its plain version on ``ids`` (must
    agree bit for bit), its kernel, plain and library times, and its bound:
    each distinct row and scale read once (a repeated id reads its row from
    L2), each id read once, each fp32 output row written once."""
    import torch
    from repro_torch.kernels import embedding_update as eu
    got = eu.gather_dequant_rows(q, scale, ids)
    want = eu.gather_dequant_rows_plain(q, scale, ids)
    err = (got - want).abs().max().item()
    assert torch.equal(got, want), f"gather-dequant differs: max abs err {err}"
    n_ids, k = ids.numel(), q.shape[1]
    n_unique = int(torch.unique(ids).numel())
    b_ms, b_by = bound(n_unique * (k + 4) + 8 * n_ids + 4 * n_ids * k, n_ids * k)
    return dict(
        name="gather_dequant", route="cuda",
        source="src/repro_torch/csrc/gather_dequant.cu",
        replaces="src/repro/kernels/embedding_update.py:48", max_abs_err=err,
        ms=time_ms(lambda: eu.gather_dequant_rows(q, scale, ids), flush),
        plain_ms=time_ms(lambda: eu.gather_dequant_rows_plain(q, scale, ids),
                         flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: q.index_select(0, ids), flush),
        n_unique=n_unique, max_id=int(ids.max()))


def dequant_summary(kd: dict) -> str:
    """One line's worth of a :func:`gather_dequant_entry` result."""
    return (f"{kd['n_unique']} unique, largest id {kd['max_id']}; max abs err "
            f"{kd['max_abs_err']:.1e} (must be 0); {kd['ms']:.4f} ms kernel, "
            f"{kd['plain_ms']:.4f} ms plain, bound {kd['bound_ms']:.4f} ms "
            f"({kd['bound_by']}; {bound_share(kd)}), library {kd['library_ms']:.4f} ms "
            f"(q.index_select alone: the int8 gather without the dequant, a "
            f"partial yardstick)")


def segment_sum_cases(dev, gen) -> dict:
    """Kernel #8's two main-path shapes at K=128: name -> (sorted ids, the
    sort's permutation, values, num_segments).  ``dedup``: the int8 item
    update's duplicate pre-reduce at batch 16,384 (``_dedup``'s run index
    of 1,655,808 positions into as many segments; the history padding's
    item 0 holds a run of 1,589,248, the rest come in runs of about 1.25);
    ``slots``: the fp32 slot reduction at batch 65,536 (4,194,304 negative
    gradients into the 1,024 tile slots)."""
    import torch
    m, run = 1_655_808, 1_589_248
    rest = torch.cumsum((torch.rand(m - run, generator=gen, device=dev) < 0.8).long(), 0)
    dedup = torch.cat([torch.zeros(run, dtype=torch.int64, device=dev), rest + 1])
    slots = torch.randint(0, 1024, (4_194_304,), generator=gen, device=dev)
    slot_order = torch.argsort(slots, stable=True)
    cases = {"dedup": (dedup, torch.randperm(m, generator=gen, device=dev), m),
             "slots": (slots[slot_order], slot_order, 1024)}
    return {name: (sidx, order, torch.randn(sidx.shape[0], K, generator=gen, device=dev), n)
            for name, (sidx, order, n) in cases.items()}


def segment_sum_entry(shape: str, sidx, order, values, n: int, flush) -> dict:
    """Kernel #8 through ``tiling.sorted_segment_sum`` against its plain
    version on the CPU (must agree bit for bit), two calls compared bit for
    bit, its count of the pieces past each run's first against the host's,
    and its kernel, plain (on the card) and library times: the library path
    is the sorted copy ``values[order]`` and ``segment_reduce``, which the
    kernel replaced.  Bound: each value row, sorted id and permutation entry
    read once, each output row written once, one add a value."""
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import segment_sum as ss
    engaged = ss.engaged_pieces(values.device)
    before = int(engaged.item())
    got = tiling.sorted_segment_sum(sidx, values, n, order=order)
    torch.cuda.synchronize()
    pieces = int(engaged.item()) - before
    lengths = torch.bincount(sidx[sidx < n], minlength=n)
    want_pieces = int(((lengths + ss.PIECE - 1) // ss.PIECE - 1).clamp_min(0).sum())
    assert pieces == want_pieces, f"segment_sum {shape}: {pieces} pieces, host {want_pieces}"
    want = ss.sorted_segment_sum_plain(sidx.cpu(), values.cpu(), n, order.cpu())
    err = (got.cpu() - want).abs().max().item()
    assert torch.equal(got.cpu(), want), f"segment_sum {shape} differs: max abs err {err}"
    assert torch.equal(got, tiling.sorted_segment_sum(sidx, values, n, order=order)), \
        f"segment_sum {shape}: two calls differ"
    m, k = values.shape
    b_ms, b_by = bound(4 * m * k + 16 * m + 4 * n * k, m * k)
    slow = 5 if int(lengths.max()) > 100_000 else 30      # the library's long run
    return dict(
        name="segment_sum", shape=shape, route="cuda",
        source="src/repro_torch/csrc/segment_sum.cu",
        replaces="torch.segment_reduce and values[order] (src/repro_torch/core/tiling.py)",
        max_abs_err=err,
        ms=time_ms(lambda: tiling.sorted_segment_sum(sidx, values, n, order=order), flush),
        plain_ms=time_ms(lambda: ss.sorted_segment_sum_plain(sidx, values, n, order),
                         flush, slow),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: ss.sequential_sum(sidx, values[order], n), flush, slow),
        positions=m, longest_run=int(lengths.max()), pieces=pieces)


def lm_eval_loss(params, cfg, opts, tile, dev, b: int = LM_B, s: int = LM_S,
                 extras=None) -> float:
    """The HEAT loss on the fixed batch phase 10 (or 19c, 20, 21) trains on
    (``lm_batch`` seed 0, step 0, b x s, with ``extras``: a VLM's patches,
    an audio model's frames)
    with the fixed key 1000 and a fixed tile, without gradients."""
    import torch
    from repro_torch.data import pipeline
    from repro_torch.models import lm
    batch = pipeline.lm_batch(0, b, s, cfg.vocab, seed=0, device=dev, extras=extras)
    with torch.no_grad():
        loss, _ = lm.forward_train(params, batch, cfg, opts, 1000, tile)
    return loss.item()


def lm_head_inputs(params, cfg, opts, tile, dev, b: int = LM_B, s: int = LM_S,
                   extras=None):
    """The HEAT head's inputs for :func:`lm_eval_loss`'s batch and key:
    hidden rows u (T, d), positives p (T, d), the n shared negatives (n, d),
    and the batch."""
    import torch
    from repro_torch.core import mf
    from repro_torch.data import pipeline
    from repro_torch.models import lm
    batch = pipeline.lm_batch(0, b, s, cfg.vocab, seed=0, device=dev, extras=extras)
    table = params["out_embed"]
    with torch.no_grad():
        h, _ = lm._run_stack(params, lm.embed_inputs(params, batch, cfg), cfg, opts,
                             memory=lm._memory(params, batch, cfg, opts))
        u = h[:, :-1].reshape(-1, cfg.d_model).contiguous()
        p = table[batch["tokens"][:, 1:].reshape(-1)]
        local = torch.randint(0, tile.tile_ids.numel(), (cfg.heat.num_negatives,),
                              generator=mf.generator(mf.fold_in(1000, mf.NEG_SALT),
                                                     dev), device=dev)
        negs = table[tile.tile_ids[local]]
    return u, p, negs, batch


def shared_ccl_entries(u, p, negs, flush) -> list:
    """Kernels #3 and #4 against their plain versions on the HEAT head's
    inputs (hidden rows u and positives p (T, K), shared negatives (n, K)),
    each called twice and compared bit for bit: the kernels-line entries
    (without their launches) with errors, times and bounds."""
    import torch
    from repro_torch.kernels import ccl_similarity
    t_rows, k = u.shape
    n = negs.shape[0]
    kernels = []
    stats = ccl_similarity.ccl_stats_shared(u, p, negs)
    err = max_err(stats, ccl_similarity.ccl_stats_shared_plain(u, p, negs))
    assert all(torch.equal(a, b_) for a, b_ in zip(
        stats, ccl_similarity.ccl_stats_shared(u, p, negs))), \
        "ccl_stats_shared: two calls differ"
    b_ms, b_by = bound(4 * (2 * t_rows * k + n * k) + 4 * (3 * t_rows + n + t_rows * n),
                       2 * t_rows * k * (3 + n) + 2 * n * k)
    kernels.append(dict(
        name="ccl_stats_shared", route="cuda",
        source="src/repro_torch/csrc/ccl_stats_shared.cu",
        replaces="src/repro/kernels/ccl_similarity.py:128", max_abs_err=err,
        ms=time_ms(lambda: ccl_similarity.ccl_stats_shared(u, p, negs), flush),
        plain_ms=time_ms(lambda: ccl_similarity.ccl_stats_shared_plain(u, p, negs),
                         flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.matmul(u, negs.T), flush)))
    # Cotangent T: each row's weight (1/T) times g is 1, so the gradients are
    # of order one, not 1/T.
    w = torch.full((t_rows, 1), 1.0 / t_rows, device=u.device)
    g = torch.full((1,), float(t_rows), device=u.device)
    bwd_args = (u, p, negs, *stats, w, g)
    got = ccl_similarity.ccl_bwd_shared(*bwd_args, mu=1.0, theta=0.0)
    err = max_err(got, ccl_similarity.ccl_bwd_shared_plain(*bwd_args, mu=1.0, theta=0.0))
    again = ccl_similarity.ccl_bwd_shared(*bwd_args, mu=1.0, theta=0.0)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), \
        "ccl_bwd_shared: two calls differ"
    del got, again
    nbytes = (4 * (2 * t_rows * k + n * k + 4 * t_rows + n + t_rows * n + 1)
              + 4 * (2 * t_rows * k + n * k))
    b_ms, b_by = bound(nbytes, 4 * t_rows * n * k + 10 * t_rows * k + 10 * t_rows * n)
    kernels.append(dict(
        name="ccl_bwd_shared", route="cuda",
        source="src/repro_torch/csrc/ccl_bwd_shared.cu",
        replaces="src/repro/kernels/ccl_similarity.py:214", max_abs_err=err,
        ms=time_ms(lambda: ccl_similarity.ccl_bwd_shared(*bwd_args, mu=1.0,
                                                         theta=0.0), flush),
        plain_ms=time_ms(lambda: ccl_similarity.ccl_bwd_shared_plain(
            *bwd_args, mu=1.0, theta=0.0), flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return kernels


def lm_phases(dev, card: str, flush, counters) -> list:
    """Phases 10-13 (the LM slice); returns the kernels line's entries of
    the shared-layout CCL kernels and the flash-attention kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import mf
    from repro_torch.data import pipeline
    from repro_torch.kernels import ccl_similarity, flash_attention, ops, ref
    from repro_torch.models import layers, lm
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer

    base = get_config("smollm-360m")
    cfg = dataclasses.replace(base, heat=dataclasses.replace(base.heat,
                                                             backend="pallas"))
    opts = lm.TrainOptions(loss="heat", remat="full", attn_chunk=LM_S)
    # A fixed batch: on fresh batches of uniform tokens from a 49,152-word
    # vocab a token recurs about five times in 32 steps, too few for a loss
    # on held-out tokens to move; the fixed batch shows that the step learns.
    tcfg = trainer.TrainerConfig(steps=LM_STEPS, lr=LM_LR, batch_size=LM_B,
                                 seq_len=LM_S, optimizer="adamw", log_every=0,
                                 steps_per_dispatch=LM_WINDOW, fixed_batch=True)

    # ---- 10: smollm-360m through train_lm ----------------------------------
    init = trainer.init_lm_state(tcfg.seed, cfg, opts, get_optimizer("adamw"),
                                 device=dev)                   # train_lm's init
    tile0 = init.tile
    eval_before = lm_eval_loss(init.params, cfg, opts, tile0, dev)
    n_params = sum(x.numel() for _, x in ckpt.named_leaves(init.params))
    del init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = trainer.train_lm(cfg, opts, tcfg, device="cuda",
                                     log=lambda *_: None)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = {c.name: c.count() for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert len(losses) == LM_STEPS and all(math.isfinite(x) for x in losses), losses
    want = {c.name: 0 for c in counters}
    # the segment sum: three GatherRows backwards a step (LM_SEGMENT_SUMS)
    want.update(ccl_stats_shared=LM_STEPS, ccl_bwd_shared=LM_STEPS,
                segment_sum=LM_SEGMENT_SUMS * LM_STEPS)
    assert launches == want, launches
    eval_after = lm_eval_loss(state.params, cfg, opts, tile0, dev)
    assert eval_after < eval_before, f"LM loss did not fall: {eval_before} -> {eval_after}"
    step_fn = trainer.make_lm_train_step_raw(cfg, opts, get_optimizer("adamw"),
                                             LM_LR)

    def body(s, step):                          # train_lm's step, fixed batch
        batch = pipeline.lm_batch(0, LM_B, LM_S, cfg.vocab, tcfg.seed, dev)
        return step_fn(s, batch, mf.fold_in(tcfg.seed, step))

    executor = trainer.EpochExecutor(body, LM_WINDOW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, window = executor.run(state, LM_STEPS, LM_WINDOW)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    assert bool(torch.isfinite(window).all())
    rate = LM_WINDOW / t_steady
    print(f"[10 lm train] smollm-360m ({cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}, "
          f"{n_params} parameters) batch {LM_B} x {LM_S}, AdamW lr {LM_LR}, "
          f"remat full, HEAT head pallas (n={cfg.heat.num_negatives}, tile "
          f"{cfg.heat.tile_size}), one fixed batch: {LM_STEPS} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (window means "
          f"{statistics.mean(losses[:LM_WINDOW]):.4f} -> "
          f"{statistics.mean(losses[-LM_WINDOW:]):.4f}); fixed-batch loss {eval_before:.6f} -> "
          f"{eval_after:.6f}; launches {launches}; {LM_STEPS / t_train:.3f} "
          f"steps/s including init, {rate:.3f} steps/s = {rate * LM_B * LM_S:.0f} "
          f"tokens/s over one more {LM_WINDOW}-step window; peak device memory "
          f"{peak_gb:.2f} GB | {card}", flush=True)
    del executor, body, step_fn

    # ---- 11: the LM kernels against their plain versions -------------------
    u, p, negs, batch = lm_head_inputs(state.params, cfg, opts, tile0, dev)
    t_rows, k = u.shape
    n = negs.shape[0]
    kernels = shared_ccl_entries(u, p, negs, flush)
    w = torch.full((t_rows, 1), 1.0 / t_rows, device=dev)
    for kd in kernels:
        kd["launches"] = launches[kd["name"]]

    def loss_and_grads(device):
        leaves = [x.to(device).requires_grad_() for x in (u, p, negs, w[:, 0])]
        loss = ops.make_ccl_loss_shared_kernel(1.0, 0.0)(*leaves)
        du, dp, dn, dw = torch.autograd.grad(loss, leaves)
        return [loss.detach().cpu(), t_rows * du.cpu(), t_rows * dp.cpu(),
                t_rows * dn.cpu(), dw.cpu()]

    # The kernel loss's autograd Function on the card against the same
    # Function on the CPU, where it runs the plain versions: both form un in
    # fp64, so a near-zero similarity has the same sign (the hinge) in both.
    got = loss_and_grads(dev)
    want_lg = loss_and_grads("cpu")
    loss_err = max_err(got, want_lg)
    for kd in kernels:
        lib = "none" if kd["library_ms"] is None else "%.4f ms" % kd["library_ms"]
        print(f"[11 kernel] {kd['name']} on the head's inputs (T={t_rows}, "
              f"K={k}, n={n}): same bits on two calls; max abs err "
              f"{kd['max_abs_err']:.3e} (tol {ATOL:g} "
              f"+ {RTOL:g}*|plain|); {kd['ms']:.4f} ms kernel, {kd['plain_ms']:.4f} "
              f"ms plain, bound {kd['bound_ms']:.4f} ms ({kd['bound_by']}; "
              f"{bound_share(kd)}), library {lib} | {card}", flush=True)
    print(f"[11 loss] shared kernel loss on the card {got[0].item():.6f} vs its "
          f"plain versions on the CPU {want_lg[0].item():.6f}; loss, "
          f"T*gradients of u, p, negs and the gradient of w: max abs err "
          f"{loss_err:.3e}", flush=True)
    del got, want_lg

    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn(LM_B, hq, LM_S, hd, generator=gen, device=dev)
    kk = torch.randn(LM_B, hkv, LM_S, hd, generator=gen, device=dev)
    vv = torch.randn(LM_B, hkv, LM_S, hd, generator=gen, device=dev)
    kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kk, vv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes = 4 * (2 * LM_B * hq * LM_S * hd + 2 * LM_B * hkv * LM_S * hd)
    flash_entries = {}
    for causal in (True, False):
        pairs = LM_S * (LM_S + 1) // 2 if causal else LM_S * LM_S
        flops = 4 * LM_B * hq * hd * pairs
        # The kernel's FMAs run on the fp32 SIMT pipes; beside that bound, the
        # least time of the same work as three TF32 products per fp32 product
        # on the tensor cores (csrc/flash_attention.cu says why it does not).
        b_ms, b_by = bound(nbytes, flops)
        tf32_ms, _ = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
        got = flash_attention.flash_attention(q, kk, vv, causal=causal)
        err = max_err([got], [ref.attention_ref(q, kk, vv, causal=causal)])
        assert torch.equal(got, flash_attention.flash_attention(q, kk, vv, causal=causal)), \
            "flash_attention: two calls differ"
        del got
        kd = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:76", max_abs_err=err,
            ms=time_ms(lambda: flash_attention.flash_attention(q, kk, vv,
                                                               causal=causal),
                       flush),
            plain_ms=time_ms(lambda: ref.attention_ref(q, kk, vv, causal=causal),
                             flush),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: sdpa(q, kr, vr, is_causal=causal), flush))
        flash_entries[causal] = kd
        print(f"[11 kernel] flash_attention {'causal' if causal else 'full'} "
              f"(B={LM_B}, Hq={hq}, Hkv={hkv}, S={LM_S}, D={hd}, unit-normal "
              f"q, k, v): same bits on two calls; max abs err {err:.3e} (tol "
              f"{ATOL:g} + {RTOL:g}*|plain|); {kd['ms']:.4f} ms kernel, "
              f"{kd['plain_ms']:.4f} ms plain, bound {kd['bound_ms']:.4f} ms "
              f"({kd['bound_by']}, fp32 on the SIMT pipes; {bound_share(kd)}; "
              f"{tf32_ms:.4f} ms as 3xTF32 on the tensor cores), "
              f"library {kd['library_ms']:.4f} ms (scaled_dot_product_attention, fp32, "
              f"KV repeated) | {card}", flush=True)
    del q, kk, vv, kr, vr

    # ---- 12: the attention path ---------------------------------------------
    with torch.no_grad():
        lp = lm._layers(state.params["blocks"], cfg.n_layers)[0]
        x = layers.rms_norm(lm.embed_inputs(state.params, batch, cfg), lp["ln1"],
                            cfg.norm_eps)
        cos, sin = layers.rope_cos_sin(lm._positions(cfg, LM_B, LM_S, dev),
                                       cfg.head_dim, cfg.rope_theta)
        qm = layers.apply_rope(torch.einsum("bsd,dhk->bshk", x, lp["attn"]["wq"]),
                               cos, sin)
        km = layers.apply_rope(torch.einsum("bsd,dhk->bshk", x, lp["attn"]["wk"]),
                               cos, sin)
        vm = torch.einsum("bsd,dhk->bshk", x, lp["attn"]["wv"])
        want_attn = layers.chunked_attention(qm, km, vm, causal=True,
                                             chunk=LM_S).transpose(1, 2)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (qm, km, vm))
        for c in counters:
            c.reset()
        got_attn = ops.attention(qt, kt, vt, causal=True)
        torch.cuda.synchronize()
        path_launches = {c.name: c.count() for c in counters}
    assert path_launches["flash_attention"] == 1, path_launches
    assert bool(torch.isfinite(got_attn).all()) and got_attn.shape == qt.shape
    scale = want_attn.abs().max().item()
    path_err = (got_attn - want_attn).abs().max().item()
    assert path_err <= ATTN_PATH_RTOL * scale, (path_err, scale)
    flash_entries[True]["launches"] = path_launches["flash_attention"]
    kernels.append(flash_entries[True])
    print(f"[12 attention path] ops.attention on the trained model's layer-0 "
          f"q, k, v ({tuple(qt.shape)}, causal): launches {path_launches}; max abs "
          f"difference from the model's chunked attention {path_err:.3e}, "
          f"largest |output| {scale:.3e} (tol {ATTN_PATH_RTOL:g} x largest) | "
          f"{card}", flush=True)
    del state, u, p, negs, batch, lp, x, qm, km, vm, want_attn, qt, kt, vt, got_attn
    torch.cuda.empty_cache()

    # ---- 13: an LM restart, bit for bit -------------------------------------
    cfg_r = dataclasses.replace(cfg, n_layers=LM_RESTART_LAYERS, heat=dataclasses.replace(
        cfg.heat, refresh_interval=4))
    tcfg_r = dataclasses.replace(tcfg, steps=LM_RESTART_STEPS, steps_per_dispatch=4)
    t0 = time.perf_counter()
    clean, _ = trainer.train_lm(cfg_r, opts, tcfg_r, device="cuda",
                                log=lambda *_: None)
    logs = []
    with tempfile.TemporaryDirectory() as d:
        healed, _ = trainer.train_lm(
            cfg_r, opts, dataclasses.replace(tcfg_r, ckpt_dir=d, ckpt_every=4,
                                             fail_at_step=6),
            device="cuda", log=logs.append)
        saved = ckpt.valid_steps(d)
    torch.cuda.synchronize()
    t_restart = time.perf_counter() - t0
    assert logs == ["[trainer] injected failure at step 6 -> restoring latest "
                    "checkpoint"], logs
    names = []
    for (name, a), (name_b, b) in zip(ckpt.named_leaves(clean),
                                      ckpt.named_leaves(healed), strict=True):
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        assert name == name_b and same, f"LM restart differs at {name}"
        names.append(name)
    print(f"[13 lm restart] smollm-360m at full width, {LM_RESTART_LAYERS} layers, "
          f"tile refresh every 4: {LM_RESTART_STEPS} steps clean and with a "
          f"failure at step 6 healed from the step-4 checkpoint (checkpoints "
          f"{saved}): all {len(names)} leaves (parameters, AdamW moments, "
          f"count, tile, step) identical bit for bit; {t_restart:.1f} s | {card}",
          flush=True)
    return kernels


def check_topk(ids, num_items: int, exclude=None) -> None:
    """Raise unless ``ids`` are ``EVAL_K`` distinct in-range item ids per
    row, none of them excluded."""
    import torch
    assert ids.shape[1] == EVAL_K and ids.dtype == torch.int64, (ids.shape, ids.dtype)
    assert int(ids.min()) >= 0 and int(ids.max()) < num_items
    srt = torch.sort(ids, dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all()), "an id repeats within a row"
    if exclude is not None:
        assert not bool(torch.take_along_dim(exclude, ids, dim=1).any()), \
            "an excluded item was ranked"


def eval_phase(dev, card: str, ds, mf_trained, amazon, amazon_users, counters) -> None:
    """Phase 14: full-catalog top-20 evaluation of the trained MF models."""
    import numpy as np
    import torch
    from repro_torch.configs.heat_mf import MF_100M_PALLAS
    from repro_torch.core import metrics, mf
    from repro_torch.optim import quantization as qz
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 would change the scores"
    for c in counters:
        c.reset()

    # ---- MF_100M_PALLAS: every user over the 400,000 items -----------------
    n_users, n_items = ds.num_users, ds.num_items
    train_np = ds.train_mask()
    train = torch.from_numpy(train_np).to(dev)
    test = torch.from_numpy(ds.test_mask()).to(dev)
    del train_np
    users = torch.arange(n_users, device=dev)
    states = {"initial": mf.init_mf(0, MF_100M_PALLAS, device=dev).params,  # train_mf's init
              "trained": mf.MFParams(mf_trained.user_table.to(dev),
                                     mf_trained.item_table.to(dev), None)}
    mf.topk_all_items(states["initial"], users[:B], EVAL_K, item_chunk=EVAL_CHUNK,
                      exclude_mask=train[:B])                       # warm-up
    lines, top = [], {}
    for label, params in states.items():
        ids, times = [], []
        for u0 in range(0, n_users, B):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids.append(mf.topk_all_items(params, users[u0:u0 + B], EVAL_K,
                                         item_chunk=EVAL_CHUNK, exclude_mask=train[u0:u0 + B]))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ids = top[label] = torch.cat(ids)
        check_topk(ids, n_items, train)
        rec, ndcg = (float(f(ids, test)) for f in (metrics.recall_at_k, metrics.ndcg_at_k))
        assert all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in (rec, ndcg)), (rec, ndcg)
        lines.append(f"{label}: Recall@{EVAL_K} {rec:.6f}, NDCG@{EVAL_K} {ndcg:.6f}, "
                     f"{statistics.median(times):.2f} ms per {B} users (median of "
                     f"{len(times)} batches: {', '.join(f'{t:.2f}' for t in times)})")
    moved = int((top["initial"] != top["trained"]).any(1).sum())

    # The chunked top-k against the stable top-k of the same chunks' scores
    # (the same products, so the same bits), and its metrics against the
    # dense route's, on the first users.
    params, sub = states["trained"], users[:EVAL_CHECK_USERS]
    got = mf.topk_all_items(params, sub, EVAL_K, item_chunk=EVAL_CHUNK,
                            exclude_mask=train[:EVAL_CHECK_USERS])
    scores = mf.scores_all_items(params, sub, item_chunk=EVAL_CHUNK)
    want = metrics.stable_topk(torch.where(train[:EVAL_CHECK_USERS], float("-inf"), scores),
                               EVAL_K)
    assert torch.equal(got, want), "chunked top-k differs from the stable top-k of the scores"
    dense = metrics.evaluate_ranking(mf.scores_all_items(params, sub),
                                     train[:EVAL_CHECK_USERS], test[:EVAL_CHECK_USERS], EVAL_K)
    sub_test = test[:EVAL_CHECK_USERS]
    d_rec = abs(float(metrics.recall_at_k(got, sub_test)) - float(dense[f"recall@{EVAL_K}"]))
    d_ndcg = abs(float(metrics.ndcg_at_k(got, sub_test)) - float(dense[f"ndcg@{EVAL_K}"]))
    assert d_rec <= 1e-6 and d_ndcg <= 1e-6, (d_rec, d_ndcg)
    print(f"[14 eval] MF_100M_PALLAS, all {n_users} users x {n_items} items, training "
          f"positives excluded, top-{EVAL_K} in chunks of {EVAL_CHUNK}: " + "; ".join(lines)
          + f"; the trained top-{EVAL_K} differs from the initial one for {moved} of "
          f"{n_users} users; on {EVAL_CHECK_USERS} users ids equal to the stable top-{EVAL_K} of "
          f"scores_all_items at the same chunk, metrics against the dense route: "
          f"|d recall| {d_rec:.1e}, |d ndcg| {d_ndcg:.1e} | {card}", flush=True)
    del states, params, train, test, scores, dense, got, want, top
    torch.cuda.empty_cache()

    # ---- AMAZON int8: the first batch's users over the 9.35M items ---------
    params8 = mf.MFParams(qz.QuantizedTable(*(x.to(dev) for x in amazon.user_table)),
                          qz.QuantizedTable(*(x.to(dev) for x in amazon.item_table)), None)
    users8 = amazon_users.to(dev)
    n_items8 = qz.num_rows(params8.item_table)
    sub = users8[:16]
    got = mf.topk_all_items(params8, sub, EVAL_K, item_chunk=EVAL_CHUNK)
    want = metrics.stable_topk(mf.scores_all_items(params8, sub, item_chunk=EVAL_CHUNK), EVAL_K)
    assert torch.equal(got, want), "int8 chunked top-k differs from the stable top-k"
    del got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ids8 = mf.topk_all_items(params8, users8, EVAL_K, item_chunk=EVAL_CHUNK)
    torch.cuda.synchronize()
    ms8 = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    check_topk(ids8, n_items8)
    dense_gb = users8.numel() * n_items8 * 4 / 1e9
    above = (peak - resident) / 1e9
    assert above < dense_gb / 8, f"the call took {above:.2f} GB over its inputs"
    print(f"[14 eval] AMAZON int8, the first batch's {users8.numel()} users x {n_items8} "
          f"items, top-{EVAL_K} in chunks of {EVAL_CHUNK} dequantized one at a time: "
          f"{ms8:.1f} ms per {users8.numel()} users; peak device memory {peak / 1e9:.2f} GB, "
          f"{above:.3f} GB above the tables it scores (the (users, items) fp32 score matrix "
          f"would take {dense_gb:.1f} GB); ids on 16 users equal to the stable top-{EVAL_K} "
          f"of scores_all_items at the same chunk | {card}", flush=True)
    del params8, users8, ids8
    torch.cuda.empty_cache()

    # ---- ties: integer embeddings, exact dot products ----------------------
    r = np.random.default_rng(14)
    items = r.integers(-2, 3, (200_003, 8)).astype(np.float32)
    items[100_000] = items[7]                                       # a sure tie
    tie_users = r.integers(-2, 3, (64, 8)).astype(np.float32)
    want = np.argsort(-(tie_users @ items.T), axis=1, kind="stable")[:, :EVAL_K]
    got = mf.topk_all_items(mf.MFParams(torch.from_numpy(tie_users).to(dev),
                                        torch.from_numpy(items).to(dev), None),
                            torch.arange(64, device=dev), EVAL_K, similarity="dot",
                            item_chunk=EVAL_CHUNK)
    assert np.array_equal(got.cpu().numpy(), want), "ties not broken by the lowest id"
    launches = {c.name: c.count() for c in counters}
    assert not any(launches.values()), launches
    print(f"[14 eval] ties: 64 integer users x 200,003 integer items, dot, chunks of "
          f"{EVAL_CHUNK}: ids equal to numpy's stable argsort; the port's kernels "
          f"launched in phase 14: {launches} | {card}", flush=True)


def device_us(executor, state, start: int, length: int):
    """Device time (us) and kernel launches per step over one profiled
    window of ``executor`` from ``state`` (None, None where the profiler
    saw no device time); returns them and the state after the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = executor.run(state, start, length)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / length
    if busy <= 0:
        return None, None, state
    return busy, sum(e.count for e in kern) / length, state


def same_bits(a, b) -> bool:
    """Every tensor of two (nested) states or tuples equal bit for bit."""
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return a == b


def clone_state(state):
    """A copy of an MF state whose tables the step can update in place
    without touching ``state``'s."""
    import torch
    from repro_torch.core import mf
    from repro_torch.optim import quantization as qz

    def cl(t):
        if t is None:
            return None
        if isinstance(t, qz.QuantizedTable):
            return qz.QuantizedTable(*(x.clone() for x in t))
        return t.clone() if isinstance(t, torch.Tensor) else t

    p = state.params
    tile = state.tile and state.tile._replace(
        tile_ids=state.tile.tile_ids.clone(), tile_emb=cl(state.tile.tile_emb))
    return mf.MFState(mf.MFParams(cl(p.user_table), cl(p.item_table), p.aggregator),
                      tile, state.accum, state.step)


def repeat_check(cfg, dds, item_weights, steps: int = 2) -> str:
    """Two runs of ``steps`` steps from one fresh state (seed 1): losses,
    tables and tile must be the same bits."""
    import torch
    from repro_torch.core import mf
    from repro_torch.data import pipeline
    body = mf.make_scan_body(cfg, lambda s: pipeline.cf_batch_device(
        dds, 1, s, B, cfg.history_len), 1, item_weights=item_weights)
    base = mf.init_mf(1, cfg, device=dds.train_pos.device)
    runs = []
    for state in (clone_state(base), base):
        out = []
        for step in range(steps):
            state, loss = body(state, step)
            out.append(loss)
        runs.append((state.params.user_table, state.params.item_table,
                     state.tile, torch.stack(out)))
    assert same_bits(runs[0], runs[1]), f"{cfg.sampler}: two runs from one state differ"
    return f"{steps} steps twice from one state: losses, tables and tile identical bit for bit"


#: phase 15: the engines of MF_100M_PALLAS, as (backend, update_impl, sampler).
ENGINES = (("simplex_bmm", "dense", "uniform"), ("fused", "scatter_add", "uniform"),
           ("mse_dot", "scatter_add", "uniform"), ("pallas", "pallas", "popularity"),
           ("pallas", "pallas", "in_batch"), ("pallas", "pallas", "tile"))
#: phase 15: the segment sums a step of each engine's update, by update and
#: sampler: the tile write-through on every engine, the dense update's one a
#: table, the tile sampler's slot reduction.
ENGINE_SEGMENT_SUMS = {"dense": 2, "scatter_add": 0, "pallas": 0}
ENGINE_STEPS, ENGINE_WINDOW, AMAZON_POP_STEPS = 32, 16, 16
#: phase 15: Algorithm 1's total iterations M for the plans it prints (about
#: 10^9 samples at batch 1,024).
PLAN_ITERATIONS = 1_000_000


def engines_phase(dev, card: str, ds, ds8, counters) -> None:
    """Phase 15: each engine of ``ENGINES`` on ``cfg0`` (``MF_100M_PALLAS``),
    ``AMAZON`` int8 with the popularity sampler, and Algorithm 1's plans."""
    import torch
    from repro_torch.configs.heat_mf import AMAZON, MF_100M_PALLAS
    from repro_torch.core import mf, tiling
    from repro_torch.data import pipeline
    from repro_torch.train import trainer
    cfg0 = MF_100M_PALLAS
    dds = pipeline.device_cf_dataset(ds, dev)
    kernel_names = ("ccl_stats", "ccl_bwd", "gather_fma", "segment_sum")
    results = {}
    for backend, update, sampler in ENGINES:
        cfg = dataclasses.replace(cfg0, backend=backend, update_impl=update,
                                  sampler=sampler)
        name = f"{backend}+{update}+{sampler}"
        for c in counters:
            c.reset()
        torch.cuda.synchronize()
        state, losses = trainer.train_mf(cfg, ds, ENGINE_STEPS, batch_size=B,
                                         steps_per_dispatch=ENGINE_WINDOW, device="cuda")
        torch.cuda.synchronize()
        launches = {c.name: c.count() for c in counters}
        assert len(losses) == ENGINE_STEPS and all(math.isfinite(x) for x in losses), \
            (name, losses)
        on_kernels = backend == "pallas"
        want = {c.name: 0 for c in counters}
        if on_kernels:
            want.update(ccl_stats=ENGINE_STEPS, ccl_bwd=ENGINE_STEPS,
                        gather_fma=2 * ENGINE_STEPS)
        want["segment_sum"] = ENGINE_STEPS * (1 + ENGINE_SEGMENT_SUMS[update]
                                              + (sampler == "tile"))
        assert launches == want, (name, launches)
        weights = dds.item_weights if sampler == "popularity" else None
        executor = trainer.EpochExecutor(mf.make_scan_body(
            cfg, lambda s: pipeline.cf_batch_device(dds, 0, s, B), 0,
            item_weights=weights), ENGINE_WINDOW)
        rates = []
        for w in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, window = executor.run(state, ENGINE_STEPS + w * ENGINE_WINDOW,
                                         ENGINE_WINDOW)
            torch.cuda.synchronize()
            rates.append(ENGINE_WINDOW / (time.perf_counter() - t0))
            assert bool(torch.isfinite(window).all()), name
        rate = rates[-1]
        busy, n_launch, state = device_us(executor, state, ENGINE_STEPS + 2 * ENGINE_WINDOW,
                                          ENGINE_WINDOW)
        results[name] = (rate, busy)
        dev_txt = ("device time not measured (the profiler saw none)" if busy is None
                   else f"device time {busy:.1f} us and {n_launch:.0f} launches per step")
        repeat = (f"; {repeat_check(cfg, dds, weights)}"
                  if sampler in ("popularity", "in_batch") else "")
        print(f"[15 engine] MF_100M_PALLAS {name}, batch {B}: {ENGINE_STEPS} steps "
              f"through train_mf, loss {losses[0]:.4f} -> {losses[-1]:.4f}, all finite; "
              f"launches of {', '.join(kernel_names)}: "
              f"{', '.join(str(launches[k]) for k in kernel_names)} (want "
              f"{', '.join(str(want[k]) for k in kernel_names)}); {rates[0]:.1f} then "
              f"{rates[1]:.1f} steps/s over two more {ENGINE_WINDOW}-step windows, "
              f"{dev_txt} over the next{repeat} | "
              f"{card}", flush=True)
        del state, executor, window
    base_rate, base_busy = results["simplex_bmm+dense+uniform"]
    heat_rate, heat_busy = results["pallas+pallas+tile"]
    if base_busy is not None and heat_busy is not None:
        print(f"[15 engine] SimpleX baseline (simplex_bmm+dense+uniform) against HEAT "
              f"(pallas+pallas+tile) on MF_100M_PALLAS: device time {base_busy:.1f} vs "
              f"{heat_busy:.1f} us per step ({base_busy / heat_busy:.2f}x), {base_rate:.1f} "
              f"vs {heat_rate:.1f} steps/s ({heat_rate / base_rate:.2f}x) | {card}", flush=True)
    torch.cuda.empty_cache()

    # ---- AMAZON int8, popularity over 9.35M items -------------------------
    cfg8 = dataclasses.replace(AMAZON, backend="pallas", update_impl="pallas",
                               table_format="int8", sampler="popularity")
    dds8 = pipeline.device_cf_dataset(ds8, dev)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = trainer.train_mf(cfg8, ds8, AMAZON_POP_STEPS, batch_size=B,
                                     steps_per_dispatch=AMAZON_POP_STEPS, device="cuda")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = {c.name: c.count() for c in counters}
    assert len(losses) == AMAZON_POP_STEPS and all(math.isfinite(x) for x in losses), losses
    want = {c.name: 0 for c in counters}
    # segment sums: the two tables' duplicate pre-reduces, the tile write-through
    want.update(ccl_stats=AMAZON_POP_STEPS, ccl_bwd=AMAZON_POP_STEPS,
                gather_dequant=3 * AMAZON_POP_STEPS, segment_sum=3 * AMAZON_POP_STEPS)
    assert launches == want, launches
    positive = int((dds8.item_weights > 0).sum())
    del state
    torch.cuda.empty_cache()
    repeat = repeat_check(cfg8, dds8, dds8.item_weights)
    print(f"[15 engine] AMAZON int8 pallas+pallas+popularity ({cfg8.num_items} items, "
          f"{positive} of them with a positive count in the dataset; the draw is an fp64 "
          f"CDF searched per negative), batch {B}: {AMAZON_POP_STEPS} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite; launches {launches}; "
          f"{AMAZON_POP_STEPS / t_train:.1f} steps/s including init; {repeat} | {card}",
          flush=True)
    del dds8
    torch.cuda.empty_cache()

    # ---- Algorithm 1 on the H100 constants ---------------------------------
    hw = tiling.HardwareModel()
    for label, c in (("MF_100M_PALLAS", cfg0), ("AMAZON", cfg8)):
        plan = tiling.tune_tiling(c.num_items, PLAN_ITERATIONS, c.num_negatives, c.emb_dim,
                                  hw=hw)
        print(f"[15 tiling] {label}: tune_tiling(I={c.num_items}, M={PLAN_ITERATIONS}, "
              f"n={c.num_negatives}, K={c.emb_dim}) on the H100 constants (HBM "
              f"{hw.hbm_bandwidth:.3g} B/s, L2 {hw.cache_bandwidth:.4g} B/s, "
              f"{hw.cache_bytes} B): N1={plan.tile_size}, N2={plan.refresh_interval}, "
              f"predicted speedup {plan.predicted_speedup:.3f}, t_m {plan.t_m:.3e} s, "
              f"t_c {plan.t_c:.3e} s; the config's own (N1, N2) = ({c.tile_size}, "
              f"{c.refresh_interval}) | {card}", flush=True)


#: phase 16: the index's tile size, the tile pruner's budgets for the recall
#: check and for its server, and the servers' shape and load.
SERVE_TILE_ROWS, SERVE_EXPAND, SERVE_RECALL_EXPANDS = 512, 8, (8, 32)
SERVE_K, SERVE_MAX_BATCH, SERVE_WAIT_MS, SERVE_REQUESTS = 20, 32, 2.0, 1024
#: phase 16: users per topk_pruned call at full expansion, whose (users,
#: catalog, K) candidate block takes 1.6 GB at 8 users.
PARITY_USERS, PARITY_CHUNK = 256, 8
#: phase 16: how far (absolute, cosine scores in [-1, 1]) the full-expansion
#: ids' scores may sit from topk_all_items' top-k's under its own products.
PARITY_SCORE_TOL = 1e-6


def serve_load(server, users, n: int, seed: int = 16):
    """``n`` concurrent single-user requests, one thread each, on users
    drawn from ``users``, all released at once by a barrier once every
    thread has started: (qps over the release-to-last-answer wall time, p50
    ms, p99 ms, answers by user)."""
    import threading

    import numpy as np
    rng = np.random.default_rng(seed)
    picks = [int(u) for u in rng.choice(users, size=n)]
    lat, answers, lock = [], {}, threading.Lock()
    gate = threading.Barrier(n + 1)

    def client(uid):
        gate.wait(timeout=300)
        t = time.perf_counter()
        out = server.recommend(uid, timeout=120.0)
        with lock:
            lat.append(1e3 * (time.perf_counter() - t))
            answers[uid] = out

    threads = [threading.Thread(target=client, args=(u,)) for u in picks]
    for t in threads:
        t.start()
    gate.wait(timeout=300)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads) and len(lat) == n, "requests hung"
    lat.sort()
    return n / wall, lat[n // 2], lat[int(0.99 * n)], answers


def serving_phase(dev, card: str, ds, mf_trained, amazon, amazon_users, counters):
    """Phase 16: the retrieval index, the tile pruner against the exact
    top-k, both servers under concurrent load, refreshes, and an exact
    serve over the int8 AMAZON tables.  Returns the tile-pruned server,
    still serving, for phase 17's streaming refresh."""
    import numpy as np
    import torch
    from repro_torch.configs.heat_mf import MF_100M_PALLAS
    from repro_torch.core import metrics, mf, retrieval
    from repro_torch.data import pipeline
    from repro_torch.launch.server import BatchingRecommender
    from repro_torch.optim import quantization as qz
    from repro_torch.train import trainer
    cfg0 = MF_100M_PALLAS
    params = mf.MFParams(mf_trained.user_table.to(dev), mf_trained.item_table.to(dev), None)
    n_users, n_items = ds.num_users, qz.num_rows(params.item_table)
    train = torch.from_numpy(ds.train_mask()).to(dev)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = retrieval.build_retrieval_index(params.item_table, tile_rows=SERVE_TILE_ROWS)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    members = index.member_ids.reshape(-1)
    assert torch.equal(torch.sort(members[members >= 0]).values,
                       torch.arange(n_items, device=dev)), "the tiles are no partition"
    print(f"[16 index] build_retrieval_index on the trained MF_100M_PALLAS items "
          f"({n_items} x {cfg0.emb_dim}): {index.num_tiles} tiles x {index.tile_rows} "
          f"rows, 8 k-means iterations on the card in {t_build:.2f} s; every item in "
          f"exactly one tile | {card}", flush=True)

    # Full expansion: the pruned ids against the stable top-k (lowest id
    # first among ties) of the same products laid out by item id, which
    # must agree; and against topk_all_items, whose products differ in the
    # last bits: the id sets are counted, and the pruned ids' scores under
    # the exact path's own products (scores_all_items) must equal its
    # top-k's scores, so only a near tie may swap an id.
    same_set = same_order = same_exact = 0
    score_err = 0.0
    for u0 in range(0, PARITY_USERS, PARITY_CHUNK):
        uids = torch.arange(u0, u0 + PARITY_CHUNK, device=dev)
        got = retrieval.topk_pruned(params, uids, SERVE_K, index,
                                    expand_tiles=index.num_tiles,
                                    exclude_mask=train[uids])
        cand, scores = retrieval.candidate_scores(params, uids, index,
                                                  expand_tiles=index.num_tiles,
                                                  exclude_mask=train[uids])
        live = cand >= 0
        by_id = torch.full((PARITY_CHUNK, n_items), float("-inf"), device=dev)
        by_id[torch.nonzero(live)[:, 0], cand[live]] = scores[live]
        want = metrics.stable_topk(by_id, SERVE_K)
        exact = mf.topk_all_items(params, uids, SERVE_K, item_chunk=EVAL_CHUNK,
                                  exclude_mask=train[uids])
        same_set += int((torch.sort(got, 1).values == torch.sort(want, 1).values)
                        .all(1).sum())
        same_order += int((got == want).all(1).sum())
        same_exact += int((torch.sort(got, 1).values == torch.sort(exact, 1).values)
                          .all(1).sum())
        full = mf.scores_all_items(params, uids, item_chunk=EVAL_CHUNK)
        full = full.masked_fill(train[uids], float("-inf"))
        score_err = max(score_err, float(
            (torch.sort(full.gather(1, got), 1).values
             - torch.sort(full.gather(1, exact), 1).values).abs().max()))
        del cand, scores, by_id, full
    assert same_set == PARITY_USERS, \
        f"full expansion differs from its own scores' top-k for {PARITY_USERS - same_set} users"
    assert score_err <= PARITY_SCORE_TOL, (
        f"full expansion's ids score up to {score_err:.3e} away from topk_all_items' "
        f"top-{SERVE_K} under the exact path's products (tol {PARITY_SCORE_TOL})")
    users = torch.arange(n_users, device=dev)
    exact = torch.cat([mf.topk_all_items(params, users[u0:u0 + B], SERVE_K,
                                         item_chunk=EVAL_CHUNK, exclude_mask=train[u0:u0 + B])
                       for u0 in range(0, n_users, B)])
    recalls = []
    for expand in SERVE_RECALL_EXPANDS:
        pruned = torch.cat([retrieval.topk_pruned(params, users[u0:u0 + 256], SERVE_K, index,
                                                  expand_tiles=expand,
                                                  exclude_mask=train[u0:u0 + 256])
                            for u0 in range(0, n_users, 256)])
        hits = (pruned[:, :, None] == exact[:, None, :]).any(2).sum(1)
        recalls.append(float(hits.float().mean()) / SERVE_K)
    # Tiles chosen by the centroids must beat tiles chosen by chance (whose
    # recall is the share of the catalog they hold), and more tiles must
    # find no fewer of the exact top-k.
    chance = [e * SERVE_TILE_ROWS / n_items for e in SERVE_RECALL_EXPANDS]
    assert all(r >= 2 * c for r, c in zip(recalls, chance)), \
        f"pruned recall {recalls} is not twice chance {chance}"
    assert recalls == sorted(recalls), f"recall falls with more tiles: {recalls}"
    print(f"[16 pruned] topk_pruned at expand_tiles={index.num_tiles} (every tile), "
          f"top-{SERVE_K} with the training positives excluded: the same ids as the stable "
          f"top-{SERVE_K} of the same products for {same_set} of {PARITY_USERS} users (the "
          f"same order for {same_order}); the same id sets as topk_all_items (other "
          f"products: a near tie may swap) for {same_exact}, their scores under "
          f"topk_all_items' products within {score_err:.3e} of its top-{SERVE_K}'s (tol "
          f"{PARITY_SCORE_TOL}); Recall@{SERVE_K} of the pruned top-{SERVE_K} against the "
          f"exact one over all {n_users} users: " + ", ".join(
              f"{r:.4f} at {e} tiles ({e * SERVE_TILE_ROWS} candidates; chance {c:.4f})"
              for e, r, c in zip(SERVE_RECALL_EXPANDS, recalls, chance))
          + f" | {card}", flush=True)
    del exact, pruned

    # A second trained state for the refreshes.
    second, _ = trainer.train_mf(cfg0, ds, ENGINE_STEPS, batch_size=B, seed=1,
                                 steps_per_dispatch=ENGINE_WINDOW, device="cuda")
    dds = pipeline.device_cf_dataset(ds, dev)
    more = trainer.EpochExecutor(mf.make_scan_body(cfg0, lambda s: pipeline.cf_batch_device(
        dds, 1, s, B), 1), ENGINE_WINDOW)
    state = mf.MFState(params, None, None, 0)
    probe = np.arange(SERVE_MAX_BATCH)

    def direct(p, idx, pruner):
        ids = torch.as_tensor(probe, device=dev)
        if pruner == "tile":
            return retrieval.topk_pruned(p, ids, SERVE_K, idx, expand_tiles=SERVE_EXPAND,
                                         exclude_mask=train[ids]).cpu().numpy()
        return mf.topk_all_items(p, ids, SERVE_K, item_chunk=EVAL_CHUNK,
                                 exclude_mask=train[ids]).cpu().numpy()

    for pruner in ("exact", "tile"):
        server = BatchingRecommender(state, SERVE_K, pruner=pruner,
                                     index=index if pruner == "tile" else None,
                                     expand_tiles=SERVE_EXPAND,
                                     max_batch=SERVE_MAX_BATCH,
                                     max_wait_ms=SERVE_WAIT_MS, item_chunk=EVAL_CHUNK,
                                     exclude_mask=train)
        qps, p50, p99, answers = serve_load(server, np.arange(n_users), SERVE_REQUESTS)
        calls = server.stats["device_calls"]
        assert server.trace_count == 1, server.trace_count
        call_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            first = server.recommend_many(probe)
            call_ms.append(1e3 * (time.perf_counter() - t0))
        assert np.array_equal(first, direct(params, index, pruner)), \
            f"{pruner}: recommend_many differs from the direct top-k"
        assert all(np.array_equal(answers[u], first[u]) for u in answers
                   if u < SERVE_MAX_BATCH), f"{pruner}: a coalesced answer differs"
        # refresh_from a second trained state: the answers move to its top-k,
        # and training that state further changes nothing served.
        assert server.refresh_from(second, on_error="raise")
        idx2 = (retrieval.refresh_index(index, second.params.item_table)
                if pruner == "tile" else None)
        want2 = direct(second.params, idx2, pruner)
        got2 = server.recommend_many(probe)
        assert np.array_equal(got2, want2), f"{pruner}: refreshed answers differ"
        assert not np.array_equal(got2, first), f"{pruner}: the refresh moved nothing"
        before = second.params.item_table.clone()
        second, _ = more.run(second, ENGINE_STEPS, ENGINE_WINDOW)
        torch.cuda.synchronize()
        assert not torch.equal(before, second.params.item_table), "no step moved"
        assert np.array_equal(server.recommend_many(probe), got2), \
            f"{pruner}: training the source moved the served answers"
        del before
        # A wrong-shaped refresh degrades and keeps the answers; the next
        # good one restores ok.
        bad = mf.MFState(mf.MFParams(second.params.user_table[:100],
                                     second.params.item_table, None), None, None, 0)
        assert not server.refresh_from(bad)
        health = server.health
        assert health["status"] == "degraded" and health["refresh_failures"] == 1, health
        assert np.array_equal(server.recommend_many(probe), got2)
        assert server.refresh_from(second) and server.health["status"] == "ok"
        assert server.trace_count == 1, server.trace_count
        print(f"[16 serve] BatchingRecommender pruner={pruner} (k={SERVE_K}, max_batch "
              f"{SERVE_MAX_BATCH}, max_wait {SERVE_WAIT_MS} ms"
              + (f", {SERVE_EXPAND} tiles" if pruner == "tile" else
                 f", chunks of {EVAL_CHUNK}") + f", training positives excluded) on the "
              f"trained MF_100M_PALLAS: {SERVE_REQUESTS} concurrent single-user requests "
              f"from threads released together: {qps:.0f} qps, p50 {p50:.2f} ms, p99 "
              f"{p99:.2f} ms, {calls} device calls (warm-up included), call shapes 1; "
              f"recommend_many of {SERVE_MAX_BATCH} users alone "
              f"{statistics.median(call_ms):.2f} ms a call (median of 10), equal to the "
              f"direct top-k; refresh_from a second "
              f"trained state moved them to its top-k, and {ENGINE_WINDOW} more steps on "
              f"that state (its tables changed in place) left them unchanged; a "
              f"wrong-shaped refresh left status "
              f"degraded ({health['last_refresh_error'][:60]}...) and the answers, the "
              f"next good one restored ok | {card}", flush=True)
        if pruner == "exact":
            server.stop()
    tile_server = server
    del second, state, params, index, train, dds
    torch.cuda.empty_cache()

    # The exact pruner over the int8 AMAZON tables.
    params8 = mf.MFParams(qz.QuantizedTable(*(x.to(dev) for x in amazon.user_table)),
                          qz.QuantizedTable(*(x.to(dev) for x in amazon.item_table)), None)
    users8 = amazon_users[:SERVE_MAX_BATCH].numpy()
    for c in counters:
        c.reset()
    with BatchingRecommender(mf.MFState(params8, None, None, 0), SERVE_K,
                             max_batch=SERVE_MAX_BATCH, item_chunk=EVAL_CHUNK) as server:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got8 = server.recommend_many(users8)
            times.append(1e3 * (time.perf_counter() - t0))
    want8 = mf.topk_all_items(params8, torch.as_tensor(users8, device=dev), SERVE_K,
                              item_chunk=EVAL_CHUNK).cpu().numpy()
    assert np.array_equal(got8, want8), "int8 serve differs from the direct top-k"
    launches = {c.name: c.count() for c in counters}
    assert not any(launches.values()), launches
    print(f"[16 serve] AMAZON int8 exact pruner, recommend_many of {SERVE_MAX_BATCH} "
          f"users over {qz.num_rows(params8.item_table)} items in chunks of {EVAL_CHUNK} "
          f"(table_spec {qz.table_spec(params8.item_table)}): "
          f"{statistics.median(times):.1f} ms a "
          f"call (median of 3: {', '.join(f'{t:.1f}' for t in times)}), equal to the "
          f"direct top-k; the port's kernels launched by this serve: {launches} | {card}",
          flush=True)
    return tile_server


#: phase 17: the streaming run of MF_100M_PALLAS: ring capacity, events and
#: steps a round, rounds, recency, the probe (at event 16,384: user 1, the
#: last item, 32 times), checkpoints every 4 rounds, the crash of 17b (in
#: round 11), the popularity rounds of 17c and the CLI's rounds of 17f.
STREAM_CAP, STREAM_EVENTS, STREAM_STEPS, STREAM_ROUNDS = 32, 4096, 32, 16
STREAM_RECENCY, STREAM_CKPT_EVERY, STREAM_FAIL_AT = 0.5, 4, 43_000
STREAM_PROBE_AT, STREAM_PROBE_REPEAT, STREAM_TOPK = 16_384, 32, 10
STREAM_POP_ROUNDS, STREAM_CLI_ROUNDS = 8, 4


class RecordingSampler:
    """Delegates to a sampler and marks, on the device, every item it
    draws (no host sync), so phase 17c can see which items were drawn."""

    def __init__(self, inner, num_items: int, dev):
        import torch
        self.inner = inner
        self.name = inner.name
        self.drawn = torch.zeros(num_items, dtype=torch.bool, device=dev)

    def sample(self, state, gen, shape):
        out = self.inner.sample(state, gen, shape)
        self.drawn[out.ids.reshape(-1)] = True
        return out


def stream_fingerprint(trainer) -> dict:
    """Clones of everything a bit-for-bit resume must reproduce: both
    tables, the ring, the counters and the per-step losses."""
    d = trainer.data
    return {"user_table": trainer.state.params.user_table.clone(),
            "item_table": trainer.state.params.item_table.clone(),
            "tile_ids": trainer.state.tile.tile_ids.clone(),
            "tile_emb": trainer.state.tile.tile_emb.clone(),
            "train_pos": d.train_pos.clone(), "item_weights": d.item_weights.clone(),
            "row_count": d.row_count.clone(), "write_pos": d.write_pos.clone(),
            "counters": (trainer.step, trainer.events, trainer.rounds, trainer.salt),
            "losses": trainer.loss_history()}


def streaming_phase(dev, card: str, mf_trained, tile_server, counters) -> None:
    """Phase 17: the streaming service at MF_100M_PALLAS width (17a), a
    crash resumed bit for bit (17b), live popularity negatives (17c), the
    serve launcher's streaming refresh of phase 16's tile server (17d), the
    chaos harness (17e) and the streaming CLI (17f)."""
    import contextlib
    import io

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.heat_mf import MF_100M_PALLAS
    from repro_torch.core import mf, samplers
    from repro_torch.core.engine import resolve_engine
    from repro_torch.data import pipeline
    from repro_torch.launch import stream as stream_cli
    from repro_torch.launch.server import BatchingRecommender
    from repro_torch.resilience.chaos import run_chaos
    from repro_torch.stream.service import StreamingConfig, StreamingTrainer
    from repro_torch.stream.sources import ProbeInjector, SyntheticStream
    cfg0 = MF_100M_PALLAS
    rounds, events, probe_at = STREAM_ROUNDS, STREAM_EVENTS, STREAM_PROBE_AT
    n_users, n_items = cfg0.num_users, cfg0.num_items
    probe_user, probe_item = 1, n_items - 1
    t_phase = time.perf_counter()
    logs = []

    def make(ckpt_dir, cfg=cfg0, engine=None, **kw):
        stream = ProbeInjector(
            SyntheticStream(n_users, n_items, seed=0, user_drift=0.01, item_drift=0.01),
            probe_at, probe_user, probe_item, repeat=STREAM_PROBE_REPEAT)
        scfg = StreamingConfig(capacity=STREAM_CAP, micro_batch=events,
                               steps_per_round=STREAM_STEPS, batch_size=B,
                               recency=STREAM_RECENCY, seed=0, ckpt_dir=ckpt_dir,
                               ckpt_every=STREAM_CKPT_EVERY, **kw)
        return StreamingTrainer(cfg, stream, scfg, engine=engine, device=dev,
                                log=logs.append)

    def take_launches():
        got = {c.name: c.count() for c in counters}
        for c in counters:
            c.reset()
        return got

    # segment sums: the slot reduction (the tile sampler's alone) and the
    # tile write-through
    per_round = {"ccl_stats": STREAM_STEPS, "ccl_bwd": STREAM_STEPS,
                 "gather_fma": 2 * STREAM_STEPS, "gather_dequant": 0,
                 "ccl_stats_shared": 0, "ccl_bwd_shared": 0, "flash_attention": 0,
                 "segment_sum": 2 * STREAM_STEPS}
    per_round_pop = dict(per_round, segment_sum=STREAM_STEPS)

    # ---- 17a: a cold-start streaming run with a live server ---------------
    pipeline.APPLY_EVENTS_SHAPES.reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        trainer = make(d)
        server = BatchingRecommender(trainer.state, STREAM_TOPK)
        trainer.recommender = server
        take_launches()
        stats, walls = [], []
        t_probe = fresh_s = fresh_round = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            ev0 = trainer.events
            t_r = time.perf_counter()
            assert trainer.run(rounds=1) == 1
            walls.append(time.perf_counter() - t_r)
            stats.append(dict(trainer.last_round_stats))
            launches = take_launches()
            assert launches == per_round, (trainer.rounds, launches)
            if t_probe is None and ev0 <= probe_at < trainer.events:
                t_probe = time.perf_counter()
            if t_probe is not None and fresh_s is None \
                    and probe_item in server.recommend(probe_user).tolist():
                fresh_s, fresh_round = time.perf_counter() - t_probe, trainer.rounds
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        assert trainer.rounds == rounds and trainer.rollbacks == 0 and trainer.restarts == 0
        assert trainer.guard.trips == 0 and trainer.guard.checks == rounds
        losses = trainer.loss_history()
        assert len(losses) == rounds * STREAM_STEPS
        assert all(math.isfinite(x) for x in losses), losses
        assert trainer.executor.trace_counter.count == 1
        assert pipeline.APPLY_EVENTS_SHAPES.count == 1
        assert server.trace_count == 1 and server.health["status"] == "ok"
        assert server.health["refreshes"] == rounds
        saved = sorted(os.listdir(d))
        clean = stream_fingerprint(trainer)
        server.stop()
    del trainer, server
    n_events = rounds * events + STREAM_PROBE_REPEAT
    ms = {k: [1e3 * s[f"{k}_s"] for s in stats] for k in ("ingest", "train", "refresh")}
    ckpt_ms = [1e3 * (w - s["ingest_s"] - s["train_s"] - s["refresh_s"])
               for w, s in zip(walls, stats) if s["round"] % STREAM_CKPT_EVERY == 0]
    plain_ms = [1e3 * w for w, s in zip(walls, stats) if s["round"] % STREAM_CKPT_EVERY]
    med = {k: statistics.median(v[1:]) for k, v in ms.items()}
    fresh = (f"probe served in {fresh_s:.2f} s (round {fresh_round})" if fresh_s is not None
             else f"probe not served in top-{STREAM_TOPK} within the run")
    print(f"[17a stream] StreamingTrainer on {cfg0.num_users} x {cfg0.num_items} x "
          f"{cfg0.emb_dim} ({cfg0.backend}+{cfg0.update_impl}+tile {cfg0.tile_size}, n="
          f"{cfg0.num_negatives}, lr {cfg0.lr}), cold start: {rounds} rounds of {events} "
          f"events (SyntheticStream drift 0.01/0.01; probe user {probe_user} x item "
          f"{probe_item} x{STREAM_PROBE_REPEAT} at event {probe_at}), {STREAM_STEPS} steps "
          f"of batch {B} a round over a ring of {STREAM_CAP} (recency {STREAM_RECENCY}), "
          f"a live exact top-{STREAM_TOPK} server refreshed every round, checkpoints every "
          f"{STREAM_CKPT_EVERY} rounds ({saved}): ms a round (median of rounds 2-{rounds}; "
          f"round 1) ingest {med['ingest']:.2f} ({ms['ingest'][0]:.2f}), train "
          f"{med['train']:.2f} ({ms['train'][0]:.2f}) = "
          f"{STREAM_STEPS / (med['train'] / 1e3):.0f} steps/s, refresh {med['refresh']:.2f} "
          f"({ms['refresh'][0]:.2f}); train ms by round "
          f"[{', '.join(f'{t:.0f}' for t in ms['train'])}] (checkpoints after rounds "
          f"{STREAM_CKPT_EVERY}, {2 * STREAM_CKPT_EVERY}, ...); a round without a checkpoint "
          f"{statistics.median(plain_ms):.2f} ms wall, a checkpoint "
          f"{statistics.median(ckpt_ms):.0f} ms (round wall less its parts, median of "
          f"{len(ckpt_ms)}); loss {losses[0]:.4f} -> {losses[-1]:.4f} (round means "
          f"{stats[0]['loss']:.4f} -> {stats[-1]['loss']:.4f}), all finite, no guard trip; "
          f"{n_events} events in {wall:.2f} s = {n_events / wall:,.0f} events/s end to end; "
          f"freshness: "
          f"{fresh}; launches a round {per_round['ccl_stats']}/{per_round['ccl_bwd']}/"
          f"{per_round['gather_fma']}/{per_round['segment_sum']} "
          f"(ccl_stats/ccl_bwd/gather_fma/segment_sum) in every round; window "
          f"lengths 1, event shapes 1, serving call shapes 1; peak device memory "
          f"{peak_gb:.2f} GB | {card}", flush=True)

    # ---- 17b: the same run, crashed in round 11 and resumed ---------------
    with tempfile.TemporaryDirectory() as d:
        logs.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crashed = make(d, fail_at_event=STREAM_FAIL_AT)
        assert crashed.run(rounds=rounds) == rounds
        torch.cuda.synchronize()
        t_crash = time.perf_counter() - t0
        assert crashed.restarts == 1, crashed.restarts
        assert any("injected failure" in m for m in logs), logs
        got = stream_fingerprint(crashed)
        for k, v in clean.items():
            same = torch.equal(v, got[k]) if isinstance(v, torch.Tensor) else v == got[k]
            assert same, f"17b: the resumed run differs at {k}"
        # two more rounds with no server attached (17a refreshes a live one
        # every round): does its worker thread slow the training steps?
        detached = []
        for _ in range(2):
            crashed.run(rounds=1)
            detached.append(dict(crashed.last_round_stats))
        take_launches()
        # one more round, profiled: device busy time against its wall time
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            crashed.run(rounds=1)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kern)
        n_launch = sum(e.count for e in kern)
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        host = sorted((e for e in prof.key_averages() if e.device_type != DeviceType.CUDA),
                      key=lambda e: -e.self_cpu_time_total)[:8]
        take_launches()
    del crashed, clean, got
    torch.cuda.empty_cache()
    round_us = 1e3 * statistics.median(plain_ms)
    busy = ("the profiler saw no device time: not measured" if busy_us <= 0 else
            f"a profiled round {busy_us:.0f} us of device time in {n_launch} launches "
            f"({n_launch / STREAM_STEPS:.0f} a step), {100 * busy_us / round_us:.1f}% of "
            f"17a's median round wall ({round_us:.0f} us); top: " + ", ".join(
                f"{e.key[:40]} {e.self_device_time_total:.0f} us" for e in top)
            + "; host ops by self time a step (under the profiler): " + ", ".join(
                f"{e.key[:32]} {e.self_cpu_time_total / STREAM_STEPS:.0f} us "
                f"(x{e.count / STREAM_STEPS:g})" for e in host))
    print(f"[17b resume] the same run with a failure injected at event {STREAM_FAIL_AT} "
          f"(round {STREAM_FAIL_AT // events + 1}): restarts 1 ({logs[0][:70]}...), resumed from "
          f"the round-{(STREAM_FAIL_AT // events) // STREAM_CKPT_EVERY * STREAM_CKPT_EVERY} "
          f"checkpoint: both tables, the tile, the ring (train_pos, item_weights, "
          f"row_count, write_pos), the counters and all {rounds * STREAM_STEPS} losses "
          f"identical bit for bit to 17a's; {t_crash:.1f} s; two more rounds with no "
          f"server attached: train ms " + ", ".join(
              f"{1e3 * s['train_s']:.2f}" for s in detached) + " (17a, live server: "
          f"{med['train']:.2f}), ingest ms " + ", ".join(
              f"{1e3 * s['ingest_s']:.2f}" for s in detached) + f" (17a: "
          f"{med['ingest']:.2f}); {busy} | {card}", flush=True)

    # ---- 17c: live popularity negatives -----------------------------------
    cfg_pop = dataclasses.replace(cfg0, sampler="popularity")
    engine = resolve_engine(cfg_pop)
    rec = RecordingSampler(engine.sampler, n_items, dev)
    trainer = make(None, cfg=cfg_pop, engine=dataclasses.replace(engine, sampler=rec))
    take_launches()
    drawn_new = []
    t0 = time.perf_counter()
    for r in range(STREAM_POP_ROUNDS):
        seen = trainer.data.item_weights > 0
        rec.drawn.zero_()
        assert trainer.run(rounds=1) == 1
        assert take_launches() == per_round_pop, r
        first_seen = (trainer.data.item_weights > 0) & ~seen
        if r:
            drawn_new.append(int((rec.drawn & prev_new).sum()))
        prev_new = first_seen
    torch.cuda.synchronize()
    t_pop = time.perf_counter() - t0
    assert trainer.executor.trace_counter.count == 1 and trainer.guard.trips == 0
    assert all(math.isfinite(x) for x in trainer.loss_history())
    assert all(n > 0 for n in drawn_new), drawn_new
    n_weighted = int((trainer.data.item_weights > 0).sum())
    del trainer, rec, seen, first_seen, prev_new
    runs = []
    for _ in range(2):
        t = make(None, cfg=cfg_pop)
        assert t.run(rounds=2) == 2
        runs.append(stream_fingerprint(t))
        del t
    take_launches()
    for k, v in runs[0].items():
        same = torch.equal(v, runs[1][k]) if isinstance(v, torch.Tensor) else v == runs[1][k]
        assert same, f"17c: two 2-round popularity runs differ at {k}"
    del runs
    torch.cuda.empty_cache()
    print(f"[17c popularity] {cfg_pop.backend}+{cfg_pop.update_impl}+popularity fed the "
          f"live ring counts, {STREAM_POP_ROUNDS} rounds as 17a: launches a round "
          f"{per_round_pop['ccl_stats']}/{per_round_pop['ccl_bwd']}/"
          f"{per_round_pop['gather_fma']}/{per_round_pop['segment_sum']} in "
          f"every round, {STREAM_POP_ROUNDS * STREAM_STEPS / t_pop:.0f} steps/s over the run "
          f"(ingest and refresh of the CDF included); {n_weighted} items with a count at "
          f"the end; items first ingested in round r drawn as negatives in round r+1: "
          f"{drawn_new} (r = 1..{STREAM_POP_ROUNDS - 1}); two 2-round runs identical bit for bit "
          f"| {card}", flush=True)

    # ---- 17d: the serve launcher's streaming refresh of phase 16's server --
    params = mf.MFParams(mf_trained.user_table.to(dev), mf_trained.item_table.to(dev), None)
    tile = samplers.tile_init(mf.generator(mf.fold_in(17, 2), dev), params.item_table,
                              cfg0.tile_size)
    state = mf.MFState(params, tile, None, STEPS + WINDOW)       # a clone: .to(dev)
    shapes, refreshes = tile_server.trace_count, tile_server.health["refreshes"]
    probe = np.arange(SERVE_MAX_BATCH)
    before = tile_server.recommend_many(probe)
    live = SyntheticStream(n_users, n_items, seed=1, total=512, user_drift=0.01,
                           item_drift=0.01)
    streamer = StreamingTrainer(
        cfg0, live, StreamingConfig(capacity=16, micro_batch=256, steps_per_round=25,
                                    batch_size=128, seed=0),
        state=state, data=pipeline.stream_ring_dataset(n_users, n_items, 16, device=dev),
        engine=resolve_engine(cfg0), recommender=tile_server, device=dev,
        log=logs.append)
    take_launches()
    assert streamer.run(rounds=2) == 2
    launches = take_launches()
    after = tile_server.recommend_many(probe)
    assert launches["ccl_stats"] == launches["ccl_bwd"] == 50, launches
    assert launches["gather_fma"] == 100, launches
    assert tile_server.trace_count == shapes == 1, tile_server.trace_count
    assert tile_server.health["refreshes"] == refreshes + 2
    assert tile_server.health["status"] == "ok"
    assert not np.array_equal(before, after), "17d: the streaming refresh moved nothing"
    print(f"[17d serve refresh] serve.py's two warm-started streaming rounds (512 live "
          f"events, 25 steps of batch 128 a round, ring 16, cold) on a clone of phase 5's "
          f"trained MF_100M_PALLAS, refreshing phase 16's tile-pruned server: "
          f"{streamer.events} events, {streamer.step} total steps, launches {launches}, "
          f"server refreshes {refreshes} -> {tile_server.health['refreshes']}, status "
          f"{tile_server.health['status']}, call shapes {tile_server.trace_count} "
          f"(unchanged), answers for {SERVE_MAX_BATCH} users moved | {card}", flush=True)
    tile_server.stop()
    del streamer, state, params, tile, live
    torch.cuda.empty_cache()

    # ---- 17e: the chaos harness on the card --------------------------------
    t0 = time.perf_counter()
    report = run_chaos(seed=0, rounds=10, device=dev)
    t_chaos = time.perf_counter() - t0
    take_launches()
    assert report["problems"] == [], report["problems"]
    print(f"[17e chaos] run_chaos(seed=0, rounds=10) at the reference's defaults on the "
          f"card in {t_chaos:.1f} s: schedule {report['schedule']}; " + "; ".join(
              f"{f['kind']} round {f['round']} detected and recovered in "
              f"{1e3 * f['recovery_s']:.1f} ms" for f in report["faults"])
          + f"; problems []; final {report['final']['rounds']} rounds, rollbacks "
          f"{report['final']['rollbacks']}, retries {report['final']['stream_retries']}, "
          f"health {report['final']['health']['status']} | {card}", flush=True)

    # ---- 17f: the streaming CLI on the card --------------------------------
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        stream_cli.main(["--backend", "pallas", "--users", str(n_users), "--items",
                         str(n_items), "--emb-dim", str(cfg0.emb_dim), "--rounds",
                         str(STREAM_CLI_ROUNDS)])
    t_cli = time.perf_counter() - t0
    launches = take_launches()
    lines = out.getvalue().strip().splitlines()
    summary = [ln for ln in lines if " rounds, " in ln and "events/s end-to-end" in ln]
    assert summary, lines
    assert launches["ccl_stats"] == launches["ccl_bwd"] > 0, launches
    for ln in lines:
        print(f"[17f cli] {ln}", flush=True)
    print(f"[17f cli] launch.stream.main(--backend pallas --users {n_users} --items "
          f"{n_items} --emb-dim {cfg0.emb_dim} --rounds {STREAM_CLI_ROUNDS}) on the card in "
          f"{t_cli:.1f} s; launches {launches} | {card}", flush=True)
    print(f"[17 stream] phase 17 took {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)


#: phase 18: sharded MF_100M_PALLAS: the steps of the single-device run and
#: of the data=2 run (18a, 18b), of the model=2 run (18c), the window, the
#: checkpoint interval, the injected failure and the elastic restore's step
#: (18d), and the CLI's steps (18e).
SHARD_STEPS, SHARD_MODEL_STEPS, SHARD_WINDOW = 32, 16, 16
SHARD_CKPT, SHARD_FAIL, SHARD_ELASTIC_FROM = 8, 20, 24
SHARD_CLI_STEPS = 4
SHARD_ATOL = 1e-5


def shard_dataset(ds, num_users: int):
    """Phase 5's dataset with its rows repeated over ``num_users`` users (user
    u has user ``u % 4,096``'s positives), so the batches touch every user
    shard, as a dataset of the model's width would."""
    import numpy as np
    from repro_torch.data import pipeline
    rows = np.arange(num_users) % ds.num_users
    return pipeline.CFDataset(num_users, ds.num_items, ds.train_pos[rows],
                              ds.test_pos[rows])


def host_tree(state) -> dict:
    """An MF state's leaves as the numpy arrays a checkpoint stores, by name
    (copies: training on does not change them)."""
    import numpy as np
    from repro_torch.train import checkpoint as ckpt
    return {n: np.array(ckpt.leaf_to_numpy(x)) for n, x in ckpt.named_leaves(state)}


def load_tree(path: str) -> dict:
    """A checkpoint directory's leaves as numpy arrays, by name."""
    import numpy as np
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return {leaf["name"]: np.load(os.path.join(path, leaf["file"]))
            for leaf in leaves}


def tree_diff(tree: dict, ref: dict):
    """Largest |tree - ref| over the leaves and whether every leaf is the
    same bits; the names, ids and counters must agree exactly."""
    import numpy as np
    assert sorted(tree) == sorted(ref), (sorted(tree), sorted(ref))
    worst, same = 0.0, True
    for name, want in ref.items():
        got = tree[name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if want.dtype.kind == "f":
            worst = max(worst, float(np.abs(got.astype(np.float64)
                                            - want).max(initial=0.0)))
        else:
            assert np.array_equal(got, want), f"{name} differs"
        same = same and np.array_equal(got, want)
    return worst, same


def shard_launches(steps: int) -> dict:
    """The launches of ``steps`` MF_100M_PALLAS steps: one stats, one
    backward, two gather-FMA (the user shard, then the item groups) and two
    segment sums (the slot reduction, the tile write-through)."""
    return {"ccl_stats": steps, "ccl_bwd": steps, "gather_fma": 2 * steps,
            "segment_sum": 2 * steps}


def exchange_split(executor, state, start: int, length: int, mesh, prof_on: bool):
    """Two more windows of a sharded run, each begun at a barrier: one with
    every exchange timed on the host between two device synchronizations,
    then (when ``prof_on``) one profiled.  Returns ms a step of the first
    window's wall and of its exchanges, and the second's device busy ms and
    kernel launches a step (None unless profiled, or where the profiler saw
    no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed import sharding as shd
    spent = [0.0]
    plain = shd.all_gather_parts

    def timed(parts, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(parts, group)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    shd.all_gather_parts = timed
    try:
        torch.cuda.synchronize()
        mesh.barrier()
        t0 = time.perf_counter()
        state, _ = executor.run(state, start, length)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        shd.all_gather_parts = plain
    busy = launches = None
    mesh.barrier()
    if prof_on:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = executor.run(state, start + length, length)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in kern)
        if us > 0:
            busy = us / 1e3 / length
            launches = sum(e.count for e in kern) / length
    else:
        state, _ = executor.run(state, start + length, length)
    return 1e3 * wall / length, 1e3 * spent[0] / length, busy, launches


def shard_rank(cfg, ds, ref_dir: str, ref_losses: list, work: str) -> dict:
    """One of phase 18's two gloo ranks on card 0: 18b (data=2, 32 steps,
    then a timed window and an exchange-timed window), 18d (the same run
    crashed at step 20 and resumed) and 18c (model=2, 16 steps).  Rank 0
    holds each gathered state to the single-device run's checkpoints."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import mf
    from repro_torch.core import mf_distributed as mfd
    from repro_torch.data import pipeline
    from repro_torch.kernels import ccl_similarity, embedding_update, segment_sum
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh, rank_device
    from repro_torch.train import trainer
    dev = rank_device("cuda")
    rank = dist.get_rank()
    counters = (ccl_similarity.STATS_LAUNCHES, ccl_similarity.BWD_LAUNCHES,
                embedding_update.GATHER_FMA_LAUNCHES, segment_sum.SEGMENT_SUM_LAUNCHES)
    out: dict = {"device": str(dev)}
    logs: list = []

    def drive(mesh, steps, launched=None, **kw):
        for c in counters:
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses = trainer.train_mf(
            cfg, ds, steps, batch_size=B, steps_per_dispatch=SHARD_WINDOW,
            mesh=mesh, device=dev, log=logs.append if rank == 0 else (lambda *_: None),
            **kw)
        torch.cuda.synchronize()
        launches = {c.name: c.count() for c in counters}
        assert launches == shard_launches(launched or steps), (rank, launches)
        return state, losses, launches, time.perf_counter() - t0

    def timed_window(plan, state, start):
        dds = pipeline.device_cf_dataset(ds, dev)
        body = mf.make_scan_body(cfg, lambda s: pipeline.cf_batch_device(
            dds, 0, s, B), 0, plan=plan)
        executor = trainer.EpochExecutor(body, SHARD_WINDOW)
        torch.cuda.synchronize()
        plan.mesh.barrier()          # rank 0 compared states meanwhile
        t0 = time.perf_counter()
        state, window = executor.run(state, start, SHARD_WINDOW)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(window).all())
        return executor, state, 1e3 * (time.perf_counter() - t0) / SHARD_WINDOW

    # ---- 18b: data=2 ----------------------------------------------------------
    mesh = make_data_mesh(2)
    plan = mfd.make_sharding_plan(cfg, mesh)
    state, losses, launches, secs = drive(mesh, SHARD_STEPS)
    out["launches"], out["secs"] = launches, secs
    out["rows"] = (plan.users.own, plan.items.own, plan.batch_rows(B))
    gathered = plan.gather_state(state)
    whole = host_tree(gathered) if rank == 0 else None
    del gathered
    if rank == 0:
        out["err"], out["same"] = tree_diff(whole, load_tree(os.path.join(
            ref_dir, f"step_{SHARD_STEPS:08d}")))
        out["loss_err"] = max(abs(a - b) for a, b in zip(losses, ref_losses))
        assert out["err"] <= SHARD_ATOL and out["loss_err"] <= SHARD_ATOL, out
    clean_losses = losses
    executor, state, out["ms"] = timed_window(plan, state, SHARD_STEPS)
    out["split"] = exchange_split(executor, state, SHARD_STEPS + SHARD_WINDOW,
                                  SHARD_WINDOW, mesh, prof_on=rank == 0)
    del state, executor

    # ---- 18d: 18b crashed at step 20, checkpoints every 8 steps ---------------
    replayed = SHARD_FAIL - SHARD_FAIL // SHARD_CKPT * SHARD_CKPT
    state, losses, launches, secs = drive(
        mesh, SHARD_STEPS, SHARD_STEPS + replayed, ckpt_dir=os.path.join(work, "crash"),
        ckpt_every=SHARD_CKPT, fail_at_step=SHARD_FAIL)
    gathered = plan.gather_state(state)
    crashed = host_tree(gathered) if rank == 0 else None
    del gathered
    if rank == 0:
        resumed = losses[:SHARD_FAIL - replayed] + losses[SHARD_FAIL:]
        out["crash"] = (len(losses), resumed == clean_losses,
                        tree_diff(crashed, whole)[1], list(logs), secs)
        assert out["crash"][1] and out["crash"][2], out["crash"]
    del state, crashed, whole

    # ---- 18c: model=2 (item rows split) ----------------------------------------
    mesh_m = make_host_mesh(1, 2)
    plan_m = mfd.make_sharding_plan(cfg, mesh_m)
    state, losses, launches, secs = drive(mesh_m, SHARD_MODEL_STEPS)
    out["m_launches"], out["m_secs"] = launches, secs
    out["m_rows"] = (plan_m.users.own, plan_m.items.own, plan_m.batch_rows(B))
    gathered = plan_m.gather_state(state)
    whole = host_tree(gathered) if rank == 0 else None
    del gathered
    if rank == 0:
        out["m_err"], out["m_same"] = tree_diff(whole, load_tree(os.path.join(
            ref_dir, f"step_{SHARD_MODEL_STEPS:08d}")))
        out["m_loss_err"] = max(abs(a - b) for a, b in zip(
            losses, ref_losses[:SHARD_MODEL_STEPS]))
        assert out["m_err"] <= SHARD_ATOL and out["m_loss_err"] <= SHARD_ATOL, out
    _, _, out["m_ms"] = timed_window(plan_m, state, SHARD_MODEL_STEPS)
    return out


def sharding_phase(dev, card: str, ds0, counters) -> float:
    """Phase 18: sharded MF_100M_PALLAS training over torch.distributed.
    18a: one NCCL rank against the unsharded run; 18b-d: two gloo ranks on
    card 0 (data=2, its crash and resume, model=2) held to the unsharded
    run's checkpoints, and a checkpoint of 2 ranks trained on by 1; 18e: the
    CLI with --mesh-data 2.  Returns the phase's seconds."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.configs.heat_mf import MF_100M_PALLAS
    from repro_torch.core import mf
    from repro_torch.core import mf_distributed as mfd
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import init_rank, make_data_mesh, run_ranks
    from repro_torch.train import trainer
    cfg = MF_100M_PALLAS
    t_phase = time.perf_counter()
    ds = shard_dataset(ds0, cfg.num_users)

    def take_launches():
        got = {c.name: c.count() for c in counters}
        for c in counters:
            c.reset()
        return {k: v for k, v in got.items() if k in shard_launches(0)}

    def steady_ms(state, plan=None):
        dds = pipeline.device_cf_dataset(ds, dev)
        body = mf.make_scan_body(cfg, lambda s: pipeline.cf_batch_device(
            dds, 0, s, B), 0, plan=plan)
        executor = trainer.EpochExecutor(body, SHARD_WINDOW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        executor.run(state, SHARD_STEPS, SHARD_WINDOW)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / SHARD_WINDOW

    with tempfile.TemporaryDirectory() as work:
        ref_dir = os.path.join(work, "ref")
        # ---- the single-device run every sharded run is held to -----------------
        take_launches()
        ref, ref_losses = trainer.train_mf(
            cfg, ds, SHARD_STEPS, batch_size=B, steps_per_dispatch=SHARD_WINDOW,
            device="cuda", ckpt_dir=ref_dir, ckpt_every=SHARD_WINDOW)
        assert take_launches() == shard_launches(SHARD_STEPS)
        ref_tree = host_tree(ref)
        ms_single = steady_ms(ref)
        del ref

        # ---- 18a: one NCCL rank ---------------------------------------------------
        init_rank(0, 1, "nccl", os.path.join(work, "store"), "cuda")
        try:
            probe = torch.ones(1, device=dev)
            dist.all_reduce(probe)
            assert probe.item() == 1.0 and dist.get_backend() == "nccl"
            mesh = make_data_mesh(1)
            plan = mfd.make_sharding_plan(cfg, mesh)
            take_launches()
            one, losses = trainer.train_mf(
                cfg, ds, SHARD_STEPS, batch_size=B, steps_per_dispatch=SHARD_WINDOW,
                mesh=mesh, device=dev)
            launches = take_launches()
            assert launches == shard_launches(SHARD_STEPS), launches
            err, same = tree_diff(host_tree(one), ref_tree)
            loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
            assert err <= SHARD_ATOL and loss_err <= SHARD_ATOL, (err, loss_err)
            ms_one = steady_ms(one, plan)
            del one
        finally:
            dist.destroy_process_group()
        print(f"[18a nccl] MF_100M_PALLAS ({cfg.num_users} x {cfg.num_items} x "
              f"{cfg.emb_dim}, n={cfg.num_negatives}, tile {cfg.tile_size}, refresh "
              f"{cfg.refresh_interval}, pallas+pallas+tile) batch {B} on phase 5's "
              f"dataset rows repeated over {cfg.num_users} users: train_mf("
              f"mesh=make_data_mesh(1)) over NCCL (an all-reduce probe passed) for "
              f"{SHARD_STEPS} steps against the unsharded run: state max abs diff "
              f"{err:.3e}, losses {loss_err:.3e} (tol {SHARD_ATOL:g}); bit-identical: "
              f"{same and loss_err == 0}; launches {launches}; {ms_one:.3f} ms a step "
              f"against {ms_single:.3f} ms unsharded (one more {SHARD_WINDOW}-step "
              f"window each) | {card}", flush=True)
        torch.cuda.empty_cache()

        # ---- 18b-d: two gloo ranks sharing card 0 ---------------------------------
        t0 = time.perf_counter()
        r0, r1 = run_ranks(shard_rank, 2, args=(cfg, ds, ref_dir, ref_losses, work),
                           backend="gloo", device="cuda", timeout=600)
        t_ranks = time.perf_counter() - t0
        wall, exch, busy, launches_p = r0["split"]
        busy_s = "not measured" if busy is None else f"{busy:.3f} ms"
        rest = "not measured" if busy is None else f"{wall - exch - busy:.3f} ms"
        print(f"[18b gloo data=2] 2 ranks on {r0['device']} and {r1['device']} "
              f"(user rows {r0['rows'][0]} and {r1['rows'][0]}, batch rows "
              f"{r0['rows'][2]} and {r1['rows'][2]}, the whole item table each), "
              f"{SHARD_STEPS} steps: gathered state max abs diff {r0['err']:.3e}, "
              f"losses {r0['loss_err']:.3e} against the unsharded run (tol "
              f"{SHARD_ATOL:g}); bit-identical: {r0['same'] and r0['loss_err'] == 0}; "
              f"launches rank 0 {r0['launches']}, rank 1 {r1['launches']}; "
              f"{r0['ms']:.3f} / {r1['ms']:.3f} ms a step on ranks 0 / 1 over one "
              f"more {SHARD_WINDOW}-step window (unsharded {ms_single:.3f} ms) | {card}",
              flush=True)
        print(f"[18b split] rank 0, one more window with each exchange timed "
              f"between two device synchronizations: {wall:.3f} ms a step, "
              f"exchanges {exch:.3f} ms ({100 * exch / wall:.1f}%); device busy "
              f"{busy_s} a step in a profiled window after it, so the rest {rest}; "
              f"{'not measured' if launches_p is None else f'{launches_p:.0f}'} "
              f"device launches a step (unsharded: heatbench's step.launches) | {card}", flush=True)
        n_losses, same_losses, same_state, logs, secs = r0["crash"]
        print(f"[18d crash] the 18b run with checkpoints every {SHARD_CKPT} steps "
              f"and a failure at step {SHARD_FAIL} on both ranks ({logs}; "
              f"{n_losses} losses logged, {secs:.1f} s): losses and the gathered "
              f"state equal the uninterrupted 18b run bit for bit: "
              f"{same_losses and same_state} | {card}", flush=True)
        print(f"[18c gloo model=2] 2 ranks (item rows {r0['m_rows'][1]} and "
              f"{r1['m_rows'][1]}, the whole batch and user table each), "
              f"{SHARD_MODEL_STEPS} steps: state max abs diff {r0['m_err']:.3e}, "
              f"losses {r0['m_loss_err']:.3e} against the unsharded run's first "
              f"{SHARD_MODEL_STEPS} steps; bit-identical: "
              f"{r0['m_same'] and r0['m_loss_err'] == 0}; launches rank 0 "
              f"{r0['m_launches']}, rank 1 {r1['m_launches']}; {r0['m_ms']:.3f} / "
              f"{r1['m_ms']:.3f} ms a step; the two ranks' call took {t_ranks:.1f} s "
              f"| {card}", flush=True)

        # ---- 18d: the step-24 checkpoint of 2 ranks, trained on by 1 --------------
        elastic = os.path.join(work, "elastic")
        name = f"step_{SHARD_ELASTIC_FROM:08d}"
        shutil.copytree(os.path.join(work, "crash", name), os.path.join(elastic, name))
        logs = []
        state, losses = trainer.train_mf(
            cfg, ds, SHARD_STEPS, batch_size=B, steps_per_dispatch=SHARD_CKPT,
            device="cuda", ckpt_dir=elastic, ckpt_every=1000, log=logs.append)
        err, _ = tree_diff(host_tree(state), ref_tree)
        loss_err = max(abs(a - b) for a, b in zip(losses,
                                                   ref_losses[SHARD_ELASTIC_FROM:]))
        assert logs == [f"[mf] resumed from step {SHARD_ELASTIC_FROM}"], logs
        assert len(losses) == SHARD_STEPS - SHARD_ELASTIC_FROM
        assert err <= SHARD_ATOL and loss_err <= SHARD_ATOL, (err, loss_err)
        print(f"[18d elastic] 18d's step-{SHARD_ELASTIC_FROM} checkpoint (saved by "
              f"2 ranks) restored by 1 and trained to step {SHARD_STEPS}: state "
              f"max abs diff {err:.3e}, losses {loss_err:.3e} against the unsharded "
              f"run | {card}", flush=True)
        del state

    # ---- 18e: the CLI -------------------------------------------------------------
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mf", "--steps",
         str(SHARD_CLI_STEPS), "--batch", str(B), "--backend", "pallas",
         "--update-impl", "pallas", "--steps-per-dispatch", "2", "--mesh", "host",
         "--mesh-data", "2", "--dist-backend", "gloo"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=src))
    assert cli.returncode == 0, cli.stderr[-3000:]
    lines = [l for l in cli.stdout.splitlines() if l.startswith(("[launch]", "done:"))]
    assert any("devices=2" in l for l in lines), cli.stdout
    assert any(l.startswith(f"done: {SHARD_CLI_STEPS} steps") for l in lines), cli.stdout
    print(f"[18e cli] launch.train --mf --mesh host --mesh-data 2 --dist-backend gloo "
          f"(MF_100M_PALLAS, batch {B}, {SHARD_CLI_STEPS} steps) in "
          f"{time.perf_counter() - t0:.1f} s: {' / '.join(lines)} | {card}", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"[18 shard] phase 18 took {secs:.1f} s | {card}", flush=True)
    return secs


#: phase 19: LM serving at full width: SERVE_B prompts of SERVE_S tokens,
#: then SERVE_STEPS greedy decode steps with the default bf16 cache
#: (``launch/serve.py``'s options at the full widths).
SERVE_B, SERVE_S, SERVE_STEPS = 8, 1024, 64
#: phase 19c: moonshot-v1-16b-a3b cut to MOE_LAYERS of its 48 layers, trained
#: for MOE_STEPS AdamW steps on one fixed batch of MOE_B x MOE_S tokens.
MOE_LAYERS, MOE_B, MOE_S, MOE_STEPS = 4, 4, 512, 8
#: the reference's decode-after-prefill check (``tests/test_models.py``).
DECODE_REL = 2e-3


def profile_call(fn, wall_s: float, top_n: int = 5) -> str:
    """One call of ``fn`` under the profiler: its device launches and busy
    time against the unprofiled wall time ``wall_s`` of the same call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    if not kern or busy_us <= 0:
        return "the profiler saw no device time: not measured"
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:top_n]
    names = ", ".join(f"{e.key[:40]} {e.self_device_time_total:.1f} us" for e in top)
    return (f"{sum(e.count for e in kern)} kernel launches, device busy "
            f"{busy_us:.1f} us of {1e6 * wall_s:.1f} us unprofiled "
            f"({100 * busy_us / (1e6 * wall_s):.1f}%); top: {names}")


def decode_bound(params, cfg, rows: int, cache_bytes_per_row: int,
                 state_elems: int = 0, cross_bytes: int = 0):
    """Least time (ms) of one decode step of SERVE_B tokens with ``rows``
    cached positions: every weight the step reads read once (of the input
    embedding only the SERVE_B rows; an audio model's decoder, not its
    encoder nor its cross ``wk``/``wv``, whose products the cache holds),
    each cached K/V row read once, an audio model's ``cross_bytes`` of
    encoder K/V read once, a Mamba cache's
    ``state_elems`` fp32 elements (state and conv window) read and written
    once, the new rows and the fp32 logits written; and its operations,
    every product at the fp32 rate (an MoE step runs each expert on its
    capacity of SERVE_B slots, so its products are 2 x SERVE_B x every
    weight too; a hybrid applies its shared block G times) plus the
    attention's over the layers that attend (and the cross-attention's
    over the encoder_seq frames) and the recurrence's 6
    operations an element of the Mamba cache."""
    n_weights = sum(x.numel() for x in _leaves(params)) - cfg.vocab * cfg.d_model
    cross_rows = 0
    if cfg.family == "audio":
        n_weights -= sum(x.numel() for x in _leaves(
            {k: params[k] for k in ("encoder", "enc_norm")}))
        n_weights -= sum(params["blocks"]["cross"][w].numel() for w in ("wk", "wv"))
        cross_rows = cfg.encoder_seq
    n_applied, attn_layers = n_weights, cfg.n_layers
    if cfg.family == "hybrid":
        attn_layers = cfg.n_layers // cfg.shared_attn_every
        n_applied += (attn_layers - 1) * sum(x.numel() for x in _leaves(params["shared"]))
    elif cfg.family == "ssm":
        attn_layers = 0
    nbytes = (4 * n_weights + 4 * SERVE_B * cfg.d_model + 8 * state_elems
              + cache_bytes_per_row * (rows + 1) + cross_bytes + 4 * SERVE_B * cfg.vocab)
    flops = (2 * SERVE_B * n_applied + 6 * state_elems
             + 4 * SERVE_B * cfg.n_heads * cfg.head_dim * (rows + cross_rows) * attn_layers)
    return bound(nbytes, flops)


def _leaves(tree):
    from repro_torch.models.params import tree_items
    return [x for _, x in tree_items(tree)]


def condition_attention_(tree: dict, cfg) -> None:
    """Scale every attention projection in place to 1/sqrt of its
    contraction width (``wq``, ``wk``, ``wv``: d; ``wo``: Hq x hd), where
    the reference's init divides by the second-to-last dimension (Hq, Hkv or
    hd) and so makes the attention logits of order 100: the self-attention
    (``attn``, an audio encoder's too) and an audio decoder's
    cross-attention (``cross``)."""
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    for k, v in tree.items():
        if k in ("attn", "cross"):
            v["wq"].mul_(math.sqrt(hq / d))
            v["wk"].mul_(math.sqrt(hkv / d))
            v["wv"].mul_(math.sqrt(hkv / d))
            v["wo"].mul_(1 / math.sqrt(hq))
        elif isinstance(v, dict):
            condition_attention_(v, cfg)


def kv_members(cache) -> list:
    """The K/V caches of a decode cache: its ``kv`` (one, or the
    interleaved MoE pair) and a hybrid's ``shared_kv``."""
    from repro_torch.models import lm
    kv = [] if cache.kv is None else (
        [cache.kv] if isinstance(cache.kv, lm.KVCache) else list(cache.kv))
    return kv + ([] if cache.shared_kv is None else [cache.shared_kv])


def lm_serve(dev, card: str, label: str, name: str, cfg, params, counters,
             serve_s: int = SERVE_S, serve_steps: int = SERVE_STEPS) -> None:
    """Phase 19's (and 20's, 21's) serving run of one model: prefill SERVE_B
    x ``serve_s`` random tokens (a VLM's first num_patches positions random
    patch rows; an audio model's encoder_seq random frames), pad the cache,
    ``serve_steps`` greedy decode
    steps with the bf16 K/V cache (a Mamba cache stays fp32; tokens kept on
    the card, one readback), one profiled step, and the decode-after-prefill
    check (the reference's ``rel < 2e-3``) held with the attention
    projections conditioned in place (:func:`condition_attention_`; a model
    without attention as it is), the reference init's rel printed."""
    import torch
    from repro_torch.core import mf
    from repro_torch.models import lm
    opts = lm.TrainOptions(loss="softmax", remat="none", attn_chunk=min(1024, serve_s))
    tokens = torch.randint(0, cfg.vocab, (SERVE_B, serve_s + 1),
                           generator=mf.generator(19, dev), device=dev)
    prompt, nxt = tokens[:, :serve_s], tokens[:, serve_s:]
    extra = {}
    patches, audio = cfg.family == "vlm", cfg.family == "audio"
    if patches:
        extra["patches"] = 0.1 * torch.randn(
            (SERVE_B, cfg.num_patches, cfg.d_model), generator=mf.generator(20, dev),
            device=dev)
    if audio:
        extra["frames"] = 0.1 * torch.randn(
            (SERVE_B, cfg.encoder_seq, cfg.d_model), generator=mf.generator(21, dev),
            device=dev)
    warm_extra = {k: v for k, v in extra.items() if k == "frames"}
    _, warm = lm.prefill(params, {"tokens": prompt[:, :16], **warm_extra}, cfg,
                         opts)                                           # warm-up
    lm.decode_step(params, lm.pad_cache(warm, cfg, 17), nxt, 16, cfg, opts)
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, {"tokens": prompt, **extra}, cfg, opts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    cache = lm.pad_cache(cache, cfg, serve_s + serve_steps + 1)   # +1: the profiled step
    members = kv_members(cache)
    mamba = () if cache.mamba is None else tuple(cache.mamba)
    cross = () if cache.cross_kv is None else tuple(cache.cross_kv)
    state_elems = sum(t.numel() for t in mamba)
    cross_bytes = sum(t.numel() * t.element_size() for t in cross)
    cache_gb = (sum(2 * m.k.numel() * m.k.element_size() for m in members)
                + sum(t.numel() * t.element_size() for t in mamba) + cross_bytes) / 1e9
    row_bytes = sum(2 * m.k[:, :, 0].numel() * m.k.element_size() for m in members)
    tok = logits.argmax(-1)[:, None]
    generated = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(serve_steps):
        step_logits, cache = lm.decode_step(params, cache, tok, serve_s + i, cfg, opts)
        tok = step_logits[:, 0].argmax(-1)[:, None]
        generated.append(tok)
    out = torch.cat(generated, dim=1).cpu()            # the one readback
    t_step = (time.perf_counter() - t0) / serve_steps
    launches = {c.name: c.count() for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for kv in members:
        assert kv.k.dtype == torch.bfloat16 and kv.k.shape[2] == serve_s + serve_steps + 1
    assert all(t.dtype == torch.float32 for t in mamba)       # as the reference keeps it
    assert all(t.dtype == torch.bfloat16 and t.shape == (
        cfg.n_layers, SERVE_B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        for t in cross)
    assert all(v == 0 for v in launches.values()), launches
    assert out.shape == (SERVE_B, serve_steps + 1)
    assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab
    assert bool(torch.isfinite(step_logits).all()) and bool(torch.isfinite(logits).all())
    pos = serve_s + serve_steps
    b_ms, b_by = decode_bound(params, cfg, pos, row_bytes, state_elems, cross_bytes)
    n_params = sum(x.numel() for x in _leaves(params))
    kinds = ", ".join(k for k, on in (("bf16 K/V", members), ("fp32 Mamba state", mamba),
                                      ("the bf16 encoder K/V of %d frames" % cfg.encoder_seq,
                                       cross)) if on)
    print(f"[{label} serve] {name} ({cfg.family}, {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}, {n_params} "
          f"parameters, fp32): prefill {SERVE_B} x {serve_s} tokens"
          f"{' (the first %d patch rows)' % cfg.num_patches if patches else ''}"
          f"{' after encoding %d frames' % cfg.encoder_seq if audio else ''} in "
          f"{1e3 * t_prefill:.1f} ms ({SERVE_B * serve_s / t_prefill:.0f} tokens/s); "
          f"{serve_steps} greedy decode steps at positions {serve_s}..{pos - 1} with a "
          f"cache of {kinds} ({cache_gb:.3f} GB): {1e3 * t_step:.3f} ms a step, "
          f"{SERVE_B / t_step:.1f} tokens/s; a step's bound {b_ms:.3f} ms ({b_by}: "
          f"every weight a step reads and every cached row read once; "
          f"{100 * b_ms / (1e3 * t_step):.1f}% "
          f"of it); peak device memory {peak_gb:.2f} GB; launches of the port's "
          f"kernels {launches} (serving runs none, as the reference runs no Pallas "
          f"kernel there); ids[0][:8] {out[0, :8].tolist()} | {card}", flush=True)
    print(f"[{label} profile] one decode step at position {pos}: "
          + profile_call(lambda: lm.decode_step(params, cache, tok, pos, cfg, opts), t_step)
          + f" | {card}", flush=True)
    del cache, step_logits

    # An MoE prefill drops the slots past an expert's capacity, last tokens
    # first, where a decode step of SERVE_B tokens cannot drop; the check
    # runs at the capacity factor E / k that makes the prefill dropless too,
    # as the reference's numeric checks do (its models/moe.py docstring).
    cfg_check = dataclasses.replace(cfg, capacity_factor=max(
        cfg.capacity_factor, cfg.moe_experts / max(cfg.moe_top_k, 1)))

    def decode_rel(dtype, n: int = 2) -> float:
        """rel of the decode logits at position serve_s (a cache of
        ``dtype`` from a prefill of the first serve_s tokens) against a
        prefill of serve_s + 1 tokens, on the first ``n`` prompts."""
        o = dataclasses.replace(opts, cache_dtype=dtype)
        ex = {k: v[:n] for k, v in extra.items()}
        want, _ = lm.prefill(params, {"tokens": tokens[:n], **ex}, cfg_check, o)
        _, c = lm.prefill(params, {"tokens": prompt[:n], **ex}, cfg_check, o)
        dl, _ = lm.decode_step(params, lm.pad_cache(c, cfg, serve_s + 1), nxt[:n],
                               serve_s, cfg_check, o)
        return (want - dl[:, 0]).abs().max().item() / (want.abs().max().item() + 1e-9)

    if cfg.family == "ssm":                # no attention: held as it is
        rel32, rel16 = decode_rel(torch.float32), decode_rel(torch.bfloat16)
        print(f"[{label} check] decode logits at position {serve_s} against prefill "
              f"of {serve_s + 1} tokens (2 prompts, fp32 weights, no attention, no "
              f"conditioning): rel {rel32:.3e} with an fp32 Mamba cache (< "
              f"{DECODE_REL:g} required); {rel16:.3e} with the serving options' "
              f"bf16 cache_dtype, which the Mamba cache does not take | {card}",
              flush=True)
        assert rel32 < DECODE_REL and rel16 < DECODE_REL, (rel32, rel16)
        return
    rel_init = decode_rel(torch.float32)
    condition_attention_(params, cfg)
    rel32, rel16 = decode_rel(torch.float32), decode_rel(torch.bfloat16)
    print(f"[{label} check] decode logits at position {serve_s} against prefill "
          f"of {serve_s + 1} tokens (2 prompts, fp32 weights, capacity factor "
          f"{cfg_check.capacity_factor:g}): rel {rel32:.3e} "
          f"with an fp32 cache (< {DECODE_REL:g} required) and {rel16:.3e} with "
          f"the bf16 cache, with the attention projections at 1/sqrt of their "
          f"contraction width; at the reference's init (attention logits of "
          f"order 100) rel {rel_init:.3e}, printed, not held: its near-hard-max "
          f"attention parts two fp32 orders of the same sums further at every "
          f"layer, and the reference's own check fails the same way at this "
          f"depth (ROADMAP.md C.6) | {card}", flush=True)
    assert rel32 < DECODE_REL, rel32


def lm_serving_phase(dev, card: str, flush, counters) -> None:
    """Phase 19: LM serving through ``prefill`` -> ``pad_cache`` ->
    ``decode_step`` at full width: (a) smollm-360m, then ``launch/serve.py``
    at its reduced defaults; (b) granite-8b; (c) moonshot-v1-16b-a3b at
    MOE_LAYERS layers, first trained through ``train_lm`` with the HEAT
    head on kernels #3 and #4, which are then checked and timed at this
    shape (printed; the kernels line keeps phase 11's entries)."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import trainer
    t_phase = time.perf_counter()

    # ---- 19a: smollm-360m, then the serve launcher -------------------------
    cfg = get_config("smollm-360m")
    params = lm.init_params(0, cfg, device=dev)
    lm_serve(dev, card, "19a", "smollm-360m", cfg, params, counters)
    del params
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main([])
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith("prefill: 4x16 tokens") \
        and lines[2].startswith("generated ids[0]: "), lines
    print(f"[19a cli] launch.serve (smollm-360m reduced, its defaults) on the card "
          f"in {time.perf_counter() - t0:.1f} s: {' / '.join(lines)} | {card}",
          flush=True)
    torch.cuda.empty_cache()

    # ---- 19b: granite-8b ----------------------------------------------------
    cfg = get_config("granite-8b")
    params = lm.init_params(0, cfg, device=dev)
    lm_serve(dev, card, "19b", "granite-8b", cfg, params, counters)
    del params
    torch.cuda.empty_cache()

    # ---- 19c: moonshot-v1-16b-a3b, 4 layers: train, then serve --------------
    base = get_config("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(base, n_layers=MOE_LAYERS, heat=dataclasses.replace(
        base.heat, backend="pallas"))
    opts = lm.TrainOptions(loss="heat", remat="full", attn_chunk=MOE_S)
    tcfg = trainer.TrainerConfig(steps=MOE_STEPS, lr=LM_LR, batch_size=MOE_B,
                                 seq_len=MOE_S, optimizer="adamw", log_every=0,
                                 steps_per_dispatch=MOE_STEPS, fixed_batch=True)
    init = trainer.init_lm_state(tcfg.seed, cfg, opts, get_optimizer("adamw"),
                                 device=dev)                   # train_lm's init
    tile0 = init.tile
    eval_before = lm_eval_loss(init.params, cfg, opts, tile0, dev, MOE_B, MOE_S)
    del init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = trainer.train_lm(cfg, opts, tcfg, device="cuda",
                                     log=lambda *_: None)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = {c.name: c.count() for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert len(losses) == MOE_STEPS and all(math.isfinite(x) for x in losses), losses
    want = {c.name: 0 for c in counters}
    want.update(ccl_stats_shared=MOE_STEPS, ccl_bwd_shared=MOE_STEPS,
                segment_sum=(LM_SEGMENT_SUMS + MOE_LAYERS) * MOE_STEPS)
    assert launches == want, launches
    eval_after = lm_eval_loss(state.params, cfg, opts, tile0, dev, MOE_B, MOE_S)
    assert eval_after < eval_before, f"MoE loss did not fall: {eval_before} -> {eval_after}"
    n_params = sum(x.numel() for x in _leaves(state.params))
    print(f"[19c moe train] moonshot-v1-16b-a3b cut to {MOE_LAYERS} of {base.n_layers} "
          f"layers (d={cfg.d_model}, {cfg.moe_experts} experts top-{cfg.moe_top_k}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {n_params} parameters) batch {MOE_B} x "
          f"{MOE_S}, AdamW lr {LM_LR}, remat full, HEAT head pallas (n="
          f"{cfg.heat.num_negatives}, tile {cfg.heat.tile_size}), one fixed batch: "
          f"{MOE_STEPS} steps, losses {[round(x, 4) for x in losses]}; fixed-batch "
          f"loss {eval_before:.6f} -> {eval_after:.6f}; launches {launches}; "
          f"{1e3 * t_train / MOE_STEPS:.1f} ms a step including init; peak device "
          f"memory {peak_gb:.2f} GB | {card}", flush=True)
    u, p, negs, _ = lm_head_inputs(state.params, cfg, opts, tile0, dev, MOE_B, MOE_S)
    entries = shared_ccl_entries(u, p, negs, flush)
    for kd in entries:
        kd["launches"] = launches[kd["name"]]
        lib = "none" if kd["library_ms"] is None else "%.4f ms" % kd["library_ms"]
        print(f"[19c kernel] {kd['name']} on the MoE model's head inputs (T="
              f"{u.shape[0]}, K={u.shape[1]}, n={negs.shape[0]}): same bits on two "
              f"calls; max abs err {kd['max_abs_err']:.3e} (tol {ATOL:g} + "
              f"{RTOL:g}*|plain|); {1e3 * kd['ms']:.1f} us kernel, "
              f"{1e3 * kd['plain_ms']:.1f} us plain, bound {1e3 * kd['bound_ms']:.1f} "
              f"us ({kd['bound_by']}; {bound_share(kd)}), library {lib}; "
              f"{kd['launches']} launches in the run | {card}", flush=True)
    params = state.params
    del state, u, p, negs
    torch.cuda.empty_cache()
    lm_serve(dev, card, "19c", "moonshot-v1-16b-a3b (trained)",
             cfg, params, counters)
    del params
    torch.cuda.empty_cache()
    print(f"[19 lm serve] phase 19 took {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)


#: phase 20: the SSM, hybrid and VLM families at full width and depth, as
#: (label, architecture, AdamW steps, batch, sequence) of the training run on
#: one fixed batch; each is then served as phase 19 serves.
FAMILY_RUNS = (("20a", "mamba2-370m", 16, 8, 1024),
               ("20b", "zamba2-2.7b", 4, 2, 512),
               ("20c", "qwen2-vl-2b", 8, 4, 512))


def lm_train_run(dev, card: str, flush, counters, label: str, arch: str, steps: int,
                 b: int, s: int, optimizer: str = "adamw", condition: bool = False):
    """One model of phases 20 and 21 at full width and depth: ``train_lm``
    with the HEAT head on ``pallas`` (``optimizer`` at lr 1e-3,
    ``remat="full"``, one fixed batch of b x s tokens with a VLM's patch
    rows or an audio model's frames from ``lm_batch(extras=)``: finite
    losses, the fixed-batch loss falling, kernels #3 and #4 launched once a
    step, #8 three times and nothing else, peak memory and its parts), then
    #3 and #4 against their plain versions on the trained head's inputs.  With
    ``condition`` the run starts from ``train_lm``'s init with the
    attention conditioned (:func:`condition_attention_`) and runs
    ``train_lm``'s window body on it (``trainer.lm_window_body`` under an
    ``EpochExecutor``), after a probe of one step at the unconditioned init
    (:func:`init_step_probe`).  Returns
    ``(cfg, trained params, the kernels line's entries)``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import trainer
    from repro_torch.train.checkpoint import named_leaves
    base = get_config(arch)
    cfg = dataclasses.replace(base, heat=dataclasses.replace(base.heat, backend="pallas"))
    extras, extra_rows = None, ""
    if cfg.family in ("vlm", "audio"):
        name, rows = (("frames", cfg.encoder_seq) if cfg.family == "audio"
                      else ("patches", cfg.num_patches))
        extras = {name: ((b, rows, cfg.d_model), torch.float32)}
        extra_rows = f", {rows} {'frames' if name == 'frames' else 'patch rows'} a sequence"
    opts = lm.TrainOptions(loss="heat", remat="full", attn_chunk=s)
    tcfg = trainer.TrainerConfig(steps=steps, lr=LM_LR, batch_size=b, seq_len=s,
                                 optimizer=optimizer, log_every=0,
                                 steps_per_dispatch=steps, fixed_batch=True)
    if condition:
        init_step_probe(dev, card, label, cfg, opts, tcfg, extras)
    init = trainer.init_lm_state(tcfg.seed, cfg, opts, get_optimizer(optimizer),
                                 device=dev)                  # train_lm's init
    if condition:
        condition_attention_(init.params, cfg)
    tile0 = init.tile
    eval_before = lm_eval_loss(init.params, cfg, opts, tile0, dev, b, s, extras)
    if not condition:
        del init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if condition:
        state, losses, _ = trainer.run_window(trainer.EpochExecutor(
            trainer.lm_window_body(cfg, opts, tcfg, get_optimizer(optimizer), extras,
                                   dev), steps), init, 0, steps)
        del init
    else:
        state, losses = trainer.train_lm(cfg, opts, tcfg, extras, device=dev,
                                         log=lambda *_: None)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = {c.name: c.count() for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert len(losses) == steps and all(math.isfinite(x) for x in losses), losses
    want = {c.name: 0 for c in counters}
    want.update(ccl_stats_shared=steps, ccl_bwd_shared=steps,
                segment_sum=LM_SEGMENT_SUMS * steps)
    assert launches == want, launches
    eval_after = lm_eval_loss(state.params, cfg, opts, tile0, dev, b, s, extras)
    assert eval_after < eval_before, \
        f"{arch}: loss did not fall: {eval_before} -> {eval_after}"
    n_params = sum(x.numel() for x in _leaves(state.params))
    param_gb = 4 * n_params / 1e9
    opt_gb = sum(x.numel() * x.element_size()
                 for _, x in named_leaves(state.opt_state)) / 1e9
    print(f"[{label} train] {arch}{' (attention conditioned)' if condition else ''} "
          f"({cfg.family}, {cfg.n_layers} layers"
          f"{' + %d encoder layers' % cfg.encoder_layers if cfg.encoder_layers else ''}, "
          f"d={cfg.d_model}, vocab {cfg.vocab}, {n_params} parameters{extra_rows}) "
          f"batch {b} x {s}, {optimizer} lr {LM_LR}, remat full, HEAT head pallas (n="
          f"{cfg.heat.num_negatives}, tile {cfg.heat.tile_size}), one fixed batch: "
          f"{steps} steps, losses {[round(x, 4) for x in losses]}; fixed-batch "
          f"loss {eval_before:.6f} -> {eval_after:.6f}; launches {launches}; "
          f"{1e3 * t_train / steps:.1f} ms a step including init; peak device "
          f"memory {peak_gb:.2f} GB: parameters {param_gb:.2f}, gradients "
          f"{param_gb:.2f}, {optimizer} state {opt_gb:.3f}, the rest "
          f"{peak_gb - 2 * param_gb - opt_gb:.2f} | {card}", flush=True)
    u, p, negs, _ = lm_head_inputs(state.params, cfg, opts, tile0, dev, b, s, extras)
    entries = []
    for kd in shared_ccl_entries(u, p, negs, flush):
        kd.update(launches=launches[kd["name"]], phase=label,
                  shape=f"T={u.shape[0]}, K={u.shape[1]}, n={negs.shape[0]}")
        print(f"[{label} kernel] {kd['name']} on {arch}'s head inputs "
              f"({kd['shape']}): same bits on two calls; max abs err "
              f"{kd['max_abs_err']:.3e} (tol {ATOL:g} + {RTOL:g}*|plain|); "
              f"{1e3 * kd['ms']:.1f} us kernel, {1e3 * kd['plain_ms']:.1f} us "
              f"plain, bound {1e3 * kd['bound_ms']:.1f} us ({kd['bound_by']}; "
              f"{bound_share(kd)}), library "
              + ("none" if kd["library_ms"] is None else
                 "%.1f us (torch.matmul(u, negs.T) for un alone)"
                 % (1e3 * kd["library_ms"]))
              + f"; {kd['launches']} launches in the run | {card}", flush=True)
        entries.append(kd)
    params = state.params
    del state, u, p, negs
    torch.cuda.empty_cache()
    return cfg, params, entries


def families_phase(dev, card: str, flush, counters) -> list:
    """Phase 20: mamba2-370m (``ssm``), zamba2-2.7b (``hybrid``) and
    qwen2-vl-2b (``vlm``, with the batch's 256 patch rows from
    ``lm_batch(extras=)``) at full width and depth, each through
    :func:`lm_train_run` (AdamW) and then the serving run of phase 19 on
    the trained weights.  Returns the kernels line's entries of #3 and #4
    at the three head shapes."""
    import torch
    t_phase = time.perf_counter()
    entries = []
    for label, arch, steps, b, s in FAMILY_RUNS:
        t_run = time.perf_counter()
        cfg, params, kds = lm_train_run(dev, card, flush, counters, label, arch,
                                        steps, b, s)
        entries += kds
        lm_serve(dev, card, label, f"{arch} (trained)", cfg, params, counters)
        del params
        torch.cuda.empty_cache()
        print(f"[{label} time] {arch}: {time.perf_counter() - t_run:.1f} s | {card}",
              flush=True)
    print(f"[20 families] phase 20 took {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)
    return entries


def init_step_probe(dev, card: str, label: str, cfg, opts, tcfg, extras) -> None:
    """One step of ``tcfg.optimizer`` from ``train_lm``'s own init (the
    reference's scales), printed and not held: the largest gradient of
    each leaf and the parameter leaves left non-finite.  At granite-8b's
    init the gradients reach 1e19-1e21, Adafactor's squares overflow fp32
    and its factored leaves turn NaN, in the reference's arithmetic as in
    the port's (ROADMAP.md C.8)."""
    import torch
    from repro_torch.models.params import tree_items
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import trainer
    opt, seen = get_optimizer(tcfg.optimizer), {}

    def update(grads, state, params, lr):
        seen.update((n, g.abs().max().item()) for n, g in tree_items(grads))
        return opt.update(grads, state, params, lr)
    probe = dataclasses.replace(opt, update=update)
    state = trainer.init_lm_state(tcfg.seed, cfg, opts, probe, device=dev)
    state, losses, _ = trainer.run_window(trainer.EpochExecutor(
        trainer.lm_window_body(cfg, opts, tcfg, probe, extras, dev), 1), state, 0, 1)
    bad = [n for n, p in tree_items(state.params) if not bool(torch.isfinite(p).all())]
    top = sorted(seen.items(), key=lambda kv: -kv[1])[:3]
    print(f"[{label} probe] one {tcfg.optimizer} step at {cfg.name}'s own init (the "
          f"reference's scales): loss {losses[0]:.4f}; largest gradients "
          + ", ".join(f"{n} {v:.3e}" for n, v in top)
          + f" (fp32 squares overflow above 1.8e19); parameter leaves non-finite "
          f"after the update: {len(bad)} of {len(seen)} {bad}; printed, not held "
          f"(ROADMAP.md C.8); the run below starts from the same init with the "
          f"attention conditioned | {card}", flush=True)
    del state
    torch.cuda.empty_cache()


#: phase 21a: whisper-medium at full width and depth, trained with AdamW for
#: WHISPER_STEPS steps on one fixed batch of SERVE_B x WHISPER_S tokens
#: (Whisper's decoder context) and its encoder_seq frames, then served with
#: prompts of WHISPER_PROMPT tokens and WHISPER_DECODE greedy steps (the
#: prompt and the steps fill the context).
WHISPER_STEPS, WHISPER_S, WHISPER_PROMPT, WHISPER_DECODE = 8, 448, 384, 64
#: phase 21b: granite-8b under Adafactor, GRANITE_STEPS steps on one fixed
#: batch of GRANITE_B x GRANITE_S tokens.
GRANITE_STEPS, GRANITE_B, GRANITE_S = 4, 2, 512


def audio_phase(dev, card: str, flush, counters) -> list:
    """Phase 21: (a) whisper-medium (``audio``: 24 encoder layers over 1,500
    frames, 24 decoder layers with cross-attention) through
    :func:`lm_train_run` (AdamW) and then served as phase 19 serves, with
    the encoder's K/V cached in bf16 and the cross-attention conditioned
    for the decode-after-prefill check; (b) granite-8b trained under
    Adafactor on the card, with its peak memory and its parts (the phase
    raises if it does not fit).  Returns the kernels line's entries of #3
    and #4 at both head shapes."""
    import torch
    t_phase = time.perf_counter()
    t_run = time.perf_counter()
    cfg, params, entries = lm_train_run(dev, card, flush, counters, "21a",
                                        "whisper-medium", WHISPER_STEPS, SERVE_B,
                                        WHISPER_S)
    lm_serve(dev, card, "21a", "whisper-medium (trained)", cfg, params, counters,
             serve_s=WHISPER_PROMPT, serve_steps=WHISPER_DECODE)
    del params
    torch.cuda.empty_cache()
    print(f"[21a time] whisper-medium: {time.perf_counter() - t_run:.1f} s | {card}",
          flush=True)
    t_run = time.perf_counter()
    _, params, kds = lm_train_run(dev, card, flush, counters, "21b", "granite-8b",
                                  GRANITE_STEPS, GRANITE_B, GRANITE_S,
                                  optimizer="adafactor", condition=True)
    entries += kds
    del params
    torch.cuda.empty_cache()
    print(f"[21b time] granite-8b under adafactor: {time.perf_counter() - t_run:.1f} s "
          f"| {card}", flush=True)
    print(f"[21 audio] phase 21 took {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)
    return entries


#: phase 22: LM training under a mesh, SHARD_LM_STEPS steps a run in windows
#: of SHARD_LM_WINDOW (remat full, the HEAT head on pallas): smollm-360m at
#: full width and depth on batch LM_B x LM_S (22a: one NCCL rank; 22c: four
#: gloo ranks at data=2 x model=2); moonshot-v1-16b-a3b cut to MOE_LAYERS
#: layers on MOE_B x MOE_S (22b: two gloo ranks at model=2); the CLI for
#: SHARD_LM_CLI_STEPS steps (22d).  AdamW (lr LM_LR) normalizes each
#: gradient element by its own size, so two fp32 orders of one gradient move
#: a near-zero element by up to 2 lr a step: the runs held to the unsharded
#: run within SHARD_ATOL take SGD at SHARD_LM_SGD_LR (a rate at which these
#: models' gradients move the state by about 1e-3 in 4 steps), and AdamW is
#: held bit for bit on one rank (22a) and run for SHARD_LM_ADAMW_STEPS steps
#: on four (22c), its distance to the unsharded AdamW run printed.  The SGD
#: runs start from train_lm's init with the attention conditioned (C.6: at
#: the reference's init smollm-360m's gradients reach 2e11): smollm-360m's
#: saved as a step-0 checkpoint that train_lm resumes, moonshot's
#: conditioned on each rank's slices and run through train_lm's window body
#: (as phase 21b runs granite-8b).  A state is compared on SHARD_LM_SAMPLES
#: fixed elements of every leaf; 22c's SGD run fails at SHARD_LM_FAIL with a
#: checkpoint every SHARD_LM_CKPT steps.
SHARD_LM_STEPS, SHARD_LM_WINDOW, SHARD_LM_CKPT, SHARD_LM_FAIL = 4, 2, 2, 3
SHARD_LM_ADAMW_STEPS, SHARD_LM_CLI_STEPS, SHARD_LM_SAMPLES = 2, 2, 4096
SHARD_LM_SGD_LR = 10.0


def leaf_samples(params, n: int = SHARD_LM_SAMPLES, seed: int = 22) -> dict:
    """``{path: (flat indices, values)}`` of ``n`` fixed random elements of
    every leaf of a whole parameter tree (host tensors)."""
    import torch
    from repro_torch.models.params import tree_items
    out = {}
    for path, x in tree_items(params):
        gen = torch.Generator().manual_seed(seed)
        idx = torch.randint(0, x.numel(), (min(n, x.numel()),), generator=gen)
        out[path] = (idx, x.reshape(-1)[idx.to(x.device)].cpu())
    return out


def samples_moved(a: dict, b: dict) -> float:
    """Largest difference between two :func:`leaf_samples` of one tree."""
    return max(float((a[p][1] - b[p][1]).abs().max()) for p in a)


def sampled_diff(params, samples: dict, plan=None) -> float:
    """Largest |param - sample| over the samples whose elements this rank
    holds (under ``plan``, a rank holds the slices its specs select)."""
    import numpy as np
    import torch
    from repro_torch.models.params import sharded_dims, tree_items
    specs = dict(tree_items(plan.specs)) if plan is not None else {}
    worst = 0.0
    for path, x in tree_items(params):
        idx, want = samples[path]
        dims = sharded_dims(specs[path], plan.mesh) if plan is not None else []
        whole = list(x.shape)
        for d, g in dims:
            whole[d] *= g.size
        coords = list(np.unravel_index(idx.numpy(), whole))
        mine = np.ones(idx.shape[0], dtype=bool)
        for d, g in dims:
            mine &= coords[d] // x.shape[d] == g.index
            coords[d] = coords[d] - g.index * x.shape[d]
        if not mine.any():
            continue
        flat = np.ravel_multi_index(tuple(c[mine] for c in coords), x.shape)
        got = x.reshape(-1)[torch.as_tensor(flat).to(x.device)].cpu()
        worst = max(worst, float((got - want[torch.as_tensor(mine)]).abs().max()))
    return worst


@contextlib.contextmanager
def step_clock():
    """Times a run's windows and the exchanges inside them: each
    ``EpochExecutor.run`` between two device synchronizations, and each
    ``sharding.all_gather_parts`` (every exchange goes through it) inside a
    window the same way, as phase 18b times them.  Yields a dict of the
    windows' seconds, the exchanges' seconds and the steps."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import trainer
    clock = {"window_s": 0.0, "exchange_s": 0.0, "steps": 0}
    run, gather = trainer.EpochExecutor.run, shd.all_gather_parts
    inside = [False]

    def timed_run(self, state, start, length):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inside[0] = True
        try:
            out = run(self, state, start, length)
            torch.cuda.synchronize()
        finally:
            inside[0] = False
        clock["window_s"] += time.perf_counter() - t0
        clock["steps"] += length
        return out

    def timed_gather(parts, group):
        if not inside[0]:
            return gather(parts, group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gather(parts, group)
        torch.cuda.synchronize()
        clock["exchange_s"] += time.perf_counter() - t0
        return out

    trainer.EpochExecutor.run, shd.all_gather_parts = timed_run, timed_gather
    try:
        yield clock
    finally:
        trainer.EpochExecutor.run, shd.all_gather_parts = run, gather


@contextlib.contextmanager
def first_step_counts():
    """Counts the first step a run's ``EpochExecutor`` takes: its FLOPs
    (``dryrun.FlopCounter``, which leaves the step's bits as they are), its
    exchanges' bytes by kind (``sharding.ExchangeCounter``) and the bytes of
    the parameters and the optimizer state it starts from
    (``dryrun.tree_bytes``), the numbers phase 23b holds the dry run to.
    Yields the dict it fills."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import FlopCounter, tree_bytes
    from repro_torch.train import trainer
    out: dict = {}
    run = trainer.EpochExecutor.run

    def counted_run(self, state, start, length):
        if out:
            return run(self, state, start, length)
        body = self.body

        def first(st, step):
            self.body = body
            out.update(params=tree_bytes(st.params),
                       opt_state=tree_bytes(st.opt_state), step=step)
            with shd.ExchangeCounter() as ex, FlopCounter() as flops:
                got = body(st, step)
            out.update(flops=flops.get_total_flops(),
                       collective_bytes=dict(ex.bytes))
            return got

        self.body = first
        try:
            return run(self, state, start, length)
        finally:
            self.body = body

    trainer.EpochExecutor.run = counted_run
    try:
        yield out
    finally:
        trainer.EpochExecutor.run = run


def conditioned_run(cfg, opts, tcfg, dev, plan=None):
    """``train_lm``'s init (this rank's slices under ``plan``) with the
    attention conditioned (:func:`condition_attention_`), trained by
    ``train_lm``'s window body for ``tcfg.steps`` steps in windows of
    ``tcfg.steps_per_dispatch``; returns ``(state, losses)``."""
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import trainer
    opt = get_optimizer(tcfg.optimizer)
    state = trainer.init_lm_state(tcfg.seed, cfg, opts, opt, device=dev, plan=plan)
    condition_attention_(state.params, cfg)
    executor = trainer.EpochExecutor(
        trainer.lm_window_body(cfg, opts, tcfg, opt, None, dev, plan),
        tcfg.steps_per_dispatch,
        reduce=None if plan is None else plan.reduce_losses)
    losses, step = [], 0
    while step < tcfg.steps:
        state, window, length = trainer.run_window(executor, state, step, tcfg.steps)
        losses += window
        step += length
    return state, losses


def lm_run(cfg, opts, tcfg, dev, mesh=None, samples=None, condition: bool = False,
           count: bool = False):
    """One ``train_lm`` run on this rank, sharded under ``mesh``
    (``condition``: through :func:`conditioned_run`): its losses, logs,
    launches of #3 and #4, ms a step and exchange ms a step over its windows
    (:func:`step_clock`), peak memory and sampled state difference, and with
    ``count`` its first step's :func:`first_step_counts`; returns ``(state,
    plan, the numbers)``."""
    import torch
    from repro_torch.kernels import ccl_similarity
    from repro_torch.models import lm_distributed as lmd
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import trainer
    counters = (ccl_similarity.SHARED_STATS_LAUNCHES,
                ccl_similarity.SHARED_BWD_LAUNCHES)
    for c in counters:
        c.reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logs = []
    plan = (None if mesh is None
            else lmd.LMShardingPlan(cfg, mesh, get_optimizer(tcfg.optimizer)))
    with step_clock() as clock, (first_step_counts() if count
                                 else contextlib.nullcontext({})) as counts:
        if condition:
            state, losses = conditioned_run(cfg, opts, tcfg, dev, plan)
        else:
            state, losses = trainer.train_lm(cfg, opts, dataclasses.replace(
                tcfg, mesh=mesh), device=dev, log=logs.append)
    out = {"losses": losses, "logs": logs, "counts": dict(counts),
           "launches": {c.name: c.count() for c in counters},
           "ms": 1e3 * clock["window_s"] / clock["steps"],
           "exch_ms": 1e3 * clock["exchange_s"] / clock["steps"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if samples is not None:
        out["diff"] = sampled_diff(state.params, samples, plan)
    return state, plan, out


def lm_shard_rank_moe(runs: dict, opts) -> dict:
    """One of phase 22b's two gloo ranks on card 0 (model=2): each of
    ``runs`` (label -> (config, trainer config, samples of the unsharded
    run or None)) as :func:`lm_run` from the conditioned init, and rank 0's
    local leaf shapes."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    dev = rank_device("cuda")
    mesh = make_host_mesh(1, 2)
    out = {"device": str(dev), "rank": dist.get_rank()}
    for label, (cfg, tcfg, samples) in runs.items():
        state, _, out[label] = lm_run(cfg, opts, tcfg, dev, mesh, samples,
                                      condition=True, count=label == "ek")
        p = state.params
        out["local"] = {k: tuple(v.shape) for k, v in (
            ("embed", p["embed"]), ("out_embed", p["out_embed"]),
            ("w_gate", p["blocks"]["moe"]["w_gate"]),
            ("wq", p["blocks"]["attn"]["wq"]), ("wo", p["blocks"]["attn"]["wo"]))}
        del state, p
        torch.cuda.empty_cache()
    return out


def lm_shard_rank_mesh22(cfg, opts, sgd, crash, adamw, samples) -> dict:
    """One of phase 22c's four gloo ranks on card 0 (data=2 x model=2):
    the SGD run from the conditioned step-0 checkpoint in ``sgd.ckpt_dir``,
    held to the unsharded one; the same run crashed at step SHARD_LM_FAIL
    and healed from its checkpoint (``crash``, whose step-SHARD_LM_CKPT
    checkpoint 22c's elastic restore continues), held to the first bit for
    bit on this rank's slices; and the AdamW run."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    from repro_torch.train import checkpoint as ckpt
    dev = rank_device("cuda")
    mesh = make_host_mesh(2, 2)
    out = {"device": str(dev), "rank": dist.get_rank(), "coords": dict(mesh.coords)}
    state, plan, out["sgd"] = lm_run(cfg, opts, sgd, dev, mesh, samples, count=True)
    out["rows"] = plan.batch_rows(sgd.batch_size)
    clean = {n: x.cpu().clone() for n, x in ckpt.named_leaves(state)
             if isinstance(x, torch.Tensor)}
    del state
    state, _, out["crash"] = lm_run(cfg, opts, crash, dev, mesh)
    out["crash"]["same_state"] = all(
        torch.equal(x.cpu(), clean[n]) for n, x in ckpt.named_leaves(state)
        if isinstance(x, torch.Tensor))
    del state, clean
    _, _, out["adamw"] = lm_run(cfg, opts, adamw, dev, mesh)
    return out


def lm_sharding_phase(dev, card: str, counters):
    """Phase 22: LM training under a mesh (``TrainerConfig.mesh``), through
    kernels #3 and #4 on every rank.  22a: smollm-360m (AdamW) on a
    one-rank NCCL mesh against the unsharded run, bit for bit; 22b: the
    cut moonshot-v1-16b-a3b (SGD) on two gloo ranks sharing card 0 at
    model=2 (experts, vocab tables and attention leaves split), at capacity
    E / k within 1e-5 of the unsharded run, and at 1.25; 22c: smollm-360m
    on four gloo ranks at data=2 x model=2, SGD within 1e-5 of the
    unsharded run, the same run crashed and healed bit for bit, its
    step-2 checkpoint continued by one process within 1e-5, and AdamW
    beside the unsharded AdamW run; 22d: the CLI with --mesh-data 2.  Each
    run prints ms a step and the exchanges' share over its windows, every
    rank's peak memory and its launches of #3 and #4 a step.  Returns the
    phase's seconds and, for phase 23b, the first step's counts of every
    rank of 22b's dropless run and 22c's SGD run with what the dry run
    needs to build the same cells."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_rank, make_data_mesh, run_ranks
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer
    t_phase = time.perf_counter()
    steps = SHARD_LM_STEPS
    counted: dict = {}

    def launches_ok(numbers, n):
        want = {"ccl_stats_shared": n, "ccl_bwd_shared": n}
        assert numbers["launches"] == want, numbers["launches"]
        assert all(math.isfinite(x) for x in numbers["losses"]), numbers["losses"]

    def run_line(numbers):
        n = len(numbers["losses"])
        return (f"#3/#4 {numbers['launches']['ccl_stats_shared'] / n:g}/"
                f"{numbers['launches']['ccl_bwd_shared'] / n:g} a step, "
                f"{numbers['ms']:.1f} ms a step, exchanges {numbers['exch_ms']:.1f} ms "
                f"({100 * numbers['exch_ms'] / numbers['ms']:.1f}%), peak "
                f"{numbers['peak_gb']:.2f} GB")

    def ranks_line(ranks, label):
        return "; ".join(f"rank {r['rank']} on {r['device']}: {run_line(r[label])}"
                         for r in ranks)

    base = get_config("smollm-360m")
    cfg = dataclasses.replace(base, heat=dataclasses.replace(base.heat, backend="pallas"))
    opts = lm.TrainOptions(loss="heat", remat="full", attn_chunk=LM_S)
    adamw = trainer.TrainerConfig(steps=steps, lr=LM_LR, batch_size=LM_B, seq_len=LM_S,
                                  optimizer="adamw", log_every=0,
                                  steps_per_dispatch=SHARD_LM_WINDOW)
    sgd = dataclasses.replace(adamw, optimizer="sgd", lr=SHARD_LM_SGD_LR)
    # ---- the unsharded smollm-360m AdamW run ------------------------------------
    ref, _, ref_run = lm_run(cfg, opts, adamw, dev)
    launches_ok(ref_run, steps)
    with tempfile.TemporaryDirectory() as work:
        # ---- 22a: one NCCL rank -----------------------------------------------------
        init_rank(0, 1, "nccl", os.path.join(work, "store"), "cuda")
        try:
            probe = torch.ones(1, device=dev)
            dist.all_reduce(probe)
            assert probe.item() == 1.0 and dist.get_backend() == "nccl"
            state, _, one = lm_run(cfg, opts, adamw, dev, make_data_mesh(1))
            launches_ok(one, steps)
            same = one["losses"] == ref_run["losses"] and all(
                torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                for (_, a), (_, b) in zip(ckpt.named_leaves(state),
                                          ckpt.named_leaves(ref), strict=True))
            assert same, "the one-rank mesh differs from the unsharded run"
            del state, ref
        finally:
            dist.destroy_process_group()
        print(f"[22a nccl] smollm-360m (32 layers, d=960, vocab 49152, HEAT head "
              f"pallas) batch {LM_B} x {LM_S}, AdamW lr {LM_LR}, remat full: train_lm("
              f"TrainerConfig(mesh=make_data_mesh(1))) over NCCL (an all-reduce probe "
              f"passed) for {steps} steps against the unsharded train_lm: losses and "
              f"every leaf of the state bit-identical: {same}; losses "
              f"{[round(x, 6) for x in ref_run['losses']]}; {run_line(one)} (unsharded: "
              f"{run_line(ref_run)}) | {card}", flush=True)
        torch.cuda.empty_cache()

        # ---- the unsharded smollm-360m SGD run, from a conditioned checkpoint ---------
        init = trainer.init_lm_state(sgd.seed, cfg, opts, get_optimizer("sgd"), device=dev)
        condition_attention_(init.params, cfg)
        s_start = leaf_samples(init.params)
        cond = os.path.join(work, "cond")
        ckpt.save(cond, 0, init)
        del init

        def from_cond(name: str) -> str:
            """A copy of the conditioned step-0 checkpoint."""
            shutil.copytree(cond, os.path.join(work, name))
            return os.path.join(work, name)

        sref, _, sref_run = lm_run(cfg, opts, dataclasses.replace(
            sgd, ckpt_dir=from_cond("sgd_ref"), ckpt_every=1000), dev)
        launches_ok(sref_run, steps)
        s_samples = leaf_samples(sref.params)
        s_moved = samples_moved(s_samples, s_start)
        del sref
        torch.cuda.empty_cache()

        # ---- 22b: moonshot-v1-16b-a3b, two gloo ranks at model=2 ---------------------
        mbase = get_config("moonshot-v1-16b-a3b")
        mcfg = dataclasses.replace(mbase, n_layers=MOE_LAYERS,
                                   heat=dataclasses.replace(mbase.heat, backend="pallas"))
        dropless = dataclasses.replace(mcfg, capacity_factor=mcfg.moe_experts
                                       / mcfg.moe_top_k)
        mopts = lm.TrainOptions(loss="heat", remat="full", attn_chunk=MOE_S)
        msgd = dataclasses.replace(sgd, batch_size=MOE_B, seq_len=MOE_S)
        init = trainer.init_lm_state(msgd.seed, dropless, mopts, get_optimizer("sgd"),
                                     device=dev)
        condition_attention_(init.params, dropless)
        m_start = leaf_samples(init.params)
        del init
        mref, _, mref_run = lm_run(dropless, mopts, msgd, dev, condition=True)
        launches_ok(mref_run, steps)
        m_samples = leaf_samples(mref.params)
        m_moved = samples_moved(m_samples, m_start)
        del mref, m_start
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_ranks(lm_shard_rank_moe, 2, args=(
            {"ek": (dropless, msgd, m_samples), "125": (mcfg, msgd, None)}, mopts),
            backend="gloo", device="cuda", timeout=600)
        t_ranks = time.perf_counter() - t0
        counted["22b"] = dict(cfg=dropless, opts=mopts, rows=(MOE_B, MOE_S),
                              mesh={"data": 1, "model": 2}, optimizer="sgd",
                              ranks=[r["ek"]["counts"] for r in ranks])
        r0 = ranks[0]
        loss_err = max(abs(a - b) for a, b in zip(r0["ek"]["losses"], mref_run["losses"]))
        state_err = max(r["ek"]["diff"] for r in ranks)
        for r in ranks:
            for label in ("ek", "125"):
                launches_ok(r[label], steps)
                assert r[label]["losses"] == r0[label]["losses"]
        assert loss_err <= SHARD_ATOL and state_err <= SHARD_ATOL, (loss_err, state_err)
        print(f"[22b gloo model=2] moonshot-v1-16b-a3b cut to {MOE_LAYERS} of "
              f"{mbase.n_layers} layers (d={mcfg.d_model}, {mcfg.moe_experts} experts "
              f"top-{mcfg.moe_top_k}, vocab {mcfg.vocab}) batch {MOE_B} x {MOE_S}, SGD lr "
              f"{SHARD_LM_SGD_LR:g} from train_lm's init with the attention conditioned, "
              f"through train_lm's window body, 2 ranks sharing card 0 (rank 0's slices "
              f"{r0['local']}); #3/#4 at T={MOE_B * (MOE_S - 1)}, K={mcfg.d_model}, n="
              f"{mcfg.heat.num_negatives} on each rank; capacity factor E/k = "
              f"{dropless.capacity_factor:.4f} (dropless): {steps} steps, losses max abs "
              f"diff {loss_err:.3e}, sampled state {state_err:.3e} against the unsharded "
              f"run (tol {SHARD_ATOL:g}; bit-identical: {loss_err == 0 and state_err == 0}; "
              f"the state moved by up to {m_moved:.3e}; "
              f"unsharded losses {[round(x, 6) for x in mref_run['losses']]}, "
              f"{run_line(mref_run)}); {ranks_line(ranks, 'ek')} | {card}", flush=True)
        print(f"[22b 1.25] the same at the config's capacity factor "
              f"{mcfg.capacity_factor}: losses {[round(x, 6) for x in r0['125']['losses']]}; "
              f"{ranks_line(ranks, '125')}; the two ranks' call took {t_ranks:.1f} s "
              f"| {card}", flush=True)
        del m_samples
        torch.cuda.empty_cache()

        # ---- 22c: smollm-360m, four gloo ranks at data=2 x model=2 ------------------
        crash = dataclasses.replace(sgd, ckpt_dir=from_cond("crash"),
                                    ckpt_every=SHARD_LM_CKPT, fail_at_step=SHARD_LM_FAIL)
        t0 = time.perf_counter()
        ranks = run_ranks(lm_shard_rank_mesh22, 4, args=(
            cfg, opts, dataclasses.replace(sgd, ckpt_dir=from_cond("sgd"),
                                           ckpt_every=1000),
            crash, dataclasses.replace(adamw, steps=SHARD_LM_ADAMW_STEPS), s_samples),
            backend="gloo", device="cuda", timeout=900)
        t_ranks = time.perf_counter() - t0
        counted["22c"] = dict(cfg=cfg, opts=opts, rows=(LM_B, LM_S),
                              mesh={"data": 2, "model": 2}, optimizer="sgd",
                              ranks=[r["sgd"]["counts"] for r in ranks])
        r0 = ranks[0]
        loss_err = max(abs(a - b) for a, b in zip(r0["sgd"]["losses"], sref_run["losses"]))
        state_err = max(r["sgd"]["diff"] for r in ranks)
        replayed = SHARD_LM_FAIL - SHARD_LM_FAIL // SHARD_LM_CKPT * SHARD_LM_CKPT
        for r in ranks:
            launches_ok(r["sgd"], steps)
            launches_ok(r["crash"], steps + replayed)
            launches_ok(r["adamw"], SHARD_LM_ADAMW_STEPS)
            for label in ("sgd", "adamw"):
                assert r[label]["losses"] == r0[label]["losses"]
            losses = r["crash"]["losses"]
            resumed = losses[:SHARD_LM_FAIL] + losses[SHARD_LM_FAIL + replayed:]
            assert resumed == r0["sgd"]["losses"] and r["crash"]["same_state"], r["rank"]
        assert loss_err <= SHARD_ATOL and state_err <= SHARD_ATOL, (loss_err, state_err)
        a_loss = max(abs(a - b) for a, b in zip(r0["adamw"]["losses"], ref_run["losses"]))
        print(f"[22c gloo data=2 x model=2] smollm-360m batch {LM_B} x {LM_S}, 4 ranks "
              f"sharing card 0 (coords {[r['coords'] for r in ranks]}, batch rows "
              f"{[r['rows'] for r in ranks]}), SGD lr {SHARD_LM_SGD_LR:g}: {steps} steps "
              f"from train_lm's init with the attention conditioned, resumed from a "
              f"step-0 checkpoint ({r0['sgd']['logs']}): losses max abs diff "
              f"{loss_err:.3e}, sampled state {state_err:.3e} against the unsharded run "
              f"(tol {SHARD_ATOL:g}; the state moved by up to {s_moved:.3e}; unsharded: "
              f"{run_line(sref_run)}); {ranks_line(ranks, 'sgd')} | {card}", flush=True)
        print(f"[22c crash] the same run with checkpoints every {SHARD_LM_CKPT} steps "
              f"and a failure at step {SHARD_LM_FAIL} on every rank "
              f"({r0['crash']['logs']}; {len(r0['crash']['losses'])} losses logged): "
              f"losses and every rank's slices equal the uninterrupted run bit for "
              f"bit: True; {ranks_line(ranks, 'crash')} | {card}", flush=True)
        print(f"[22c adamw] the same mesh with AdamW lr {LM_LR} from train_lm's init, "
              f"{SHARD_LM_ADAMW_STEPS} steps: losses "
              f"{[round(x, 6) for x in r0['adamw']['losses']]}, max abs diff {a_loss:.3e} "
              f"from 22a's unsharded AdamW run (AdamW's first step is lr times the sign "
              f"of each gradient element); {ranks_line(ranks, 'adamw')}; the four "
              f"ranks' call took {t_ranks:.1f} s | {card}", flush=True)

        # ---- 22c: the 4-rank SGD checkpoint, continued by one process ---------------
        elastic = os.path.join(work, "elastic")
        name = f"step_{SHARD_LM_CKPT:08d}"
        shutil.copytree(os.path.join(work, "crash", name), os.path.join(elastic, name))
        logs = []
        state, losses = trainer.train_lm(cfg, opts, dataclasses.replace(
            sgd, ckpt_dir=elastic, ckpt_every=1000), device=dev, log=logs.append)
        loss_err = max(abs(a - b) for a, b in zip(losses,
                                                   sref_run["losses"][SHARD_LM_CKPT:]))
        state_err = sampled_diff(state.params, s_samples)
        assert logs == [f"[trainer] resumed from step {SHARD_LM_CKPT}"], logs
        assert len(losses) == steps - SHARD_LM_CKPT
        assert loss_err <= SHARD_ATOL and state_err <= SHARD_ATOL, (loss_err, state_err)
        print(f"[22c elastic] 22c's step-{SHARD_LM_CKPT} checkpoint (saved by 4 ranks, "
              f"the unsharded layout) restored by one process and trained to step "
              f"{steps}: losses max abs diff {loss_err:.3e}, sampled state "
              f"{state_err:.3e} against the unsharded run | {card}", flush=True)
        del state, s_samples
        torch.cuda.empty_cache()

    # ---- 22d: the CLI ----------------------------------------------------------------
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m",
         "--steps", str(SHARD_LM_CLI_STEPS), "--steps-per-dispatch",
         str(SHARD_LM_CLI_STEPS), "--backend", "pallas", "--mesh", "host",
         "--mesh-data", "2", "--dist-backend", "gloo"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=src))
    assert cli.returncode == 0, cli.stderr[-3000:]
    lines = [l for l in cli.stdout.splitlines() if l.startswith(("[launch]", "done:"))]
    assert any("devices=2" in l for l in lines), cli.stdout
    assert any(l.startswith(f"done: {SHARD_LM_CLI_STEPS} steps") for l in lines), cli.stdout
    print(f"[22d cli] launch.train --arch smollm-360m --backend pallas --mesh host "
          f"--mesh-data 2 --dist-backend gloo (batch 8 x 64, {SHARD_LM_CLI_STEPS} steps) "
          f"in {time.perf_counter() - t0:.1f} s: {' / '.join(lines)} | {card}", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"[22 lm shard] phase 22 took {secs:.1f} s | {card}", flush=True)
    return secs, counted


#: phase 23a: the dry run's whole matrix takes about 8 minutes in one process
#: on a CPU host at full depth (every cell of SHAPES and MF_SHAPES on both production
#: meshes), so the smoke run takes the reference's L-override, DRY_LAYERS
#: layers a stack.  23c: sharded serving of smollm-360m on four gloo ranks
#: (data=2 x model=2) at SHARD_SERVE_B prompts of SHARD_SERVE_S tokens and
#: SHARD_SERVE_STEPS decode steps, held to the unsharded run within
#: SHARD_SERVE_ATOL.
DRY_LAYERS = 2
SHARD_SERVE_B, SHARD_SERVE_S, SHARD_SERVE_STEPS = 8, 128, 8
SHARD_SERVE_ATOL = 1e-5


def spec_leaves(tree) -> list:
    """The PartitionSpecs of a spec tree of NamedTuples and tuples."""
    from repro_torch.distributed.sharding import PartitionSpec
    if tree is None:
        return []
    if isinstance(tree, PartitionSpec):
        return [tree]
    return [x for v in tree for x in spec_leaves(v)]


def dry_rank_cell(world: int, rank: int, mesh_shape: dict, arch: str, rows: tuple,
                  overrides: dict, opts, optimizer: str) -> dict:
    """The dry run's record of one rank of a ``world``-rank fake process
    group on a ``mesh_shape`` mesh: ``arch`` with ``overrides`` trained on
    ``rows`` = (batch, seq) tokens with ``optimizer`` (a worker process's
    body; it touches no card)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.optimizers import get_optimizer
    with dryrun.fake_process_group(world, rank):
        return dryrun.lower_cell(arch, ShapeConfig("phase22", rows[1], rows[0], "train"),
                                 shd.Mesh(mesh_shape), opts=opts, overrides=overrides,
                                 optimizer=get_optimizer(optimizer))


def lm_serve_shard_rank(cfg, opts, tokens) -> dict:
    """One of phase 23c's four gloo ranks on card 0 (data=2 x model=2):
    this rank's slices of the unsharded init with the attention conditioned,
    a sharded prefill of the prompts, then SHARD_SERVE_STEPS sharded decode
    steps of the next tokens; the logits (host arrays, whole on every rank),
    the prefill of one more token for the decode-after-prefill check, the
    ms, the prefill's exchange bytes and a decode step's by group axes."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    from repro_torch.models import lm
    from repro_torch.models import lm_distributed as lmd
    dev = rank_device("cuda")
    mesh = make_host_mesh(2, 2)
    local = lm.init_params(0, cfg, device=dev, mesh=mesh)
    condition_attention_(local, cfg)
    view = lmd.LMShardingPlan(cfg, mesh).view(local)
    toks = torch.as_tensor(tokens, device=dev)
    s, n = SHARD_SERVE_S, SHARD_SERVE_STEPS
    out = {"rank": dist.get_rank(), "device": str(dev), "decode": []}
    with shd.use_mesh(mesh), shd.ExchangeCounter() as ex:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(view, {"tokens": toks[:, :s]}, cfg, opts, device=dev)
        torch.cuda.synchronize()
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        out["prefill"] = logits.cpu().numpy()
        out["placed"] = sum(any(a is not None for a in spec)
                            for spec in spec_leaves(lmd.cache_specs(cache)))
        cache = lmd.place_cache(lm.pad_cache(lmd.gather_cache(cache, mesh), cfg, s + n),
                                mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with shd.ExchangeCounter() as ex_dec:
            for p in range(s, s + n):
                step, cache = lm.decode_step(view, cache, toks[:, p:p + 1].contiguous(),
                                             p, cfg, opts, device=dev)
                out["decode"].append(step[:, 0].cpu().numpy())
        torch.cuda.synchronize()
        out["decode_ms"] = 1e3 * (time.perf_counter() - t0) / n
        out["exchange_bytes"] = dict(ex.bytes)
        out["decode_exchange_by_axes"] = {"x".join(axes): v // n
                                          for axes, v in ex_dec.by_axes.items()}
        want, _ = lm.prefill(view, {"tokens": toks[:, :s + 1]}, cfg, opts, device=dev)
        out["prefill_next"] = want.cpu().numpy()
    out["local_cache_gb"] = tree_bytes(cache) / 1e9
    return out


def dryrun_phase(dev, card: str, counted: dict) -> float:
    """Phase 23: the dry run against the card.  (a) ``python -m
    repro_torch.launch.dryrun`` over the whole matrix at DRY_LAYERS layers
    in a subprocess on the host's CPU: the records' counts, raising on any
    failure; (b) the dry run at phase 22's cells (22b: moonshot cut to 4
    layers, model=2; 22c: smollm-360m, data=2 x model=2), one record for
    every rank, each built in its own worker process: every rank's real
    parameter and optimizer-state bytes, its first step's exchange bytes by
    kind and its FLOPs equal the record's; (c) sharded serving of
    smollm-360m on four gloo ranks against the unsharded run.  Returns the
    phase's seconds."""
    import concurrent.futures
    import multiprocessing

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

    # ---- 23a: the whole matrix -----------------------------------------------------
    with tempfile.TemporaryDirectory() as work:
        out_json = os.path.join(work, "dryrun.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--layers",
             str(DRY_LAYERS), "--out", out_json],
            capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES=""))
        t_dry = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        with open(out_json) as f:
            records = json.load(f)
    by_status = {k: sum(r["status"] == k for r in records) for k in ("ok", "skip", "fail")}
    mf_ok = sum(r["status"] == "ok" and r["arch"] == "heat-mf-amazon" for r in records)
    bounded = sorted({b for r in records for b in r.get("bounded", [])})
    assert by_status == {"ok": 68, "skip": 8, "fail": 0}, by_status
    assert mf_ok == 4 and all(r["mode"] == "meta" for r in records)
    assert "0 failures" in proc.stdout
    print(f"[23a dryrun] python -m repro_torch.launch.dryrun --layers {DRY_LAYERS} (the "
          f"reference's L-override: the full-depth matrix takes about 8 minutes in one "
          f"process) on the host's CPU, fake process groups of 256 and 512 ranks: "
          f"{by_status['ok']} ok ({mf_ok} heat-mf-amazon), {by_status['skip']} skipped "
          f"(long_500k on full attention), {by_status['fail']} failed, every record "
          f"mode meta, upper-bounded sizes named {bounded}; {t_dry:.1f} s | {card}",
          flush=True)

    # ---- 23b: the dry run at phase 22's cells, rank by rank --------------------------
    jobs = []
    for label, run in counted.items():
        cfg = run["cfg"]           # every field, so the worker builds this config
        overrides = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        world = math.prod(run["mesh"].values())
        for rank in range(world):
            jobs.append((label, rank, (world, rank, run["mesh"], cfg.name, run["rows"],
                                       overrides, run["opts"], run["optimizer"])))
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(jobs),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [(label, rank, pool.submit(dry_rank_cell, *job))
                   for label, rank, job in jobs]
        recs = [(label, rank, f.result(timeout=600)) for label, rank, f in futures]
    t_cells = time.perf_counter() - t0
    for label, rank, rec in recs:
        real = counted[label]["ranks"][rank]
        parts = rec["memory"]["argument_parts"]
        checks = {"params bytes": (real["params"], parts["params"]),
                  "opt_state bytes": (real["opt_state"], parts["opt_state"]),
                  "exchange bytes": (real["collective_bytes"], rec["collective_bytes"]),
                  "flops": (real["flops"], rec["flops"])}
        same = {k: a == b for k, (a, b) in checks.items()}
        print(f"[23b {label} rank {rank}] {rec['arch']} ({rec['layers']} layers) "
              f"{counted[label]['rows'][0]} x {counted[label]['rows'][1]} tokens, mesh "
              f"{rec['mesh']}, SGD: real step {real['step']} on the card / dry run on meta: "
              f"params {real['params']} / {parts['params']} B, optimizer state "
              f"{real['opt_state']} / {parts['opt_state']} B, exchanges "
              f"{sum(real['collective_bytes'].values())} / "
              f"{sum(rec['collective_bytes'].values())} B "
              f"({ {k: v for k, v in rec['collective_bytes'].items() if v} }), FLOPs "
              f"{real['flops']} / {rec['flops']}; equal: {same}; kernels on meta "
              f"{rec['kernels']}, bounded {rec['bounded']} | {card}", flush=True)
        assert all(same.values()), (label, rank, checks)
    print(f"[23b cells] {len(recs)} rank records built and run on meta in "
          f"{len(recs)} worker processes in {t_cells:.1f} s | {card}", flush=True)

    # ---- 23c: sharded serving on the card --------------------------------------------
    cfg = get_config("smollm-360m")
    opts = lm.TrainOptions(loss="heat", remat="none", attn_chunk=SHARD_SERVE_S,
                           cache_dtype=torch.float32)
    s, n = SHARD_SERVE_S, SHARD_SERVE_STEPS
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    toks = torch.randint(0, cfg.vocab, (SHARD_SERVE_B, s + n), generator=gen, device=dev)
    params = lm.init_params(0, cfg, device=dev)
    condition_attention_(params, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, {"tokens": toks[:, :s]}, cfg, opts, device=dev)
    torch.cuda.synchronize()
    ref_prefill_ms = 1e3 * (time.perf_counter() - t0)
    ref = {"prefill": logits.cpu().numpy(), "decode": []}
    cache = lm.pad_cache(cache, cfg, s + n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(s, s + n):
        step, cache = lm.decode_step(params, cache, toks[:, p:p + 1], p, cfg, opts,
                                     device=dev)
        ref["decode"].append(step[:, 0].cpu().numpy())
    torch.cuda.synchronize()
    ref_decode_ms = 1e3 * (time.perf_counter() - t0) / n
    del params, cache, logits, step
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(lm_serve_shard_rank, 4, args=(cfg, opts, toks.cpu().numpy()),
                      backend="gloo", device="cuda", timeout=600)
    t_ranks = time.perf_counter() - t0
    pre_err = max(float(np.abs(r["prefill"] - ref["prefill"]).max()) for r in ranks)
    dec_err = max(float(np.abs(a - b).max()) for r in ranks
                  for a, b in zip(r["decode"], ref["decode"]))
    r0 = ranks[0]
    want = r0["prefill_next"]
    rel = float(np.abs(want - r0["decode"][0]).max()) / (float(np.abs(want).max()) + 1e-9)
    assert pre_err <= SHARD_SERVE_ATOL and dec_err <= SHARD_SERVE_ATOL, (pre_err, dec_err)
    assert rel < DECODE_REL, rel
    assert all(r["placed"] > 0 for r in ranks)
    # each data rank serves its own rows: a decode step's only exchange over
    # the data group is the whole batch's fp32 logits, never the cache
    logits_bytes = SHARD_SERVE_B * cfg.vocab * 4
    assert all(r["decode_exchange_by_axes"].get("data") == logits_bytes
               for r in ranks), [r["decode_exchange_by_axes"] for r in ranks]
    exch = {k: v for k, v in r0["exchange_bytes"].items() if v}
    print(f"[23c shard serve] smollm-360m (32 layers, d=960, vocab 49152, the "
          f"attention conditioned), {SHARD_SERVE_B} prompts of {s} tokens then {n} "
          f"decode steps, fp32 cache, 4 gloo ranks sharing card 0 at data=2 x model=2 "
          f"(the cache held as each rank's slices: {r0['placed']} leaves split, "
          f"{r0['local_cache_gb']:.4f} GB a rank): prefill logits max abs diff "
          f"{pre_err:.3e}, decode logits {dec_err:.3e} against the unsharded run (tol "
          f"{SHARD_SERVE_ATOL:g}); decode at position {s} against the sharded prefill of "
          f"{s + 1} tokens rel {rel:.3e} (< {DECODE_REL:g}); prefill "
          f"{r0['prefill_ms']:.1f} ms, decode {r0['decode_ms']:.1f} ms a step (unsharded "
          f"{ref_prefill_ms:.1f} / {ref_decode_ms:.1f} ms); rank 0's exchanges: prefill, "
          f"cache gather and place {exch} B, a decode step by group axes "
          f"{r0['decode_exchange_by_axes']} B (over data only the logits, {logits_bytes} "
          f"B: each data rank serves its own {SHARD_SERVE_B // 2} rows); "
          f"the four ranks' call took {t_ranks:.1f} s | {card}", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"[23 dryrun] phase 23 took {secs:.1f} s | {card}", flush=True)
    return secs


def sanitize_phase(dev, card: str, ds, counters) -> float:
    """Phase 24: the sanitizers on the card.  ``MF_100M_PALLAS`` warmed
    outside a region, then 3 windows of ``EpochExecutor`` inside
    ``sanitize(rank_promotion=None, trace_budgets={"epoch_executor.window":
    1})`` with kernels #1, #2 and #6 launching and each window's losses read
    at ``handle.edge()``; ``donation_report`` on a warm window; a warm
    ``BatchingRecommender.recommend_many`` of 20 users inside a region with
    one call shape; a planted ``.item()`` on a CUDA tensor, which must
    raise.  Returns the phase's seconds."""
    import numpy as np
    import torch

    from repro_torch.analysis import TransferError, donation_report, sanitize
    from repro_torch.configs.heat_mf import MF_100M_PALLAS
    from repro_torch.core import mf
    from repro_torch.data import pipeline
    from repro_torch.launch.server import BatchingRecommender
    from repro_torch.train import trainer
    t_phase = time.perf_counter()
    cfg = MF_100M_PALLAS
    dds = pipeline.device_cf_dataset(ds, dev)
    body = mf.make_scan_body(cfg, lambda s: pipeline.cf_batch_device(dds, 0, s, B), 0)
    executor = trainer.EpochExecutor(body, WINDOW, trace_budget=1)
    state = mf.init_mf(0, cfg, device=dev)
    state, _ = executor.run(state, 0, WINDOW)            # warm, outside
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    losses, window_ms = [], []
    with sanitize(rank_promotion=None,
                  trace_budgets={"epoch_executor.window": 1}) as handle:
        handle.adopt("epoch_executor.window", executor.trace_counter)
        for w in range(1, 4):
            t0 = time.perf_counter()
            state, window = executor.run(state, w * WINDOW, WINDOW)
            with handle.edge():
                losses += window.cpu().tolist()
            window_ms.append(1e3 * (time.perf_counter() - t0) / WINDOW)
    launches = {c.name: c.count() for c in counters if c.count()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, window = executor.run(state, 4 * WINDOW, WINDOW)
    losses_plain = window.cpu().tolist()
    plain_ms = 1e3 * (time.perf_counter() - t0) / WINDOW
    assert launches == {"ccl_stats": 3 * WINDOW, "ccl_bwd": 3 * WINDOW,
                        "gather_fma": 6 * WINDOW, "segment_sum": 6 * WINDOW}, launches
    assert executor.trace_counter.count == 1 and all(math.isfinite(x) for x in losses)
    assert all(math.isfinite(x) for x in losses_plain)
    rep = donation_report(executor.run, state, 5 * WINDOW, WINDOW, min_bytes=1 << 12)
    reused = {p for p, _, hit in rep.details if hit}
    assert {"[0].params.user_table", "[0].params.item_table"} <= reused, str(rep)
    print(f"[24a sanitize] MF_100M_PALLAS batch {B}: 3 windows of {WINDOW} steps inside "
          f"sanitize(rank_promotion=None, trace_budgets={{'epoch_executor.window': 1}}) "
          f"(the readback guard and torch.cuda's sync debug mode 'error'), each window's "
          f"losses read at handle.edge(): guard-clean, one window length, launches "
          f"{launches}, losses {losses[0]:.4f} -> {losses[-1]:.4f}; ms a step in each "
          f"guarded window {[round(x, 2) for x in window_ms]} (a process's first "
          f"dispatch-mode region pays one-time imports), {plain_ms:.2f} unguarded; a "
          f"warm window's carried "
          f"tensors: {rep.reused} reused in place, {rep.copied} copied "
          f"({rep.copied_bytes} B: "
          f"{[p for p, _, hit in rep.details if not hit]}) | {card}", flush=True)

    server_state = mf.MFState(mf.MFParams(state.params.user_table, state.params.item_table,
                                          None), None, None, 0)
    with BatchingRecommender(server_state, 10, max_batch=8, max_wait_ms=1.0) as server:
        assert server.trace_count == 1
        t0 = time.perf_counter()
        with sanitize(rank_promotion=None,
                      trace_budgets={"batching_recommender": 1}) as handle:
            handle.adopt("batching_recommender", server.trace_counter)
            out = server.recommend_many(np.arange(20))
        t_serve = time.perf_counter() - t0
        assert out.shape == (20, 10) and server.trace_count == 1
    planted = False
    try:
        with sanitize(rank_promotion=None):
            torch.ones(4, device=dev).sum().item()
    except TransferError as e:
        planted = "Disallowed" in str(e)
    assert planted, "a planted .item() on the card did not raise"
    print(f"[24b sanitize] BatchingRecommender over the trained {cfg.num_items} items, "
          f"max_batch 8: recommend_many of 20 users (3 calls, padded) inside a region in "
          f"{1e3 * t_serve:.1f} ms, guard-clean, one call shape; a planted .item() of a "
          f"CUDA tensor inside a region raised TransferError: {planted} | {card}",
          flush=True)
    del state, executor, dds
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(f"[24 sanitize] phase 24 took {secs:.1f} s | {card}", flush=True)
    return secs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs.heat_mf import AMAZON, MF_100M_PALLAS
    from repro_torch.core import mf
    from repro_torch.core.losses import ccl_loss_fused
    from repro_torch.data import pipeline
    from repro_torch.kernels import (
        _build,
        ccl_similarity,
        embedding_update,
        flash_attention,
        ops,
        segment_sum,
    )
    from repro_torch.optim import quantization as qz
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer

    t_start = time.perf_counter()
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
    assert all(torch.equal(a, b_) for a, b_ in zip(
        stats, ccl_similarity.ccl_stats(u, p, negs))), "ccl_stats: two calls differ"
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
    got = ccl_similarity.ccl_bwd(*bwd_args, mu=1.0, theta=0.0)
    err = max_err(got, ccl_similarity.ccl_bwd_plain(*bwd_args, mu=1.0, theta=0.0))
    assert all(torch.equal(a, b_) for a, b_ in zip(
        got, ccl_similarity.ccl_bwd(*bwd_args, mu=1.0, theta=0.0))), \
        "ccl_bwd: two calls differ"
    del got
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
        same = " same bits on two calls;" if kd["name"] in ("ccl_stats", "ccl_bwd") else ""
        print(f"[3 kernel] {kd['name']}:{same} max abs err {kd['max_abs_err']:.3e} "
              f"(tol {ATOL:g} + {RTOL:g}*|plain|); {kd['ms']:.4f} ms kernel, "
              f"{kd['plain_ms']:.4f} ms plain, bound {kd['bound_ms']:.4f} ms "
              f"({kd['bound_by']}; {bound_share(kd)}), library {lib} | {card}",
              flush=True)

    q8 = torch.randint(-127, 128, (ROWS, K), generator=gen, device=dev,
                       dtype=torch.int8)
    scale8 = torch.rand(ROWS, 1, generator=gen, device=dev) * 1e-2 + 1e-4
    for n_ids, gathers in zip(DEQUANT_IDS, ("user and positive", "history")):
        fresh = torch.randint(0, ROWS, (n_ids - n_ids // 4,), generator=gen,
                              device=dev)
        ids = torch.cat([fresh, fresh[:n_ids // 4]])      # duplicates
        kd = gather_dequant_entry(q8, scale8, ids, flush)
        print(f"[3 gather_dequant] {n_ids} ids ({n_ids // 4} repeated; the size "
              f"of the int8 step's {gathers} gathers, one launch each a step: "
              f"phase 8) from a synthetic {ROWS}-row int8 table: "
              f"{dequant_summary(kd)} | {card}", flush=True)
    del q8, scale8

    for shape, (sidx, order, values, n) in segment_sum_cases(dev, gen).items():
        kd = segment_sum_entry(shape, sidx, order, values, n, flush)
        print(f"[3 segment_sum] {shape}: {kd['positions']} positions into {n} segments, "
              f"longest run {kd['longest_run']}, {kd['pieces']} pieces past a run's first "
              f"(as the host counts them); bit for bit with the plain version on the CPU "
              f"and on two calls; {kd['ms']:.4f} ms kernel, {kd['plain_ms']:.4f} ms plain, "
              f"bound {kd['bound_ms']:.4f} ms ({kd['bound_by']}; {bound_share(kd)}), "
              f"library {kd['library_ms']:.4f} ms (values[order] and segment_reduce) "
              f"| {card}", flush=True)
        del kd["positions"], kd["longest_run"], kd["pieces"]
        kernels.append(kd)
        del sidx, order, values
    torch.cuda.empty_cache()

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

    eval_before = eval_loss(mf.init_mf(0, MF_100M_PALLAS, device=dev),  # train_mf's init
                            MF_100M_PALLAS, dds)
    counters = (ccl_similarity.STATS_LAUNCHES, ccl_similarity.BWD_LAUNCHES,
                embedding_update.GATHER_FMA_LAUNCHES,
                embedding_update.GATHER_DEQUANT_LAUNCHES,
                ccl_similarity.SHARED_STATS_LAUNCHES,
                ccl_similarity.SHARED_BWD_LAUNCHES,
                flash_attention.FLASH_LAUNCHES,
                segment_sum.SEGMENT_SUM_LAUNCHES)
    lm_idle = {"ccl_stats_shared": 0, "ccl_bwd_shared": 0, "flash_attention": 0}
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
    eval_after = eval_loss(state, MF_100M_PALLAS, dds)
    assert eval_after < eval_before, f"loss did not fall: {eval_before} -> {eval_after}"
    # One stats and one backward launch per step; one gather-FMA launch per
    # table per step (the user update, then the item groups' fused update);
    # two segment sums per step (the slot reduction, the tile write-through).
    assert launches == {"ccl_stats": STEPS, "ccl_bwd": STEPS,
                        "gather_fma": 2 * STEPS, "gather_dequant": 0,
                        "segment_sum": 2 * STEPS, **lm_idle}, launches
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
                                   base.params.item_table.clone(), None),
                       base.tile, None, base.step)
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

    # phase 14 evaluates these tables; they wait on the host meanwhile
    mf_trained = mf.MFParams(state.params.user_table.cpu(), state.params.item_table.cpu(),
                             None)
    del state, executor, body, base, runs, s0, s1

    # ---- 8: AMAZON with int8 tables ----------------------------------------
    cfg8 = dataclasses.replace(AMAZON, backend="pallas", update_impl="pallas",
                               table_format="int8")
    t0 = time.perf_counter()
    ds8 = pipeline.synth_cf_dataset(4096, cfg8.num_items)       # the CLI's shape
    t_data8 = time.perf_counter() - t0
    dds8 = pipeline.device_cf_dataset(ds8, dev)
    init = mf.init_mf(0, cfg8, device=dev)                      # train_mf's init
    eval_before = eval_loss(init, cfg8, dds8)
    del init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = trainer.train_mf(cfg8, ds8, INT8_STEPS, batch_size=B,
                                     steps_per_dispatch=WINDOW, device="cuda")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches8 = {c.name: c.count() for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert len(losses) == INT8_STEPS and all(math.isfinite(x) for x in losses), losses
    assert launches8 == {"ccl_stats": INT8_STEPS, "ccl_bwd": INT8_STEPS,
                         "gather_fma": 0, "gather_dequant": 3 * INT8_STEPS,
                         "segment_sum": 4 * INT8_STEPS, **lm_idle}, launches8
    for kd in kernels:
        if kd.get("shape") == "dedup":          # the int8 update's segment sums
            kd["launches"] = launches8["segment_sum"]
    payload = {str(t.q.dtype) for t in (state.params.user_table,
                                        state.params.item_table)}
    assert payload == {"torch.int8"}, payload
    eval_after = eval_loss(state, cfg8, dds8)
    assert eval_after < eval_before, f"int8 loss did not fall: {eval_before} -> {eval_after}"
    body = mf.make_scan_body(cfg8, lambda s: pipeline.cf_batch_device(
        dds8, 0, s, B, cfg8.history_len), 0)
    executor = trainer.EpochExecutor(body, WINDOW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, window = executor.run(state, INT8_STEPS, WINDOW)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    assert bool(torch.isfinite(window).all())
    hist_len = dds8.train_pos.shape[1]
    print(f"[8 int8 train] AMAZON int8 ({cfg8.num_users} x {cfg8.num_items} x "
          f"{cfg8.emb_dim}, n={cfg8.num_negatives}, history {cfg8.history_len} "
          f"-> {hist_len} columns of the dataset, tile {cfg8.tile_size}) batch "
          f"{B}: {INT8_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"fixed-set loss {eval_before:.6f} -> {eval_after:.6f}; launches "
          f"{launches8}; payload {payload.pop()}; {INT8_STEPS / t_train:.1f} "
          f"steps/s including init, {WINDOW / t_steady:.1f} steps/s over one "
          f"more {WINDOW}-step window; peak device memory {peak_gb:.2f} GB; "
          f"dataset {t_data8:.1f} s | {card}", flush=True)

    # The gather-dequant on the trained tables themselves, at the ids of the
    # run's first batch (user, positive, history: the step's three calls),
    # and on ids across each whole table, its last rows included, so the
    # kernel reads rows past 2^31 bytes into the 20.98M-row user table.
    tables = state.params
    batch = pipeline.cf_batch_device(dds8, 0, 0, B, cfg8.history_len)
    assert (tables.user_table.q.shape[0] - 1) * K >= 2 ** 31
    cases = [("user", tables.user_table, batch.user_ids),
             ("positive", tables.item_table, batch.pos_ids),
             ("history", tables.item_table, batch.hist_ids.reshape(-1))]
    for name, table in (("user", tables.user_table),
                        ("item", tables.item_table)):
        rows = table.q.shape[0]
        cases.append((f"{name}, whole range", table, torch.cat([
            torch.randint(0, rows, (B - 64,), generator=gen, device=dev),
            torch.arange(rows - 64, rows, device=dev)])))
    print(f"[8 gather_dequant] launches in the run: {launches8['gather_dequant']} "
          f"over {INT8_STEPS} steps, for the step's three gathers (user, positive, "
          f"history) together | {card}", flush=True)
    for name, table, ids in cases:
        kd = gather_dequant_entry(table.q, table.scale, ids, flush)
        print(f"[8 gather_dequant] {name}: {ids.numel()} ids into the trained "
              f"{table.q.shape[0]}-row int8 table: {dequant_summary(kd)} | "
              f"{card}", flush=True)
        if name == "history":       # the largest of the step's three calls
            del kd["n_unique"], kd["max_id"]
            kd["launches"] = launches8["gather_dequant"]
            kernels.append(kd)
    # phase 14 evaluates these tables for the first batch's users; they wait
    # on the host meanwhile
    amazon = mf.MFParams(*(qz.QuantizedTable(*(x.cpu() for x in t))
                           for t in (tables.user_table, tables.item_table)), None)
    amazon_users = batch.user_ids.cpu()
    del state, executor, body, dds8, tables, batch, cases, table, ids      # ds8: phase 15
    torch.cuda.empty_cache()

    # ---- 9: an int8 restart, bit for bit -----------------------------------
    cfg9 = dataclasses.replace(MF_100M_PALLAS, table_format="int8",
                               history_len=16, refresh_interval=8)
    t0 = time.perf_counter()
    clean, _ = trainer.train_mf(cfg9, ds, RESTART_STEPS, batch_size=B, seed=3,
                                steps_per_dispatch=WINDOW, device="cuda")
    logs = []
    with tempfile.TemporaryDirectory() as d:
        healed, _ = trainer.train_mf(cfg9, ds, RESTART_STEPS, batch_size=B,
                                     seed=3, steps_per_dispatch=WINDOW,
                                     device="cuda", ckpt_dir=d, ckpt_every=8,
                                     fail_at_step=13, log=logs.append)
        saved = ckpt.valid_steps(d)
    torch.cuda.synchronize()
    t_restart = time.perf_counter() - t0
    assert logs == ["[mf] injected failure at step 13 -> restoring"], logs
    names = []
    for (name, a), (name_b, b) in zip(ckpt.named_leaves(clean),
                                      ckpt.named_leaves(healed), strict=True):
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        assert name == name_b and same, f"restart differs at {name}"
        names.append(name)
    print(f"[9 restart] MF_100M_PALLAS int8, history 16, refresh every 8: "
          f"{RESTART_STEPS} steps clean and with a failure at step 13 healed "
          f"from the step-8 checkpoint (checkpoints {saved}): all {len(names)} "
          f"leaves identical bit for bit ({', '.join(names)}); {t_restart:.1f} s "
          f"| {card}", flush=True)

    del clean, healed, dds
    torch.cuda.empty_cache()
    kernels += lm_phases(dev, card, flush, counters)
    eval_phase(dev, card, ds, mf_trained, amazon, amazon_users, counters)
    torch.cuda.empty_cache()
    engines_phase(dev, card, ds, ds8, counters)
    torch.cuda.empty_cache()
    tile_server = serving_phase(dev, card, ds, mf_trained, amazon, amazon_users, counters)
    torch.cuda.empty_cache()
    streaming_phase(dev, card, mf_trained, tile_server, counters)
    torch.cuda.empty_cache()
    t_shard = sharding_phase(dev, card, ds, counters)
    torch.cuda.empty_cache()
    lm_serving_phase(dev, card, flush, counters)
    torch.cuda.empty_cache()
    kernels += families_phase(dev, card, flush, counters)
    torch.cuda.empty_cache()
    kernels += audio_phase(dev, card, flush, counters)
    torch.cuda.empty_cache()
    t_lm_shard, counted = lm_sharding_phase(dev, card, counters)
    torch.cuda.empty_cache()
    t_dry = dryrun_phase(dev, card, counted)
    torch.cuda.empty_cache()
    t_san = sanitize_phase(dev, card, ds, counters)

    print(f"[total] all 24 phases in {time.perf_counter() - t_start:.1f} s (phase 18: "
          f"{t_shard:.1f} s, phase 22: {t_lm_shard:.1f} s, phase 23: {t_dry:.1f} s, "
          f"phase 24: {t_san:.1f} s) | {card}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    # The run uses one card (card 0), whatever else the machine exposes.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
