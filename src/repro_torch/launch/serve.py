"""Serving launcher of the port (``src/repro/launch/serve.py``): batched LM
decoding (``prefill`` -> ``decode_step``*) or, with ``--mf``, MF top-k
recommendation serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --device cpu                              # LM, reduced, plain path
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --prompt-len 16 --decode-steps 8 --batch 4      # LM on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --mf --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --mf --pruner tile \\
        --expand-tiles 4 --max-batch 32 --max-wait-ms 2      # on the card

Without ``--mf`` it serves the LM named by ``--arch`` (a dense or MoE
architecture) at its reduced size, as the reference does (its ``--reduced``
cannot be switched off): random parameters from key 0, a random prompt of
``--batch`` x ``--prompt-len`` tokens from key 1, one ``prefill``, the cache
padded to the prompt plus ``--decode-steps`` positions, then greedy
``decode_step``s whose tokens stay on the device until one readback at the
end.  It prints the reference's three lines: prefill ms, decode ms per
token and the generated ids of the first sequence.

With ``--mf`` it trains briefly, then serves concurrent single-user requests through a
:class:`~repro_torch.launch.server.BatchingRecommender` with each pruner asked
for (``--pruner both``, the default, runs the exact and the tile pruner in
turn), and ends as the reference does: the streaming service, warm-started
on the trained state and a ring over the offline dataset, runs two live
ingest → train → ``refresh_from`` rounds against the last server, with no
new call shape.  The LM's prefill/decode serving waits for ROADMAP.md A.6:
without ``--mf`` the launcher raises.  Runs on the card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import threading
import time


def serve_mf(args, device) -> None:
    """Train, serve concurrent requests with each pruner, then refresh the
    last server through two streaming rounds."""
    import numpy as np
    import torch

    from repro_torch.core import mf, retrieval
    from repro_torch.core.engine import resolve_engine
    from repro_torch.data import pipeline
    from repro_torch.launch.server import BatchingRecommender
    from repro_torch.stream.service import StreamingConfig, StreamingTrainer
    from repro_torch.stream.sources import SyntheticStream
    from repro_torch.train import trainer

    users, items = 1000, 2000
    ds = pipeline.synth_cf_dataset(users, items, interactions_per_user=16,
                                   num_clusters=16, seed=0)
    cfg = mf.MFConfig(num_users=users, num_items=items, emb_dim=64,
                      num_negatives=32, lr=0.1, tile_size=256,
                      refresh_interval=128,
                      backend=args.backend or "fused",
                      sampler=args.sampler or "auto")
    engine = resolve_engine(cfg)
    print(f"[serve] MF engine: {engine.name} (device={device})")
    state, _ = trainer.train_mf(cfg, ds, steps=args.train_steps,
                                batch_size=128, seed=0, engine=engine,
                                steps_per_dispatch=16, device=device,
                                log=lambda *_: None)
    train_mask = torch.as_tensor(ds.train_mask(), device=device)
    rng = np.random.default_rng(0)

    pruners = ("exact", "tile") if args.pruner == "both" else (args.pruner,)
    for pruner in pruners:
        index = None
        if pruner == "tile":
            index = retrieval.build_retrieval_index(state.params.item_table,
                                                    tile_rows=args.tile_rows)
            print(f"[serve] pruner=tile: {index.num_tiles} tiles x "
                  f"{index.tile_rows} rows, expanding {args.expand_tiles}")
        t0 = time.perf_counter()
        server = BatchingRecommender(
            state, args.topk, pruner=pruner, index=index,
            expand_tiles=args.expand_tiles, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, item_chunk=args.item_chunk,
            exclude_mask=train_mask, log=print)
        print(f"[serve] {pruner}: warmup in "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms; call shapes "
              f"{server.trace_count}")
        lat_ms, lock = [], threading.Lock()

        def client(uid: int):
            t = time.perf_counter()
            server.recommend(uid)
            with lock:
                lat_ms.append(1e3 * (time.perf_counter() - t))

        n_requests = 256
        threads = [threading.Thread(target=client,
                                    args=(int(rng.integers(0, users)),))
                   for _ in range(n_requests)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        lat = np.sort(lat_ms)
        stats = server.stats
        print(f"[serve] {pruner}: {n_requests} concurrent requests in "
              f"{wall * 1e3:.1f} ms: qps={n_requests / wall:,.0f} "
              f"p50={lat[len(lat) // 2]:.2f} ms "
              f"p99={lat[int(len(lat) * 0.99)]:.2f} ms "
              f"({stats['device_calls']} device calls, call shapes "
              f"{stats['traces']})")
        uid = int(rng.integers(0, users))
        recs = server.recommend(uid)
        print(f"[serve] {pruner}: top-{args.topk} for user {uid}: {recs[:5]}")
        if pruner != pruners[-1]:
            server.stop()

    # Online refresh: warm-start the streaming service on the trained state
    # and a ring over the offline dataset (both are trained and filled in
    # place; the server serves its own snapshot), and run two live ingest ->
    # train -> refresh_from rounds against the last server.
    live = SyntheticStream(users, items, seed=1, total=512,
                           user_drift=0.01, item_drift=0.01)
    streamer = StreamingTrainer(
        cfg, live,
        StreamingConfig(capacity=16, micro_batch=256, steps_per_round=25,
                        batch_size=128, seed=0),
        state=state,
        data=pipeline.stream_ring_dataset(users, items, 16, base=ds,
                                          device=device),
        engine=engine, recommender=server, device=device,
        log=lambda *_: None)
    del state                           # trained in place by the service
    streamer.run(rounds=2)
    recs2 = server.recommend(uid)
    print(f"[serve] {pruners[-1]}: after {streamer.rounds} streaming rounds "
          f"({streamer.events} live events, {streamer.step} total steps, "
          f"health {server.health['status']}, call shapes "
          f"{server.trace_count}): {recs2[:5]}")
    server.stop()


def serve_lm(args, device) -> None:
    """Prefill a random prompt and decode greedily; print the prefill time,
    the decode time per token and the first sequence's ids."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import mf
    from repro_torch.models import lm

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opts = lm.TrainOptions(loss="softmax", remat="none",
                           attn_chunk=min(1024, args.prompt_len))
    params = lm.init_params(0, cfg, device=device)
    max_len = args.prompt_len + args.decode_steps
    batch = {"tokens": torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                                     generator=mf.generator(1, device),
                                     device=device)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, batch, cfg, opts, device=device)
    cache = lm.pad_cache(cache, cfg, max_len)
    sync()
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in "
          f"{1e3 * t_prefill:.1f} ms")

    tok = torch.argmax(logits, -1)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(args.decode_steps):
        logits_t, cache = lm.decode_step(params, cache, tok,
                                         args.prompt_len + i, cfg, opts,
                                         device=device)
        tok = torch.argmax(logits_t[:, 0], -1)[:, None]
        generated.append(tok)
    out = torch.cat(generated, dim=1).cpu()      # the one readback
    dt = (time.perf_counter() - t0) / max(args.decode_steps, 1)
    print(f"decode: {1e3 * dt:.1f} ms/token/batch "
          f"({1e6 * dt / args.batch:.0f} us/token/sequence)")
    print(f"generated ids[0]: {out[0].tolist()}")


def main(argv=None):
    """CLI entry: LM decoding, or MF top-k serving with ``--mf``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the reduced config (always on, as in the "
                         "reference; chip_smoke.py drives full widths "
                         "through the library)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--mf", action="store_true",
                    help="serve MF top-k recommendations instead of LM decode")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--item-chunk", type=int, default=512,
                    help="catalog chunk of the exact pruner's running top-k")
    ap.add_argument("--pruner", choices=("exact", "tile", "both"),
                    default="both",
                    help="exact: chunked full-catalog top-k; tile: "
                         "tile-pruned candidates (retrieval.topk_pruned); "
                         "both: one after the other")
    ap.add_argument("--expand-tiles", type=int, default=4,
                    help="tiles whose members the tile pruner scores")
    ap.add_argument("--tile-rows", type=int, default=128,
                    help="index tile size (rows per tile)")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="requests coalesced into one device call at most")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="longest wait for a fuller batch")
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--sampler", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) serves on the card; cpu runs the "
                         "plain path")
    args = ap.parse_args(argv)
    from repro_torch.core.mf import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    if args.mf:
        serve_mf(args, device)
        return
    from repro_torch.configs import get_config
    try:
        get_config(args.arch)
    except ValueError as e:
        ap.error(str(e))
    serve_lm(args, device)


if __name__ == "__main__":
    main()
