"""Streaming service launcher of the port (``src/repro/launch/stream.py``):
live ingestion → train-on-recent → serve, with a freshness probe measured
end to end.  Runs on the card unless ``--device cpu`` is given.

    # cold-start a streaming service on a drifting synthetic stream, splice
    # a probe event mid-run and report the freshness SLO:
    PYTHONPATH=src python -m repro_torch.launch.stream --rounds 12

    # record the stream to a JSONL log, then replay it bit-exactly:
    PYTHONPATH=src python -m repro_torch.launch.stream --record events.jsonl
    PYTHONPATH=src python -m repro_torch.launch.stream --replay events.jsonl

    # crash mid-stream and resume from the round-edge checkpoint:
    PYTHONPATH=src python -m repro_torch.launch.stream \\
        --ckpt-dir heat_stream --fail-at-event 1500

Freshness SLO (the number this CLI prints): wall-clock seconds from the
probe event being *ingested* to the probe item appearing in the probe
user's served top-k (served through a live ``BatchingRecommender`` that is
``refresh_from``-ed every round with no new call shape).  The round and
summary lines are the reference's; "traces" there count the distinct window
lengths and padded serving call shapes (the port has no jit).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    """CLI entry for the streaming ingest -> train -> serve loop."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--users", type=int, default=1000)
    ap.add_argument("--items", type=int, default=2000)
    ap.add_argument("--emb-dim", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=32,
                    help="per-user positive ring rows")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--micro-batch", type=int, default=512,
                    help="events ingested per round")
    ap.add_argument("--steps-per-round", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--recency", type=float, default=0.5,
                    help="ring age decay (0 = uniform over the ring)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="fused")
    ap.add_argument("--sampler", default="auto",
                    help="'popularity' feeds the sampler the LIVE ring "
                         "counts (slower: weighted catalog draw per step)")
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--user-drift", type=float, default=0.01)
    ap.add_argument("--item-drift", type=float, default=0.01)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="rounds between checkpoints")
    ap.add_argument("--fail-at-event", type=int, default=None,
                    help="inject a crash at this event offset (demo)")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="record the synthetic stream to a JSONL log, then "
                         "stream from the log")
    ap.add_argument("--replay", default=None, metavar="PATH",
                    help="stream from an existing JSONL event log")
    ap.add_argument("--probe-at", type=int, default=None,
                    help="event offset of the spliced freshness probe "
                         "(default: 1/3 into the run)")
    ap.add_argument("--probe-repeat", type=int, default=32,
                    help="probe burst size (fills the probe user's ring)")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs on the card; cpu runs the "
                         "plain path")
    args = ap.parse_args(argv)

    from repro_torch.core import mf
    from repro_torch.launch.server import BatchingRecommender
    from repro_torch.stream import sources
    from repro_torch.stream.service import StreamingConfig, StreamingTrainer

    try:
        device = mf.resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    total = args.rounds * args.micro_batch
    if args.replay:
        stream = sources.ReplayLogStream(args.replay)
        print(f"[stream] replaying {stream.total} events from {args.replay}")
    else:
        stream = sources.SyntheticStream(
            args.users, args.items, seed=args.seed, total=total,
            user_drift=args.user_drift, item_drift=args.item_drift)
        if args.record:
            n = sources.record_stream(stream, total, args.record)
            print(f"[stream] recorded {n} events -> {args.record}")
            stream = sources.ReplayLogStream(args.record)

    # Probe: a (user, item) pair spliced into the stream — the item comes
    # from OUTSIDE the user's preference cluster, so only the probe events
    # (not the background stream) can teach the model to rank it.
    probe_user, probe_item, probe_at = 1, args.items - 1, None
    if not args.no_probe:
        probe_at = args.probe_at if args.probe_at is not None else total // 3
        stream = sources.ProbeInjector(stream, probe_at, probe_user,
                                       probe_item, repeat=args.probe_repeat)
        print(f"[stream] probe: user {probe_user} x item {probe_item} "
              f"spliced at event {probe_at} (x{args.probe_repeat})")

    cfg = mf.MFConfig(num_users=args.users, num_items=args.items,
                      emb_dim=args.emb_dim, num_negatives=16, lr=args.lr,
                      backend=args.backend, sampler=args.sampler)
    scfg = StreamingConfig(
        capacity=args.capacity, micro_batch=args.micro_batch,
        steps_per_round=args.steps_per_round, batch_size=args.batch_size,
        recency=args.recency, seed=args.seed, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, fail_at_event=args.fail_at_event)

    trainer = StreamingTrainer(cfg, stream, scfg, device=device, log=print)
    server = BatchingRecommender(trainer.state, args.topk,
                                 max_batch=args.max_batch, max_wait_ms=0.5)
    trainer.recommender = server

    t_probe = freshness_s = fresh_round = None
    t_start = time.perf_counter()
    while True:
        ev0 = trainer.events
        if trainer.run(rounds=1) < 1:
            break
        s = trainer.last_round_stats
        line = (f"[stream] round {s['round']:>3}: {s['events']} events | "
                f"ingest {1e3 * s['ingest_s']:.1f} ms | "
                f"train {1e3 * s['train_s']:.1f} ms "
                f"({args.steps_per_round / s['train_s']:.0f} steps/s) | "
                f"refresh {1e3 * s['refresh_s']:.1f} ms | "
                f"loss {s['loss']:.4f}")
        if probe_at is not None and t_probe is None \
                and ev0 <= probe_at < trainer.events:
            t_probe = time.perf_counter()
            line += "  <- probe ingested"
        if t_probe is not None and freshness_s is None:
            topk = server.recommend(probe_user)
            if probe_item in topk.tolist():
                freshness_s = time.perf_counter() - t_probe
                fresh_round = s["round"]
                line += f"  <- probe item in top-{args.topk}"
        print(line)

    wall = time.perf_counter() - t_start
    print(f"[stream] {trainer.rounds} rounds, {trainer.events} events, "
          f"{trainer.step} steps in {wall:.1f} s "
          f"({trainer.events / wall:,.0f} events/s end-to-end); "
          f"window traces={trainer.executor.trace_counter.count}, "
          f"serve traces={server.trace_count}, restarts={trainer.restarts}")
    if probe_at is not None:
        if freshness_s is not None:
            print(f"[stream] freshness SLO: probe served in "
                  f"{freshness_s:.2f} s (round {fresh_round})")
        else:
            print("[stream] freshness SLO: probe NOT served within the run "
                  "— raise --rounds / --probe-repeat / --recency")
    server.stop()


if __name__ == "__main__":
    main()
