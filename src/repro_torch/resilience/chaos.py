"""Deterministic chaos harness (the port of ``src/repro/resilience/chaos.py``):
a seeded fault schedule over every fault class the self-healing service
handles, driven against a LIVE service (StreamingTrainer +
BatchingRecommender) on the card unless the caller names another device,
asserting the recovery invariants end to end and timing detection ->
recovered for each fault.

Fault classes (one injection per class per run, rounds drawn from the seed):

* ``corrupt_ckpt``  — bit-flip a byte inside the newest committed
  checkpoint, then force a restore: the integrity pass must quarantine the
  corrupt dir, fall back to the newest *valid* step, and the service must
  retrain back to where it was.
* ``nan_state``     — poison the trained tables after a window
  (``StreamingConfig.poison_at_round``): the divergence guard must trip at
  the round edge BEFORE the state reaches serving or disk, roll back to the
  last good checkpoint, and salt past the poison window.
* ``stream_fault``  — a scheduled transient source failure
  (:class:`~repro_torch.resilience.streams.FlakyStream`): the
  :class:`~repro_torch.resilience.streams.RetryingStream` wrapper must absorb it
  with seeded backoff; the service never sees the error.
* ``refresh_fail``  — hand the recommender a malformed state mid-run: it
  must keep serving the previous snapshot (health ``degraded``) and recover
  to ``ok`` on the next good round.

Invariants asserted after EVERY round: the live server answers with k
finite recommendations, and the steady-state shape budgets hold (ONE window
length + ONE padded serving call shape across the whole chaotic run —
rollbacks and salted windows must not add a shape; the port has no jit, so
it counts shapes where the reference counts traces).

CLI:  PYTHONPATH=src python -m repro_torch.resilience.chaos --rounds 10 --seed 0
      (``--device cpu`` runs the plain path on the CPU)
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import numpy as np

FAULT_KINDS = ("corrupt_ckpt", "nan_state", "stream_fault", "refresh_fail")


def make_schedule(seed: int, rounds: int,
                  kinds: tuple = FAULT_KINDS) -> dict[int, str]:
    """{1-based round -> fault kind}: one fault per kind, each in its own
    round of ``[2, rounds-1]`` (never round 1 — every fault class needs at
    least one committed checkpoint / good refresh behind it — and never the
    last round, so recovery is observable).  Pure in ``(seed, rounds)`` via
    the repo's stable ``default_rng((seed, ...))`` derivation."""
    if rounds < len(kinds) + 3:
        raise ValueError(f"need rounds >= {len(kinds) + 3} to place "
                         f"{len(kinds)} faults with recovery headroom")
    rng = np.random.default_rng((int(seed), 0xC7A05))
    slots = sorted(rng.choice(np.arange(2, rounds), size=len(kinds),
                              replace=False).tolist())
    order = rng.permutation(len(kinds))
    return {int(slots[i]): kinds[int(order[i])] for i in range(len(kinds))}


def _bitflip_newest_checkpoint(ckpt_dir: str) -> int:
    """Flip one byte in the largest leaf file of the newest checkpoint;
    returns the corrupted step."""
    from repro_torch.train import checkpoint as ckpt
    step = ckpt.latest_step(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves = [os.path.join(path, f) for f in os.listdir(path)
              if f.endswith(".npy")]
    target = max(leaves, key=os.path.getsize)
    with open(target, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))
    return int(step)


def run_chaos(seed: int = 0, rounds: int = 10, *, num_users: int = 64,
              num_items: int = 96, emb_dim: int = 8, capacity: int = 4,
              micro_batch: int = 64, steps_per_round: int = 8,
              batch_size: int = 32, topk: int = 10,
              ckpt_dir: Optional[str] = None, device=None,
              log: Callable[[str], None] = lambda *_: None) -> dict:
    """One seeded chaos run on ``device`` (the card unless the caller names
    another; raises where there is none); returns the report dict (see
    module doc).

    ``report["problems"]`` is empty iff every fault was detected, recovered,
    and the service kept serving throughout.
    """
    import torch

    from repro_torch.core import mf
    from repro_torch.launch.server import BatchingRecommender
    from repro_torch.resilience.streams import FlakyStream, RetryingStream
    from repro_torch.stream.service import StreamingConfig, StreamingTrainer
    from repro_torch.stream.sources import SyntheticStream

    dev = mf.resolve_device(device)
    schedule = make_schedule(seed, rounds)
    by_kind = {kind: rnd for rnd, kind in schedule.items()}
    tmp = None
    if ckpt_dir is None:
        tmp = tempfile.mkdtemp(prefix="heat_chaos_")
        ckpt_dir = tmp
    problems: list[str] = []
    faults: list[dict] = []

    def fault(kind: str, rnd: int, detected: bool, recovered: bool,
              recovery_s: float, detail: str) -> None:
        faults.append({"kind": kind, "round": rnd, "detected": detected,
                       "recovered": recovered,
                       "recovery_s": float(recovery_s), "detail": detail})
        if not detected:
            problems.append(f"{kind} (round {rnd}): fault went undetected")
        if not recovered:
            problems.append(f"{kind} (round {rnd}): service did not "
                            f"recover ({detail})")

    try:
        total = rounds * micro_batch
        base = SyntheticStream(num_users, num_items, seed=seed, total=total,
                               user_drift=0.01, item_drift=0.01)
        rs = by_kind["stream_fault"]
        flaky = FlakyStream(base, {(rs - 1) * micro_batch + 3: 2})
        retry = RetryingStream(flaky, max_attempts=4, base_delay=0.005,
                               max_delay=0.05, seed=seed)
        cfg = mf.MFConfig(num_users=num_users, num_items=num_items,
                          emb_dim=emb_dim, num_negatives=8, lr=0.4,
                          backend="fused", sampler="auto")
        scfg = StreamingConfig(capacity=capacity, micro_batch=micro_batch,
                               steps_per_round=steps_per_round,
                               batch_size=batch_size, recency=0.5, seed=seed,
                               ckpt_dir=ckpt_dir, ckpt_every=1,
                               poison_at_round=by_kind["nan_state"])
        trainer = StreamingTrainer(cfg, retry, scfg, device=dev, log=log)
        server = BatchingRecommender(trainer.state, topk, max_wait_ms=0.2,
                                     log=log)
        trainer.recommender = server

        degraded_at: Optional[float] = None
        for r in range(1, rounds + 1):
            kind = schedule.get(r)
            t0 = time.perf_counter()
            if trainer.run(rounds=1) < 1:
                problems.append(f"stream ran dry at round {r} "
                                f"(schedule expected {rounds} rounds)")
                break
            dt = time.perf_counter() - t0

            if degraded_at is not None:
                # first completed round after the refresh fault: its good
                # refresh_from must have recovered the health status
                fault("refresh_fail", by_kind["refresh_fail"],
                      detected=server.health["refresh_failures"] >= 1,
                      recovered=server.health["status"] == "ok"
                      or server.health["stale_refreshes"] == 0,
                      recovery_s=time.perf_counter() - degraded_at,
                      detail=f"health={server.health['status']} after the "
                             "next good round")
                degraded_at = None

            if kind == "nan_state":
                fault(kind, r, detected=trainer.rollbacks == 1,
                      recovered=trainer.rounds == r and trainer.salt == 1,
                      recovery_s=dt,
                      detail=f"rollbacks={trainer.rollbacks} "
                             f"salt={trainer.salt}")
            elif kind == "stream_fault":
                fault(kind, r, detected=flaky.raised == 2,
                      recovered=retry.retries == 2 and retry.gave_up == 0
                      and trainer.rounds == r,
                      recovery_s=sum(retry.delays),
                      detail=f"raised={flaky.raised} "
                             f"retries={retry.retries}")
            elif kind == "corrupt_ckpt":
                corrupted = _bitflip_newest_checkpoint(ckpt_dir)
                t1 = time.perf_counter()
                restored = trainer.restore()    # must skip the corrupt step
                catchup = trainer.run(rounds=r - trainer.rounds)
                rec_s = time.perf_counter() - t1
                quarantined = any(
                    d.startswith(f"step_{corrupted:08d}.corrupt")
                    for d in os.listdir(ckpt_dir))
                fault(kind, r, detected=quarantined,
                      recovered=restored < corrupted
                      and trainer.rounds == r,
                      recovery_s=rec_s,
                      detail=f"corrupted step {corrupted}, restored "
                             f"{restored}, replayed {catchup} round(s)")
            elif kind == "refresh_fail":
                bad_cfg = mf.MFConfig(num_users=num_users,
                                      num_items=num_items,
                                      emb_dim=emb_dim + 1)
                bad = mf.init_mf(1, bad_cfg, device=dev)
                ok = server.refresh_from(bad)
                degraded_at = time.perf_counter()
                if ok or server.health["status"] != "degraded":
                    problems.append(f"refresh_fail (round {r}): malformed "
                                    "refresh was not rejected")
                got = server.recommend(1)
                if got.shape != (topk,) or not np.all(np.isfinite(got)):
                    problems.append(f"refresh_fail (round {r}): degraded "
                                    "server stopped serving")

            # liveness invariant: the service answers after EVERY round
            got = server.recommend(r % num_users)
            if got.shape != (topk,) or not np.all(np.isfinite(got)):
                problems.append(f"round {r}: server failed the liveness "
                                "check (shape/finiteness)")

        # steady-state budgets survive the whole chaotic run: rollbacks and
        # salted windows keep the ONE window length and call shape
        wt = int(trainer.executor.trace_counter.count)
        st = int(server.trace_count)
        if wt != 1:
            problems.append(f"window shape budget blown: {wt} window lengths "
                            "(rollback/salt must not add one)")
        if st != 1:
            problems.append(f"serving shape budget blown: {st} call shapes")
        if server.health["status"] != "ok":
            problems.append(f"final health is {server.health['status']!r}, "
                            "expected 'ok'")
        finite = bool(torch.isfinite(trainer.state.params.item_table).all())
        if not finite:
            problems.append("final item table is not finite — the poison "
                            "window leaked through the rollback")
        missing = [k for k in FAULT_KINDS
                   if k not in {f["kind"] for f in faults}]
        if missing:
            problems.append(f"fault classes never exercised: {missing}")
        report = {
            "seed": int(seed), "rounds": int(rounds),
            "schedule": {str(r): k for r, k in sorted(schedule.items())},
            "faults": faults, "problems": problems,
            "final": {"rounds": trainer.rounds, "steps": trainer.step,
                      "events": trainer.events,
                      "rollbacks": trainer.rollbacks,
                      "restarts": trainer.restarts, "salt": trainer.salt,
                      "stream_retries": retry.retries,
                      "window_traces": wt, "serve_traces": st,
                      "health": server.health},
        }
        server.stop()
        return report
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    """CLI entry: run the chaos schedule and exit non-zero on problems."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the full report as JSON")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs on the card; cpu runs the "
                         "plain path")
    args = ap.parse_args(argv)
    from repro_torch.core.mf import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    report = run_chaos(args.seed, args.rounds, device=device, log=print)
    for f in report["faults"]:
        status = "recovered" if f["recovered"] else "NOT RECOVERED"
        print(f"[chaos] {f['kind']:<13} round {f['round']:>2}: "
              f"{status} in {1e3 * f['recovery_s']:.1f} ms ({f['detail']})")
    for p in report["problems"]:
        print(f"[chaos] PROBLEM: {p}")
    fin = report["final"]
    print(f"[chaos] {fin['rounds']} rounds, {fin['events']} events, "
          f"rollbacks={fin['rollbacks']}, retries={fin['stream_retries']}, "
          f"window_traces={fin['window_traces']}, "
          f"serve_traces={fin['serve_traces']}, "
          f"health={fin['health']['status']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[chaos] wrote {args.json}")
    return 1 if report["problems"] else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
