#!/usr/bin/env python3
"""Where a benchmark cell's step goes, span by span, on one CUDA card.

    python3 tools/span_table.py --workload <cell> --seed <n> [--seconds <s>]

Runs the cell once as ``heatbench/run.py --trace 1`` does (the timed
window, then the traced stretch of 4 windows), joins the port's spans
(``src/repro_torch/train/spans.py``) with the stretch's device trace
(``heatbench/spans.py``) and prints, a step, for each span name: the device
microseconds of the operations it enqueued itself, their number, its host
microseconds outside its child spans and its own CUDA calls, and the idle
device microseconds whose gaps' middles it holds.  Then the device busy
microseconds a step inside windows (the spans' device time sums to it), the
anchors' spread, the calls whose device records the tracer lost, and the
run's metrics.  Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from heatbench import harness, profiling, spec
    from heatbench import spans as hs

    if not torch.cuda.is_available():
        print("[span_table] needs a CUDA device", file=sys.stderr)
        return 3
    traces = []
    profile = profiling.profile

    def kept(run, device_type):
        traces.append(profile(run, device_type))
        return traces[-1]

    harness.tr.profile = kept
    result = harness.run_cell(spec.load_cell(args.workload), args.seed,
                              args.seconds, True, log=lambda s: None)
    joined = hs.join(traces[0])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[span_table] {args.workload} seed {args.seed} | {card}")
    if joined is None:
        print("[span_table] the spans could not be joined with the trace")
        return 1
    print(f"{'span':16s} {'device us':>12s} {'launches':>9s} "
          f"{'host self us':>13s} {'idle us':>9s}")
    rows = hs.by_span(joined)
    for name, r in rows.items():
        print(f"{name:16s} {r['device_us']:12.1f} {r['launches']:9.2f} "
              f"{r['host_self_us']:13.1f} {r['idle_us']:9.1f}")
    inside = [op for op, i in zip(joined.ops, joined.owner) if i >= 0]
    busy = profiling.Trace(0.0, inside, []).busy_s()
    spread = max(joined.offsets) - min(joined.offsets)
    print(f"[span_table] device busy in windows {1e6 * busy / joined.steps:.1f}"
          f" us a step; spans' device time "
          f"{sum(r['device_us'] for r in rows.values()):.1f}; anchors' spread "
          f"{1e6 * spread:.3f} us; calls with no device record {joined.lost}; "
          f"operations outside windows {len(joined.ops) - len(inside)}")
    print(json.dumps({"correct": result["correct"],
                      "metrics": result["metrics"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
