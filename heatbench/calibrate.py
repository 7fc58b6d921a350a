"""Readings behind a cell's correctness limits, at the cell's own size.

    python3 heatbench/calibrate.py --workload <name> --program 1,2,... \
        --control 21,22,23 --fault half:31,32,33 --fault pos_twice:41,42,43 \
        [--out FILE]

For each ``--program`` seed: the program's first steps, as a benchmark run
makes them in set-up, against the reference (the lower readings).  For each
``--control`` seed: the reference at the precision below the
configuration's (the kind's ``CONTROL``; ``mf``: TF32 operands) in place of
the program, against the reference.  For each ``--fault NAME:SEEDS`` seed:
the reference with that fault planted in the program's place, against the
reference; the cell's kind lists the faults it can plant (``FAULTS``;
``mf``: ``half``, ``pos_twice``, ``no_flush``, see
:mod:`heatbench.reference.mf`) and any other is refused.  A state left
unchanged reads 1 on ``change_gap`` by construction and needs no run.  One
JSON line per reading goes to standard output and to ``--out``; the
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
for _p in (HERE.parent / "src", HERE.parent):
    sys.path.insert(0, str(_p))

import torch  # noqa: E402

from heatbench import harness, spec  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def program_reading(cell, seed: int, dev) -> dict:
    """The program's readings for one seed."""
    run = harness.Run(cell, seed, dev, harness.Clock(time.perf_counter()))
    run.free_program()
    values, detail = run.readings()
    return {"values": values, "detail": detail}


def reference_reading(cell, seed: int, dev, **kw) -> dict:
    """The reference under ``kw`` (a lower precision or a fault) in the
    program's place, against the reference, for one seed (the cell's
    kind's ``reference_reading``)."""
    return spec.kind_module(cell.kind).reference_reading(cell, seed, dev,
                                                         **kw)


def jobs(cell, program: str, control: str, faults) -> list:
    """``(what, seed, keywords)`` of each reading asked for; a fault that
    the cell's kind does not list is refused."""
    kind = spec.kind_module(cell.kind)
    out = ([("program", s, {}) for s in _seeds(program)]
           + [("control", s, dict(kind.CONTROL)) for s in _seeds(control)])
    for text in faults:
        name, seeds = text.split(":")
        if name not in kind.FAULTS:
            raise ValueError(f"kind {cell.kind!r} plants no fault {name!r}; "
                             f"it has {kind.FAULTS}")
        out += [(name, s, {"fault": name}) for s in _seeds(seeds)]
    return out


def main(argv=None) -> int:
    """Take the readings; returns the exit code."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program", default="")
    p.add_argument("--control", default="")
    p.add_argument("--fault", action="append", default=[],
                   help="NAME:SEEDS, repeated")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    todo = jobs(cell, args.program, args.control, args.fault)
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    try:
        for what, seed, kw in todo:
            t = time.perf_counter()
            if what == "program":
                r = program_reading(cell, seed, dev)
            else:
                r = reference_reading(cell, seed, dev, **kw)
            line = json.dumps({"workload": args.workload, "kind": what,
                               "seed": seed, **r,
                               "seconds": time.perf_counter() - t,
                               "card": torch.cuda.get_device_name(dev),
                               "power_limit_w": harness.power_limit_w()})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
