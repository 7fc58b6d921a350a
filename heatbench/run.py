"""Run one benchmark cell once on the card and print its result.

    python3 heatbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit); the last lines of standard error give the
same numbers and limits.  The run exits non-zero and prints no result when
there is no CUDA device or fewer than the cell asks for, when the port is
missing, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package
(``repro``) has been loaded once the window has closed.  Build and kernel
caches stay under ``build/`` in the checkout, at fixed paths.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton",
          "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "cuda_jit"}


def _setup_paths() -> None:
    # The script's own folder would shadow modules by its files' names.
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "heatbench_cache" / sub)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    """The command line."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run the cell; returns the exit code."""
    args = parse(argv)
    _setup_paths()
    t = time.perf_counter()
    import torch

    from heatbench import harness, spec

    parts = [("python", t - T0), ("import_torch", time.perf_counter() - t)]
    cell = spec.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    t = time.perf_counter()
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    parts.append(("find_devices", time.perf_counter() - t))
    if found < chips:
        print(f"[heatbench] needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t0=T0, parts=parts,
                              log=lambda s: print(s, file=sys.stderr))
    loaded = forbidden_modules()
    if loaded:
        print(f"[heatbench] forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 4
    for c in result["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = None
    print(f"[heatbench] correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[heatbench] check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
