"""Training launcher CLI of the port (the MF half of
``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --mf --steps 64 --batch 1024 \\
        --backend pallas --update-impl pallas            # MF_100M on the card
    PYTHONPATH=src python -m repro_torch.launch.train --mf --reduced --steps 20 \\
        --device cpu                                      # plain path, CPU
    PYTHONPATH=src python -m repro_torch.launch.train --mf --reduced --steps 40 \\
        --table-format int8 --ckpt-dir DIR --ckpt-every 10 \\
        --fail-at-step 25 --device cpu       # int8, crash and resume

Runs on the card unless ``--device cpu`` is given; with no CUDA device it
exits with an error instead of falling back.  The LM trainer and meshes wait
for later slices.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    """CLI entry: train the paper's CF model (``--mf``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mf", action="store_true", help="train the paper's CF model")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps-per-dispatch", type=int, default=16,
                    help="steps per window; losses are read back once per "
                         "window")
    ap.add_argument("--backend", default=None,
                    help="loss backend (engine.LOSS_IMPLS): fused, autodiff, "
                         "pallas (the CUDA kernels)")
    ap.add_argument("--update-impl", default=None,
                    help="row-update impl: scatter_add, pallas (the CUDA "
                         "kernel)")
    ap.add_argument("--sampler", default=None,
                    choices=["auto", "uniform", "tile"],
                    help="negative-sampling strategy (default: auto)")
    ap.add_argument("--table-format", default=None, choices=["fp32", "int8"],
                    help="embedding-table storage: fp32 (default) or int8 + "
                         "per-row scales with stochastic-rounded updates "
                         "(optim/quantization.py)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs the kernels on the card; cpu "
                         "runs their plain versions")
    args = ap.parse_args(argv)
    if not args.mf:
        ap.error("the port trains the MF model only (--mf); the LM trainer "
                 "comes with the LM slice (ROADMAP.md, queue A, item 7)")

    from repro_torch.configs.heat_mf import MF_100M
    from repro_torch.core.engine import resolve_engine
    from repro_torch.core.mf import resolve_device
    from repro_torch.data import pipeline
    from repro_torch.train import trainer

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    cfg = MF_100M if not args.reduced else dataclasses.replace(
        MF_100M, num_users=2000, num_items=4000, emb_dim=64)
    overrides = {k: v for k, v in (
        ("backend", args.backend), ("update_impl", args.update_impl),
        ("sampler", args.sampler), ("table_format", args.table_format))
        if v}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    engine = resolve_engine(cfg)
    print(f"[launch] MF engine: {engine.name} "
          f"(steps_per_dispatch={args.steps_per_dispatch}, device={device})")
    ds = pipeline.synth_cf_dataset(min(cfg.num_users, 4096), cfg.num_items)
    _, losses = trainer.train_mf(cfg, ds, steps=args.steps,
                                 batch_size=args.batch, engine=engine,
                                 steps_per_dispatch=args.steps_per_dispatch,
                                 ckpt_dir=args.ckpt_dir,
                                 ckpt_every=args.ckpt_every,
                                 fail_at_step=args.fail_at_step, device=device)
    print(f"done: {len(losses)} steps, final loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
