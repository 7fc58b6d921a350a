"""Training launcher CLI of the port (``src/repro/launch/train.py``
without the mesh).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --seq 1024 --steps 32 --backend pallas --remat full   # LM on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 5 --device cpu                      # LM, plain path

    PYTHONPATH=src python -m repro_torch.launch.train --mf --steps 64 --batch 1024 \\
        --backend pallas --update-impl pallas            # MF_100M on the card
    PYTHONPATH=src python -m repro_torch.launch.train --mf --reduced --steps 20 \\
        --device cpu                                      # plain path, CPU
    PYTHONPATH=src python -m repro_torch.launch.train --mf --reduced --steps 5 \\
        --backend simplex_bmm --update-impl dense --sampler uniform \\
        --device cpu                        # the SimpleX baseline (Table 1)
    PYTHONPATH=src python -m repro_torch.launch.train --mf --reduced --steps 40 \\
        --table-format int8 --ckpt-dir DIR --ckpt-every 10 \\
        --fail-at-step 25 --device cpu       # int8, crash and resume

Without ``--mf`` it trains the LM named by ``--arch`` (the dense family;
default smollm-360m) with the HEAT vocab head (``--loss heat``, whose engine
``--backend``/``--sampler`` select) or the full-softmax head.  Runs on the
card unless ``--device cpu`` is given; with no CUDA device it exits with an
error instead of falling back.  Meshes wait for a later slice.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    """CLI entry: train the LM (or the paper's CF model with ``--mf``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--mf", action="store_true", help="train the paper's CF model")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="LM learning rate (the MF model takes its config's)")
    ap.add_argument("--loss", default="heat", choices=["heat", "softmax"])
    ap.add_argument("--remat", default="none", choices=["full", "none"])
    ap.add_argument("--optimizer", default="adamw", choices=["sgd", "adamw"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--steps-per-dispatch", type=int, default=16,
                    help="steps per window; losses are read back once per "
                         "window")
    ap.add_argument("--backend", default=None,
                    help="loss backend (engine.LOSS_IMPLS): fused, autodiff, "
                         "simplex_bmm, mse_dot, pallas (the CUDA kernels) — "
                         "for the MF engine and the LM HEAT head alike")
    ap.add_argument("--update-impl", default=None,
                    help="MF row-update impl: scatter_add, pallas (the CUDA "
                         "kernel), dense")
    ap.add_argument("--sampler", default=None,
                    choices=["auto", "uniform", "tile", "popularity",
                             "in_batch"],
                    help="negative-sampling strategy (engine.SAMPLERS, "
                         "default: auto)")
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

    from repro_torch.core.mf import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    if args.mf:
        losses = _train_mf(args, device)
    else:
        losses = _train_lm(args, device, ap)
    print(f"done: {len(losses)} steps, final loss {losses[-1]:.4f}")


def _train_mf(args, device) -> list:
    from repro_torch.configs.heat_mf import MF_100M
    from repro_torch.core.engine import resolve_engine
    from repro_torch.data import pipeline
    from repro_torch.train import trainer

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
    return losses


def _train_lm(args, device, ap) -> list:
    from repro_torch.configs import get_config
    from repro_torch.core.engine import resolve_engine
    from repro_torch.models import lm
    from repro_torch.train import trainer

    try:
        cfg = get_config(args.arch)
    except ValueError as e:
        ap.error(str(e))
    if args.reduced:
        cfg = cfg.reduced()
    heat_over = {k: v for k, v in (
        ("backend", args.backend), ("sampler", args.sampler)) if v}
    if heat_over:
        cfg = dataclasses.replace(
            cfg, heat=dataclasses.replace(cfg.heat, **heat_over))
    if args.loss == "heat":
        print(f"[launch] LM head engine: {resolve_engine(cfg.heat).name} "
              f"(device={device})")
    opts = lm.TrainOptions(loss=args.loss, remat=args.remat,
                           attn_chunk=min(1024, args.seq))
    tcfg = trainer.TrainerConfig(
        steps=args.steps, lr=args.lr, batch_size=args.batch,
        seq_len=args.seq, optimizer=args.optimizer,
        grad_accum=args.grad_accum, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, fail_at_step=args.fail_at_step,
        steps_per_dispatch=args.steps_per_dispatch)
    _, losses = trainer.train_lm(cfg, opts, tcfg, device=device)
    return losses


if __name__ == "__main__":
    main()
