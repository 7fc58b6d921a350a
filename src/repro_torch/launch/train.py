"""Training launcher CLI of the port (``src/repro/launch/train.py``; its
meshes shard the MF model).

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
    PYTHONPATH=src python -m repro_torch.launch.train --mf --reduced --steps 8 \\
        --mesh host --mesh-data 2 --device cpu    # 2 gloo ranks, sharded
    PYTHONPATH=src python -m repro_torch.launch.train --mf --steps 4 \\
        --batch 1024 --backend pallas --update-impl pallas --mesh host \\
        --mesh-data 2 --dist-backend gloo   # 2 ranks sharing one card
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 4 --mesh host --mesh-data 2 --mesh-model 2 \\
        --device cpu                        # the LM on 4 gloo ranks

Without ``--mf`` it trains the LM named by ``--arch`` (any architecture of
``configs/``; default smollm-360m) with the HEAT vocab head (``--loss
heat``, whose engine ``--backend``/``--sampler`` select) or the
full-softmax head, under ``--optimizer`` sgd, adamw or adafactor; a VLM's
batches carry ``num_patches`` rows of synthetic patch embeddings and an
audio model's ``encoder_seq`` frames (fp32, ``lm_batch(extras=)``), as the
reference's do.  Runs on the card unless ``--device cpu`` is given; with no
CUDA device it exits with an error instead of falling back.

``--mesh`` shards the model, the MF model (``core/mf_distributed.py``) or
the LM (``models/lm_distributed.py``): ``host`` over ``--mesh-data`` x
``--mesh-model`` ranks, ``data`` data-parallel over ``--mesh-data`` ranks
(every card when it is 1), ``production`` over the 256-rank pod mesh.  The CLI starts the ranks itself
(``launch/mesh.py::run_ranks``) unless it already runs as one rank of
``torchrun`` (``RANK`` and ``WORLD_SIZE`` set).  ``--dist-backend`` is the
one flag the reference lacks: ``nccl`` (the default on the card) needs a
card per rank, ``gloo`` (the default on the CPU) also runs ranks that share
a card.  Rank 0 prints the run's lines.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os


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
    ap.add_argument("--optimizer", default="adamw",
                    choices=["sgd", "adamw", "adafactor"])
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
    ap.add_argument("--mesh", default="host",
                    choices=["host", "data", "production"],
                    help="host: --mesh-data x --mesh-model ranks; data: "
                         "data-parallel over --mesh-data ranks (every card "
                         "when it is 1); production: the 256-rank pod mesh "
                         "(under torchrun)")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="collective backend of a sharded run: nccl (default "
                         "on the card; one card per rank) or gloo (default on "
                         "the CPU; ranks may share a card)")
    args = ap.parse_args(argv)

    from repro_torch.core.mf import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    ranks = _mesh_ranks(args, device)
    if not args.mf:
        _lm_config(args, device, ap, announce=False)    # flags fail early
    if torchrun:
        losses = _torchrun_rank(args, device)
        if int(os.environ["RANK"]) != 0:
            return
    elif args.mesh == "production":
        from repro_torch.launch.mesh import make_production_mesh
        try:
            make_production_mesh()
        except RuntimeError as e:
            ap.error(str(e))
        ap.error("--mesh production runs as one rank of torchrun")
    elif ranks > 1:
        from repro_torch.launch.mesh import run_ranks
        if args.mf:
            _mf_config(args, device, ranks)
        else:
            _lm_config(args, device, ap, ranks=ranks)
        losses = run_ranks(_rank, ranks, args=(args, device.type),
                           backend=_backend(args, device),
                           device=device.type)[0]
    elif args.mf:
        losses = _train_mf(args, device)
    else:
        losses = _train_lm(args, device, ap)
    print(f"done: {len(losses)} steps, final loss {losses[-1]:.4f}")


def _mesh_ranks(args, device) -> int:
    """Ranks the requested mesh takes (``production``: 256)."""
    if args.mesh == "host":
        return args.mesh_data * args.mesh_model
    if args.mesh == "data":
        if args.mesh_data > 1 or device.type != "cuda":
            return args.mesh_data
        import torch
        return torch.cuda.device_count()
    return 256


def _backend(args, device) -> str:
    return args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")


def _make_mesh(args):
    from repro_torch.launch.mesh import (
        make_data_mesh,
        make_host_mesh,
        make_production_mesh,
    )
    if args.mesh == "production":
        return make_production_mesh()
    if args.mesh == "data":
        return make_data_mesh()
    return make_host_mesh(args.mesh_data, args.mesh_model)


def _rank(args, device: str) -> list:
    """One rank of a sharded CLI run (started by ``run_ranks``): rank 0
    logs; returns the losses."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import rank_device
    quiet = dist.get_rank() != 0
    train = _train_mf if args.mf else _train_lm
    return train(args, rank_device(device), mesh=_make_mesh(args), quiet=quiet)


def _torchrun_rank(args, device) -> list:
    """This process as one rank of ``torchrun``: join its process group
    (``env://``) and train; rank 0 prints."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.sharding import COLLECTIVE_TIMEOUT_S
    from repro_torch.launch.mesh import rank_device
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(_backend(args, device), timeout=datetime.timedelta(
        seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = _make_mesh(args)
        if rank == 0 and args.mf:
            _mf_config(args, device, world)
        elif rank == 0:
            _lm_config(args, device, ranks=world)
        train = _train_mf if args.mf else _train_lm
        return train(args, rank_device(device.type), mesh=mesh,
                     quiet=rank != 0)
    finally:
        dist.destroy_process_group()


def _mf_config(args, device, ranks: int = 1, announce: bool = True):
    """The MF config and engine the flags name; prints the engine line
    when ``announce``."""
    from repro_torch.configs.heat_mf import MF_100M
    from repro_torch.core.engine import resolve_engine

    cfg = MF_100M if not args.reduced else dataclasses.replace(
        MF_100M, num_users=2000, num_items=4000, emb_dim=64)
    overrides = {k: v for k, v in (
        ("backend", args.backend), ("update_impl", args.update_impl),
        ("sampler", args.sampler), ("table_format", args.table_format))
        if v}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    engine = resolve_engine(cfg)
    if announce:
        print(f"[launch] MF engine: {engine.name} "
              f"(steps_per_dispatch={args.steps_per_dispatch}, "
              f"devices={ranks}, device={device})", flush=True)
    return cfg, engine


def _train_mf(args, device, mesh=None, quiet: bool = False) -> list:
    """Train the MF model (on this rank's shard under ``mesh``, whose
    launcher printed the engine line); ``quiet`` drops the logs."""
    from repro_torch.data import pipeline
    from repro_torch.train import trainer

    cfg, engine = _mf_config(args, device, announce=mesh is None)
    ds = pipeline.synth_cf_dataset(min(cfg.num_users, 4096), cfg.num_items)
    _, losses = trainer.train_mf(cfg, ds, steps=args.steps,
                                 batch_size=args.batch, engine=engine,
                                 steps_per_dispatch=args.steps_per_dispatch,
                                 ckpt_dir=args.ckpt_dir,
                                 ckpt_every=args.ckpt_every,
                                 fail_at_step=args.fail_at_step, mesh=mesh,
                                 device=device,
                                 log=(lambda *_: None) if quiet else print)
    return losses


def _lm_config(args, device, ap=None, ranks: int = 1, announce: bool = True):
    """The LM config the flags name (with the HEAT head's engine
    overrides); prints the head's engine line when ``announce``."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import resolve_engine

    try:
        cfg = get_config(args.arch)
    except ValueError as e:
        if ap is None:
            raise
        ap.error(str(e))
    if args.reduced:
        cfg = cfg.reduced()
    heat_over = {k: v for k, v in (
        ("backend", args.backend), ("sampler", args.sampler)) if v}
    if heat_over:
        cfg = dataclasses.replace(
            cfg, heat=dataclasses.replace(cfg.heat, **heat_over))
    if announce and args.loss == "heat":
        print(f"[launch] LM head engine: {resolve_engine(cfg.heat).name} "
              f"(devices={ranks}, device={device})", flush=True)
    return cfg


def _train_lm(args, device, ap=None, mesh=None, quiet: bool = False) -> list:
    """Train the LM (on this rank's slices under ``mesh``, whose launcher
    printed the engine line); ``quiet`` drops the logs."""
    from repro_torch.models import lm
    from repro_torch.train import trainer

    cfg = _lm_config(args, device, ap, announce=mesh is None)
    opts = lm.TrainOptions(loss=args.loss, remat=args.remat,
                           attn_chunk=min(1024, args.seq))
    tcfg = trainer.TrainerConfig(
        steps=args.steps, lr=args.lr, batch_size=args.batch,
        seq_len=args.seq, optimizer=args.optimizer,
        grad_accum=args.grad_accum, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, fail_at_step=args.fail_at_step,
        steps_per_dispatch=args.steps_per_dispatch, mesh=mesh)
    extras = None
    if cfg.family in ("audio", "vlm"):
        import torch
        name, rows = (("frames", cfg.encoder_seq) if cfg.family == "audio"
                      else ("patches", cfg.num_patches))
        extras = {name: ((args.batch, rows, cfg.d_model), torch.float32)}
    _, losses = trainer.train_lm(cfg, opts, tcfg, extras, device=device,
                                 log=(lambda *_: None) if quiet else print)
    return losses


if __name__ == "__main__":
    main()
