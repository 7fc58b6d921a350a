"""Meshes over ``torch.distributed`` ranks, and a launcher of local ranks
(the port of ``src/repro/launch/mesh.py``).

A mesh is built over an initialized process group whose world size is the
mesh's size: one rank per card under NCCL, or gloo ranks on the CPU or on a
card they share.  :func:`run_ranks` starts N local ranks itself: one
``spawn``ed process each, meeting through a ``FileStore`` in a temporary
directory (no ports, no network), each with the collective timeout of
``distributed/sharding.py``, so a dead rank fails the run fast, with its
traceback raised in the parent.

The backend is the caller's choice and nothing falls back: ``nccl`` puts
rank r on card ``r % cards`` (two ranks on one card raise NCCL's own
error), ``gloo`` runs on the CPU or shares the cards the same way.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.sharding import COLLECTIVE_TIMEOUT_S, Mesh

#: backends a rank may be started with.
BACKENDS = ("nccl", "gloo")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The (16, 16) production mesh, or the (2, 16, 16) multi-pod one: it
    needs a process group of 256 (512) ranks, one per card."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    ndev = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < ndev:
        raise RuntimeError(
            f"need {ndev} ranks for mesh {tuple(shape.values())}, have "
            f"{world} — start one rank per card (torchrun, or "
            "launch/mesh.py::run_ranks) before building the production mesh")
    return Mesh(shape)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the process group's ranks (its world size
    must be ``data * model``; a 1x1 mesh needs no process group)."""
    return Mesh({"data": data, "model": model})


def make_data_mesh(data: int = 0) -> Mesh:
    """Pure data-parallel mesh; ``data=0`` takes every rank of the process
    group."""
    n = data or (dist.get_world_size() if dist.is_initialized() else 1)
    return make_host_mesh(data=n, model=1)


def rank_device(device) -> torch.device:
    """This rank's device for a requested ``"cpu"`` or ``"cuda"``: a CUDA
    rank r uses card ``r % cards``."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def init_rank(rank: int, world: int, backend: str, store_path: str,
              device="cpu") -> torch.device:
    """Join the process group as ``rank`` of ``world`` through the
    ``FileStore`` at ``store_path``; returns the rank's device."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; available: {BACKENDS}")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % max(torch.cuda.device_count(), 1))
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return rank_device(device)


def _rank_main(rank, world, backend, store_path, device, threads, fn,
               args_path, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        init_rank(rank, world, backend, store_path, device)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def _dead_ranks(procs, got, failed: int, grace: float = 2.0) -> str:
    """Ranks that died without reporting (a peer's failure is often only
    the echo of such a death), waiting up to ``grace`` seconds for them."""
    deadline = time.monotonic() + grace
    while True:
        dead = [f"rank {r} exited with code {p.exitcode}; "
                for r, p in enumerate(procs)
                if r not in got and r != failed and p.exitcode not in (None, 0)]
        if dead or time.monotonic() > deadline:
            return "".join(dead)
        time.sleep(0.05)


def run_ranks(fn: Callable, world: int, *, args: Sequence = (),
              backend: str = "gloo", device="cpu",
              timeout: float = 600.0, threads: Optional[int] = None,
              store_dir: Optional[str] = None) -> list:
    """Run ``fn(*args)`` on ``world`` local ranks of a fresh process group;
    returns their results in rank order.

    ``fn`` must be importable by a ``spawn``ed process (a module-level
    function) and its result picklable (host values: tensors go back
    through shared memory, so return numpy arrays or lists).  Each rank
    joins with :func:`init_rank` (``device`` ``"cpu"`` or ``"cuda"``;
    ``threads`` sets ``torch.set_num_threads``).  The first rank that fails
    stops the others, and its traceback is raised here as a
    ``RuntimeError``; a rank that dies without one, or a run past
    ``timeout`` seconds, raises too.  The ``FileStore`` lives in a new
    temporary directory (under ``store_dir`` when given)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        # The ranks read ``args`` from a file: through the start pipe, a
        # large payload would hold each start until the previous rank had
        # imported its modules, starting the ranks one after another.
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, backend, store, device, threads, fn, args_path,
            results)) for r in range(world)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world - len(got)} of {world} ranks still running "
                        f"after {timeout:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0][0]} exited with code "
                            f"{dead[0][1]} before it reported") from None
                    continue
                if not ok:
                    raise RuntimeError(f"{_dead_ranks(procs, got, rank)}rank "
                                       f"{rank} of {world} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(30)
        finally:
            _stop(procs)
    return [got[r] for r in range(world)]
