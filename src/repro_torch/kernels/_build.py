"""Build and bind the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on its
own with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/repro_torch/<name>-<hash>.so`` at the root of
the checkout, then loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The file name carries a hash of the source, so an edited
source is rebuilt and a stale library is never loaded.  :func:`build_all`
starts one ``nvcc`` per source at once; :func:`library` builds (if needed)
and loads one.

Nothing here runs at import, and ``nvcc`` is first needed when a kernel
launches: the CPU tests import every module on machines with no CUDA
toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``/usr/local/cuda/bin/nvcc`` or the one on PATH."""
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library is current;
    returns ``(process, tmp_path, target)`` or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> str:
    proc, tmp, target = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, target)                 # atomic: readers never see a partial .so
    target.with_suffix(".log").write_text(log)
    return log


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, float]:
    """Compile every stale source, one nvcc per source, all in parallel.
    Returns the wall seconds of the whole build per source name (0.0 where
    the library was already current)."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in sources()}
    secs = {}
    for name, s in started.items():
        if s is not None:
            _finish(name, s)
        secs[name] = time.perf_counter() - t0 if s is not None else 0.0
    return secs


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of the current ``csrc/<name>.cu``."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library, building it first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its ``argtypes``
    declared (``c_void_p`` for pointers and the stream, so none is cut to
    32 bits) and an ``int`` (CUDA error code) result."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_operands(name: str, device: torch.device, operands) -> None:
    """Raise ``ValueError`` unless every ``(tensor, dtype)`` pair lies on
    ``device``, has that dtype and is contiguous — what the kernels take."""
    for t, dtype in operands:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code (its
    ``cudaGetLastError()`` after the launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


class LaunchCounter:
    """Counts one kernel wrapper's dispatches per device type.

    ``count("cuda")`` is the number of kernel launches on the card (bumped
    where the wrapper launches its kernel and nowhere else); ``count("cpu")``
    counts the wrapper's plain-version calls on CPU tensors, so the CPU
    tests can hold the one-dispatch-per-step contract too; ``count("meta")``
    counts the calls on ``meta`` tensors (the dry run), which allocate the
    kernel's outputs on ``meta`` and neither launch nor run the plain
    version."""

    def __init__(self, name: str):
        self.name = name
        self._counts = {"cuda": 0, "cpu": 0, "meta": 0}

    def bump(self, device_type: str) -> None:
        """Record one dispatch on ``device_type``."""
        self._counts[device_type] += 1

    def count(self, device_type: str = "cuda") -> int:
        """Dispatches on ``device_type`` since the last reset."""
        return self._counts[device_type]

    def reset(self) -> None:
        """Zero every count."""
        self._counts = {"cuda": 0, "cpu": 0, "meta": 0}
