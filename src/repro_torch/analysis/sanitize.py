"""Runtime sanitizers for the hot paths (the port of
``src/repro/analysis/sanitize.py``): hidden host syncs, silent rank
promotion, NaNs, call-shape budgets and in-place reuse of the carried
state.

The reference arms JAX's own machinery (``transfer_guard``,
``numpy_rank_promotion``, ``debug_nans``) and counts jit traces.  The port
has no tracer, so each guard is a ``TorchDispatchMode`` check on the ops a
region runs, and the budgets count distinct call shapes
(``train/shapes.py``):

* :func:`sanitize` arms, around a code region:

  - **transfer** (``"disallow"``): every device-to-host readback raises
    :class:`TransferError`: ``aten._local_scalar_dense`` (what ``.item()``,
    ``int()``, ``float()`` and ``bool()`` of a tensor call), a copy from a
    non-CPU tensor to the CPU, and the ops whose output size the data
    decides (``nonzero``, ``masked_select``, ``unique*``, boolean
    indexing), which read the device back to size their output.  The CPU
    tensors of a CPU run are checked the same way: the code path is the
    same.  Readbacks the region means to make go inside ``with
    handle.edge(): ...`` (the reference's explicit ``np.asarray`` edge);
    library code marks its own explicit edges with the module's
    :func:`edge` (the server's upload of a request batch and download of
    its answers, as the reference's server puts and gets them explicitly).
    On a machine with a card the region also sets
    ``torch.cuda.set_sync_debug_mode("error")`` (lifted inside ``edge``,
    restored on exit).  That mode is process-wide and the dispatch mode
    thread-local, so serve on the calling thread inside a region
    (``BatchingRecommender.recommend_many``), never through the server's
    worker thread;
  - **rank_promotion** (``"raise"``): a pointwise op on two tensors of rank
    1 or more and unequal rank raises ``ValueError`` ("implicit
    broadcast");
  - **debug_nans**: a NaN in any floating output raises
    ``FloatingPointError`` naming the op that produced it (one readback an
    op: slow).

  The handle's budgeted counters are checked on a clean exit.  Discipline:
  warm up outside, run the steady state inside.  Unlike the reference's
  ``rank_promotion``, arming the guards changes no call shape, so a warm
  entry point sees no new shape inside a region.
* :class:`TraceCounter` / :func:`trace_counter`: the reference's names
  over ``ShapeCounter``: a wrapped callable records each call's signature
  (its tensors' shapes and dtypes, its other arguments' types) and
  :meth:`TraceCounter.check` enforces the budget.  :class:`RetraceError`
  is ``train/shapes.py``'s.
* :func:`donation_report` / :func:`assert_donation`: whether the tensors
  of the carried arguments come back as the outputs' tensors (the same
  ``data_ptr()``): the port updates the tables and the optimizer state in
  place where the reference donates them (ROADMAP C.3).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.train.shapes import RetraceError, ShapeCounter

__all__ = ["DonationError", "DonationReport", "RetraceError", "Sanitizer",
           "TraceCounter", "TransferError", "assert_donation",
           "donation_report", "edge", "sanitize", "trace_counter"]


class TransferError(RuntimeError):
    """A device-to-host readback inside a guarded region."""


class DonationError(AssertionError):
    """A carried tensor was copied instead of updated in place."""


# ---------------------------------------------------------------------------
# Call-shape budgets
# ---------------------------------------------------------------------------

def _signature(args, kwargs) -> tuple:
    def sig(x):
        if isinstance(x, torch.Tensor):
            return ("tensor", tuple(x.shape), str(x.dtype))
        if isinstance(x, (tuple, list)):
            return tuple(sig(v) for v in x)
        if isinstance(x, dict):
            return tuple((k, sig(v)) for k, v in sorted(x.items()))
        return type(x).__name__
    return (sig(tuple(args)), sig(dict(kwargs)))


class TraceCounter(ShapeCounter):
    """Distinct call signatures of the callables it wraps, with a budget
    that :meth:`check` enforces (the reference's trace counter: one count
    a new signature, none a repeated call).

        counter = TraceCounter("serve", budget=1)
        fn = counter.wrap(recommend)
        fn(x); fn(x)         # count == 1
        counter.check()      # ok; a second signature would raise"""

    def __init__(self, label: str = "call", budget: Optional[int] = None):
        super().__init__(label, budget)

    def add(self, shape) -> None:
        """Record one call of ``shape``; the budget waits for
        :meth:`check`."""
        self._shapes.add(shape)

    def wrap(self, fn: Callable) -> Callable:
        """``fn`` recording each call's signature; the result carries this
        counter as ``.trace_counter``."""
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            self.add(_signature(args, kwargs))
            return fn(*args, **kwargs)
        counted.trace_counter = self
        return counted

    def __repr__(self) -> str:
        return (f"TraceCounter({self.label!r}, count={self.count}, "
                f"budget={self.budget})")


def trace_counter(fn: Callable, *, label: Optional[str] = None,
                  budget: Optional[int] = None) -> Callable:
    """``fn`` wrapped by a new :class:`TraceCounter` (its
    ``.trace_counter``)."""
    return TraceCounter(label or getattr(fn, "__name__", "call"),
                        budget).wrap(fn)


# ---------------------------------------------------------------------------
# Donation: in-place reuse of the carried tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DonationReport:
    """Which carried tensors came back as output tensors."""

    reused: int
    copied: int
    copied_bytes: int
    details: list    # [(leaf path, nbytes, reused)]

    @property
    def ok(self) -> bool:
        """True when no carried tensor was copied."""
        return self.copied == 0

    def __str__(self) -> str:
        lines = [f"donation: {self.reused} reused, {self.copied} copied "
                 f"({self.copied_bytes} bytes copied)"]
        lines += [f"  COPIED {p} ({n} B)" for p, n, r in self.details if not r]
        return "\n".join(lines)


def _leaf_ptrs(tree: Any, path: str = "") -> dict:
    """``{data_ptr: (path, nbytes)}`` of the tensors of a tree of tuples,
    NamedTuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return {tree.data_ptr(): (path, tree.nbytes)} if tree.numel() else {}
    out: dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaf_ptrs(v, f"{path}[{k!r}]"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            out.update(_leaf_ptrs(v, f"{path}.{k}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_leaf_ptrs(v, f"{path}[{i}]"))
    return out


def _donation(fn, args, kwargs, donate_argnums, min_bytes):
    in_ptrs = _leaf_ptrs([args[i] for i in donate_argnums])
    out = fn(*args, **kwargs)
    out_ptrs = set(_leaf_ptrs(out))
    rows = [(path, nbytes, ptr in out_ptrs)
            for ptr, (path, nbytes) in sorted(in_ptrs.items(),
                                              key=lambda kv: kv[1][0])
            if nbytes >= min_bytes]
    return out, rows


def donation_report(fn: Callable, *args,
                    donate_argnums: Iterable[int] = (0,),
                    min_bytes: int = 0, **kwargs) -> DonationReport:
    """Call ``fn(*args, **kwargs)`` and report whether each tensor of the
    arguments in ``donate_argnums`` is among the outputs' tensors (the same
    storage pointer: updated in place).  ``min_bytes`` ignores smaller
    tensors."""
    _, rows = _donation(fn, args, kwargs, tuple(donate_argnums), min_bytes)
    copied = [(p, n) for p, n, hit in rows if not hit]
    return DonationReport(len(rows) - len(copied), len(copied),
                          sum(n for _, n in copied), rows)


def assert_donation(fn: Callable, *args,
                    donate_argnums: Iterable[int] = (0,),
                    min_bytes: int = 1 << 12, **kwargs):
    """:func:`donation_report`'s call, raising :class:`DonationError` when
    a carried tensor of at least ``min_bytes`` was copied; returns ``fn``'s
    output."""
    out, rows = _donation(fn, args, kwargs, tuple(donate_argnums), min_bytes)
    bad = [(p, n) for p, n, hit in rows if not hit]
    if bad:
        listing = ", ".join(f"{p} ({n} B)" for p, n in sorted(bad))
        raise DonationError(
            f"carried tensors were copied, not reused: {listing}; an "
            "out-of-place update allocates a new tensor every call")
    return out


# ---------------------------------------------------------------------------
# The guards
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
#: ops whose output size depends on the data (they read the device back).
_DATA_SIZED = {
    _aten.nonzero.default, _aten.nonzero_static.default,
    _aten.masked_select.default, _aten._unique.default,
    _aten._unique2.default, _aten.unique_dim.default,
    _aten.unique_consecutive.default, _aten.unique_dim_consecutive.default,
    _aten.argwhere.default, _aten.nonzero_numpy.default,
}
_COPIES = {_aten.copy_.default, _aten._copy_from.default,
           _aten._copy_from_and_resize.default}


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class _Guards(TorchDispatchMode):
    """The armed checks of one :func:`sanitize` region."""

    def __init__(self, transfer: bool, rank_promotion: bool,
                 debug_nans: bool):
        super().__init__()
        self.transfer = transfer
        self.rank_promotion = rank_promotion
        self.debug_nans = debug_nans
        self.edge_depth = 0

    def _check_transfer(self, func, args, kwargs) -> None:
        if func is _aten._local_scalar_dense.default:
            raise TransferError(
                f"Disallowed device-to-host transfer: {func} (.item(), "
                "int(), float() or bool() of a tensor) inside a guarded "
                "region; read back at a window edge (handle.edge())")
        if func in _DATA_SIZED:
            raise TransferError(
                f"Disallowed device-to-host transfer: {func} sizes its "
                "output from the data, a hidden readback")
        if func is _aten.index.Tensor and any(
                _is_tensor(i) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ())):
            raise TransferError(
                f"Disallowed device-to-host transfer: boolean indexing "
                f"({func}) sizes its output from the data")
        if func is _aten._to_copy.default and _is_tensor(args[0]) \
                and args[0].device.type != "cpu" \
                and str(kwargs.get("device", args[0].device)) == "cpu":
            raise TransferError(
                f"Disallowed device-to-host transfer: {func} of a "
                f"{args[0].device} tensor to the CPU")
        if func in _COPIES and len(args) > 1 and _is_tensor(args[0]) \
                and _is_tensor(args[1]):
            dst, src = (args[0], args[1]) if func is _aten.copy_.default \
                else (args[1], args[0])
            if dst.device.type == "cpu" and src.device.type != "cpu":
                raise TransferError(
                    f"Disallowed device-to-host transfer: {func} from "
                    f"{src.device} to the CPU")

    def _check_rank(self, func, args) -> None:
        if torch.Tag.pointwise not in func.tags:
            return
        ranks = {a.dim() for a in args if _is_tensor(a) and a.dim() >= 1}
        if len(ranks) > 1:
            raise ValueError(
                f"{func}: implicit broadcast of ranks {sorted(ranks)} (rank "
                "promotion); reshape the lower-rank operand explicitly")

    def _check_nans(self, func, out) -> None:
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if _is_tensor(t) and t.is_floating_point() and t.numel() \
                    and t.device.type != "meta":
                with _sync_allowed(t.device):
                    bad = bool(torch.isnan(t).any())
                if bad:
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.transfer and not self.edge_depth:
            self._check_transfer(func, args, kwargs)
        if self.rank_promotion:
            self._check_rank(func, args)
        out = func(*args, **kwargs)
        if self.debug_nans:
            self._check_nans(func, out)
        return out


@contextlib.contextmanager
def _sync_allowed(device: torch.device):
    """Lift ``torch.cuda``'s sync debug mode for a readback on ``device``."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class Sanitizer:
    """Handle yielded by :func:`sanitize`: hands out budgeted counters,
    checks them all on a clean exit, and opens :meth:`edge` regions."""

    def __init__(self, trace_budgets: Optional[dict] = None):
        self._budgets = dict(trace_budgets or {})
        self.counters: dict = {}
        self._guards: Optional[_Guards] = None
        self._cuda_mode: Optional[int] = None

    def counter(self, label: str, budget: Optional[int] = None) -> TraceCounter:
        """The region's :class:`TraceCounter` named ``label`` (made on first
        use, with its declared budget, else ``budget``)."""
        if label not in self.counters:
            self.counters[label] = TraceCounter(
                label, self._budgets.get(label, budget))
        return self.counters[label]

    def adopt(self, label: str, counter: ShapeCounter) -> ShapeCounter:
        """Check an externally owned counter (an executor's, a server's) on
        exit, under the budget declared for ``label``."""
        if label in self._budgets:
            counter.budget = self._budgets[label]
        self.counters[label] = counter
        return counter

    def check(self) -> None:
        """Raise :class:`RetraceError` for any counter over its budget."""
        for c in self.counters.values():
            c.check()

    @contextlib.contextmanager
    def edge(self):
        """A window edge inside the region: readbacks are allowed here."""
        guards = self._guards
        if guards is not None:
            guards.edge_depth += 1
        if self._cuda_mode is not None:
            torch.cuda.set_sync_debug_mode(self._cuda_mode)
        try:
            yield
        finally:
            if self._cuda_mode is not None:
                torch.cuda.set_sync_debug_mode("error")
            if guards is not None:
                guards.edge_depth -= 1


#: this thread's guarded regions, innermost last.
_ACTIVE = threading.local()


def _regions() -> list:
    if not hasattr(_ACTIVE, "handles"):
        _ACTIVE.handles = []
    return _ACTIVE.handles


@contextlib.contextmanager
def edge():
    """An explicit readback point: inside, the innermost guarded region of
    this thread (if any) allows readbacks, as its ``handle.edge()``
    does."""
    regions = _regions()
    if not regions:
        yield
        return
    with regions[-1].edge():
        yield


_TRANSFER = (None, "allow", "disallow")
_RANK = (None, "allow", "raise")


@contextlib.contextmanager
def sanitize(*, transfer: Optional[str] = "disallow",
             rank_promotion: Optional[str] = "raise",
             debug_nans: bool = False,
             trace_budgets: Optional[dict] = None):
    """Arm the runtime guards around a code region (the module docstring);
    yields a :class:`Sanitizer` whose counters are budget-checked on a
    clean exit.  ``transfer``: ``"disallow"`` arms the readback guard
    (``None`` / ``"allow"``: off); ``rank_promotion``: ``"raise"`` arms the
    broadcast guard; ``debug_nans``: the NaN guard."""
    if transfer not in _TRANSFER or rank_promotion not in _RANK:
        raise ValueError(f"transfer must be one of {_TRANSFER} and "
                         f"rank_promotion one of {_RANK}; got {transfer!r}, "
                         f"{rank_promotion!r}")
    handle = Sanitizer(trace_budgets)
    guard_transfer = transfer == "disallow"
    guards = _Guards(guard_transfer, rank_promotion == "raise", debug_nans)
    handle._guards = guards
    if guard_transfer and torch.cuda.is_available():
        handle._cuda_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    _regions().append(handle)
    try:
        with guards:
            yield handle
    finally:
        _regions().pop()
        if handle._cuda_mode is not None:
            torch.cuda.set_sync_debug_mode(handle._cuda_mode)
    handle.check()
