"""The deterministic sorted segment sum as a hand-written CUDA kernel, with
its plain PyTorch version: ``out[s] = sum(values[order[i]] for sorted i with
sidx[i] == s)``, which ``core/tiling.py``'s segment sums (the slot reduction,
the tile write-through, the int8 update's duplicate pre-reduce, the row
gathers' backward) run.

``torch.segment_reduce`` sums each run in order on one thread a column, so
its time follows the longest run, not the bytes.  Here each run is cut into
pieces of at most :data:`PIECE` positions counted from its start; each piece
is summed in order and a run's pieces are then added in piece order
(``csrc/segment_sum.cu`` says how the card does it).  A run of up to
:data:`PIECE` positions gets ``segment_reduce``'s bits, and a longer one the
same bits on every call and every device.  The values are read through the
sort's permutation ``order``, so the sorted copy ``values[order]`` is never
written on the card.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises; a ``meta`` tensor (the dry run) gets the output's shape and
runs nothing.  The kernel takes fp32 values; :func:`sorted_segment_sum`
sends every other dtype to :func:`sequential_sum`, the one ``segment_reduce``
call, on any device.  ``SEGMENT_SUM_LAUNCHES`` counts the dispatches;
:func:`engaged_pieces` is the card's count of the pieces past each run's
first, the positions ``segment_reduce`` summed one after another.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the longest piece of a run summed in order: a run's dependent adds are at
#: most ``PIECE + M / PIECE``.  Chosen on an NVIDIA H100 80GB HBM3 at
#: 700 W (``tools/probe_kernels.py --parts segment_sum``; PERF.md, kernel #8).
PIECE = 512

SEGMENT_SUM_LAUNCHES = _build.LaunchCounter("segment_sum")
_P = ctypes.c_void_p
_ARGS = [_P] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [_P]
_ENGAGED: dict[torch.device, torch.Tensor] = {}


def engaged_pieces(device) -> torch.Tensor:
    """The card's int64 count (shape (1,)) of the pieces past each run's
    first that the kernel summed on ``device`` since the process started;
    read it after a sync.  The step never reads it."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    counter = _ENGAGED.get(device)
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int64, device=device)
        _ENGAGED[device] = counter
    return counter


def _lengths(sidx, num_segments: int):
    """The run length of each of the ``num_segments`` kept segments of
    sorted ``sidx``; the dropped tail (``sidx == num_segments``) is in none."""
    bounds = torch.searchsorted(
        sidx, torch.arange(num_segments + 1, dtype=sidx.dtype,
                           device=sidx.device))
    return bounds.diff()


def sequential_sum(sidx, values, num_segments: int):
    """Each run of sorted ``sidx`` summed in order in one ``segment_reduce``
    call over the kept segments' lengths only: their sum is less than the
    rows of ``values`` by the dropped tail, which ``unsafe=True`` accepts
    and which is never summed."""
    return torch.segment_reduce(values, "sum", lengths=_lengths(sidx, num_segments),
                                axis=0, unsafe=True)


def sorted_segment_sum_plain(sidx, values, num_segments: int, order=None):
    """Plain version of :func:`sorted_segment_sum`, the kernel's order of
    adds, with no readback: the one :func:`sequential_sum` call gives every
    run of up to :data:`PIECE` positions; where more positions than that
    are given, a longer run's pieces are then summed in order
    (``index_add_`` adds in index order on the CPU) and its pieces added in
    order, and that sum replaces the run's.  Knowing that no run is longer
    than a piece would take a readback, so every call of more than
    :data:`PIECE` positions pays for the piecewise pass over all of them,
    about twice the one ``segment_reduce``, even where it then keeps
    nothing of it."""
    if order is not None:
        values = values[order]
    lengths = _lengths(sidx, num_segments)
    out = torch.segment_reduce(values, "sum", lengths=lengths, axis=0, unsafe=True)
    m = sidx.shape[0]
    if m <= PIECE or num_segments == 0:     # no run can be longer than a piece
        return out
    dev = sidx.device
    pieces = (lengths + PIECE - 1) // PIECE
    ends = torch.cumsum(pieces, 0)
    slots = num_segments + (m + PIECE - 1) // PIECE        # more than the pieces
    seg = torch.clamp_max(sidx, num_segments - 1)
    k = (torch.arange(m, device=dev) - (torch.cumsum(lengths, 0) - lengths)[seg]) // PIECE
    long = lengths > PIECE
    piece = torch.where((sidx < num_segments) & long[seg], ends[seg] - pieces[seg] + k, slots)
    partial = torch.zeros((slots + 1, values.shape[1]), dtype=values.dtype, device=dev)
    partial.index_add_(0, piece, values)
    owner = torch.searchsorted(ends, torch.arange(slots, device=dev), right=True)
    runs = torch.zeros((num_segments + 1, values.shape[1]), dtype=values.dtype, device=dev)
    # A piece's sum starts from +0, so it is never -0 and the +0 that the
    # run's sum starts from leaves its bits as they are.
    runs.index_add_(0, owner, partial[:slots])
    return torch.where(long[:, None], runs[:num_segments], out)


def sorted_segment_sum(sidx, values, num_segments: int, order=None):
    """``out[s] = sum(values[order[i]] for i with sidx[i] == s)`` summed in
    sorted order, long runs in pieces: (num_segments, K) from ``sidx`` (M,)
    int64, sorted by a stable sort and in ``[0, num_segments]``, the sort's
    permutation ``order`` (M,) int64 or None (``values`` already sorted), and
    ``values`` (N, K).  Positions with ``sidx == num_segments`` are dropped
    and never read; empty segments give 0.  No atomics on the values and no
    host sync."""
    m = sidx.shape[0]
    if sidx.dim() != 1 or values.dim() != 2 or (order is None and values.shape[0] != m) \
            or (order is not None and tuple(order.shape) != (m,)):
        raise ValueError(f"expected sidx (M,), order (M,) or None, values (N, K); got "
                         f"{tuple(sidx.shape)}, "
                         f"{None if order is None else tuple(order.shape)}, "
                         f"{tuple(values.shape)}")
    dev = values.device
    if dev.type == "meta":                  # the dry run: the output's shape
        SEGMENT_SUM_LAUNCHES.bump("meta")
        return torch.empty((num_segments, values.shape[1]), dtype=values.dtype,
                           device="meta")
    if values.dtype != torch.float32:       # no kernel: the library's in-order sum
        return sequential_sum(sidx, values if order is None else values[order],
                              num_segments)
    if dev.type == "cpu":
        SEGMENT_SUM_LAUNCHES.bump("cpu")
        return sorted_segment_sum_plain(sidx, values, num_segments, order)
    if dev.type != "cuda":
        raise ValueError(f"sorted_segment_sum: no kernel for {dev}")
    operands = [(sidx, torch.int64), (values, torch.float32)]
    if order is not None:
        operands.append((order, torch.int64))
    _build.check_operands("sorted_segment_sum", dev, operands)
    k = values.shape[1]
    out = torch.empty((num_segments, k), dtype=torch.float32, device=dev)
    chunks = (m + PIECE - 1) // PIECE
    scratch = torch.empty((chunks, k), dtype=torch.float32, device=dev)
    meta = torch.empty((chunks,), dtype=torch.int64, device=dev)
    fn = _build.bind("segment_sum", "segment_sum_sorted", _ARGS)
    with torch.cuda.device(dev):
        err = fn(sidx.data_ptr(), None if order is None else order.data_ptr(),
                 values.data_ptr(), out.data_ptr(), scratch.data_ptr(), meta.data_ptr(),
                 engaged_pieces(dev).data_ptr(), m, num_segments, k, PIECE,
                 _build.stream_of(values))
    _build.check(err, "sorted_segment_sum")
    SEGMENT_SUM_LAUNCHES.bump("cuda")
    return out
