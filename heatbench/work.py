"""Operations and bytes of the work of an MF training step, from its shapes.

FLOPs count each multiply and each add (a dot of length K is 2K).  Model
FLOPs are the forward and the analytic backward, each once, with no
recomputation:

* CCL, per batch row: forward ``(4n + 6) K`` (the dots u.p, u.u, p.p and the
  n dots u.n_j and n_j.n_j); backward ``(5n + 7) K`` (``sum_j w_j n_j``,
  ``du``, ``dp``, and the n rows ``dn_j = w_j u - c_j n_j``);
* aggregation (``avg``), per batch row: forward ``2HK + 2K^2 + 4K`` (the
  masked history sum, the mean, the (K, K) product, the gate), backward
  ``2HK + 4K^2 + 3K`` (both products of the (K, K) backward, the history
  rows' gradient, the gate).

Bytes count each distinct table row that the work reads once and each
distinct row it writes once, at the table's storage width (fp32 ``4K``;
int8 ``K`` plus a 4-byte scale).  Tile negatives read at most the tile's
rows, whatever ``B * n`` is, so a design that reads tile rows directly, or
that sums duplicates before the write, never reads above 100% of a least
time built from these counts.
"""
from __future__ import annotations


def ccl_flops(b: int, n: int, k: int) -> int:
    """Forward and backward FLOPs of the CCL loss over ``b`` rows."""
    return b * ((4 * n + 6) + (5 * n + 7)) * k


def aggregation_flops(b: int, h: int, k: int) -> int:
    """Forward and backward FLOPs of the ``avg`` aggregator over ``b``
    rows of ``h`` history items (0 without history)."""
    if h <= 0:
        return 0
    return b * ((2 * h * k + 2 * k * k + 4 * k) + (2 * h * k + 4 * k * k + 3 * k))


def step_model_flops(b: int, n: int, k: int, h: int) -> int:
    """Model FLOPs of one training step."""
    return ccl_flops(b, n, k) + aggregation_flops(b, h, k)


def row_bytes(k: int, table_format: str) -> int:
    """Bytes of one stored table row."""
    return k + 4 if table_format == "int8" else 4 * k


def ccl_bytes(user_rows: int, user_width: int, pos_rows: int, pos_width: int,
              neg_rows: int, k: int) -> int:
    """Least bytes of the CCL forward and backward: the distinct user
    inputs, positive rows and negative rows read once each (at the widths
    given), and one fp32 gradient row written for each."""
    reads = user_rows * user_width + pos_rows * pos_width + neg_rows * 4 * k
    writes = (user_rows + pos_rows + neg_rows) * 4 * k
    return reads + writes


def update_bytes(distinct_rows: int, k: int) -> int:
    """Least bytes of an fp32 row update: each distinct row read, its summed
    gradient read, and the row written."""
    return distinct_rows * 3 * 4 * k


def dequant_gather_bytes(distinct_rows: int, k: int) -> int:
    """Least bytes of an int8 gather-dequant: each distinct row read at
    int8 width with its scale, and its fp32 row written once."""
    return distinct_rows * (row_bytes(k, "int8") + 4 * k)
