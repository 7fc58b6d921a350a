"""``update.sort_us`` (us/step): device microseconds a step in the row
update's sorts, sorted-segment reductions, scans, searches and scatters,
by kernel name.  Layer: the row update (``kernels/ops.py::fused_rows_update``,
``core/tiling.py``'s sorted segment sums, ``core/samplers.py``'s tile
write-through, ``optim/quantization.py``'s int8 requantize).  The scatter of
``index_put_`` runs in ``index_elementwise_kernel``, which the indexing
gathers share, so it is left out.  It moves ``train_samples_per_s`` most in
the device-bound cells (batch 16,384)."""
import re

PATTERN = re.compile(r"sort|segment|scatter|searchsorted|scan", re.IGNORECASE)


def read(ctx):
    """Microseconds a step; None when no such kernel ran."""
    seconds = ctx.trace.device_time_s(lambda name: bool(PATTERN.search(name)))
    if seconds <= 0:
        return None
    return 1e6 * seconds / ctx.steps
