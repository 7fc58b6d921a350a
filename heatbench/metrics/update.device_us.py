"""``update.device_us`` (us/step): device microseconds a step of the
operations that the row update enqueued: the program's ``update.user``,
``update.item`` (the slot reduction and the item table's update) and
``tile.write`` spans (``core/mf.py::heat_train_step``), joined with the
traced stretch by ``heatbench/spans.py``.  Layer: the row update.  Where
``update.sort_us`` picks kernels by name, this reads where the work was
launched.  It moves ``train_samples_per_s`` most in the device-bound
cells."""
from heatbench import spans


def read(ctx):
    """Microseconds a step; None when the program recorded no span or the
    trace's launches and operations differ in number."""
    joined = spans.join(ctx.trace)
    return None if joined is None else joined.device_us(spans.UPDATE)
