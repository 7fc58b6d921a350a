"""``sample.device_us`` (us/step): device microseconds a step of the
operations that the negative sampler enqueued (the program's ``sample``
span: the negative ids and the (B, n, K) gather of their rows), joined with
the traced stretch by ``heatbench/spans.py``.  Layer: negative sampling.
It moves ``train_samples_per_s`` most where the gather is a large share of
the step (``mf100m_b65536``)."""
from heatbench import spans


def read(ctx):
    """Microseconds a step; None when the program recorded no span or the
    trace's launches and operations differ in number."""
    joined = spans.join(ctx.trace)
    return None if joined is None else joined.device_us(("sample",))
