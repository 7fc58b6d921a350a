"""``step.host_us`` (us/step): host microseconds a step inside the
program's ``step`` spans and outside every CUDA runtime or driver call of
the trace: the step's own Python and dispatch, which CUDA graphs or fewer
launches would cut (a launch that waits on a full queue is a CUDA call, so
it does not count).  Spans are mapped onto the trace's clock by
``heatbench/spans.py``.  Layer: the train loop and step.  It moves
``train_samples_per_s`` most where the host sets the pace."""
from heatbench import spans


def read(ctx):
    """Microseconds a step; None when the program recorded no span or the
    trace's launches and operations differ in number."""
    joined = spans.join(ctx.trace)
    return None if joined is None else spans.host_self_us(joined)
