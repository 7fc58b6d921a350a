"""``device.idle_in_step_pct`` (%): the share of the traced stretch's wall
time made of idle gaps between device operations whose middles fall inside
one of the program's ``step`` spans (mapped onto the trace's clock by
``heatbench/spans.py``).  The rest of ``device.idle_pct`` lies between
steps: at window edges, where the losses are read back, and at the
stretch's ends.  Layer: the device.  It moves ``train_samples_per_s`` most
where the host sets the pace."""
from heatbench import spans


def read(ctx):
    """Percent of the stretch; None when the program recorded no span or
    the trace's launches and operations differ in number."""
    joined = spans.join(ctx.trace)
    if joined is None:
        return None
    return 100.0 * spans.idle_in_steps_s(joined) / ctx.trace.window_s
