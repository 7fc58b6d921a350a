"""``device.idle_pct`` (%): the share of the traced stretch's wall time,
between a device sync on each side, in which no kernel, copy or set runs on
the device, from the trace's own device timeline (only the device's
activity is traced).  Layer: the device.  It moves ``train_samples_per_s``
most where the host sets the pace."""


def read(ctx):
    """Idle percent; None when the trace saw no device operation."""
    if not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
