"""``train.mfu_pct`` (%): model FLOPs a second over the card's peak for the
configuration's dtype, both from the cell's kind (``model_flops(config,
traffic)``: model FLOPs of one sample and the peak; ``mf``: the CCL's dots
and norms, and with history the average and the (K, K) aggregator product,
each forward and backward once, over the H100's 67 TFLOP/s fp32 peak off the
tensor cores; the run reports the card's power limit beside it).  The rate
is the untraced window's ``train_samples_per_s``, so the tracer's cost is
not in it.  Layer: the whole step; it bounds a gain claimed after a later
change takes a kernel off the path."""
from heatbench import spec


def read(ctx):
    """Percent of peak; None when the window finished no step or the run
    was not on the card (the trace saw no device operation)."""
    if ctx.samples_per_s <= 0 or not ctx.trace.ops:
        return None
    kind = ctx.kind or spec.kind_module(ctx.config.get("kind", "mf"))
    flops, peak = kind.model_flops(ctx.config, ctx.traffic)
    return 100.0 * flops * ctx.samples_per_s / peak
