"""``train.mfu_pct`` (%): model FLOPs a second over the H100's 67 TFLOP/s
fp32 peak off the tensor cores (both configurations compute in fp32; the
run reports the card's power limit beside it).  Model FLOPs come from the
cell's shapes (``heatbench/work.py::step_model_flops``: the CCL's dots and
norms, and with history the average and the (K, K) aggregator product, each
forward and backward once); the rate is the untraced window's
``train_samples_per_s``, so the tracer's cost is not in it.  Layer: the
whole step; it bounds a gain claimed after a later change takes a kernel
off the path."""
from heatbench import peaks, work


def read(ctx):
    """Percent of peak; None when the window finished no step."""
    if ctx.samples_per_s <= 0:
        return None
    cfg, b = ctx.config, ctx.traffic["batch_size"]
    flops = work.step_model_flops(b, cfg["num_negatives"], cfg["emb_dim"],
                                  cfg["history_len"])
    return 100.0 * flops / b * ctx.samples_per_s / peaks.FP32_FLOP_PER_S
