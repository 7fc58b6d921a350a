"""``kernel.ccl_roofline`` (%): the least time of the CCL loss's forward
and backward at the cell's (B, n, K), over the summed device time of the
kernels that compute it: #1 ``csrc/ccl_stats.cu`` and #2 ``csrc/ccl_bwd.cu``
(``kernels/ccl_similarity.py``).  The least time is the larger of bytes over
3.35 TB/s and FLOPs over 67 TFLOP/s (``heatbench/work.py``): the distinct
users (with history: the B aggregated user rows, fp32) and positives at the
table's width, at most ``tile_size`` negative rows of the fp32 tile, one
gradient row written for each, and the loss's forward and backward FLOPs.
Unlike the kernel table's bounds, it does not count the (B, n, K) negatives
tensor, so a kernel that reads tile rows directly cannot pass 100%.  It
moves ``train_samples_per_s`` most in the device-bound cells."""
import re

from heatbench import peaks, work

PATTERN = re.compile(r"\bccl_stats_kernel\b|\bccl_bwd_kernel\b")


def read(ctx):
    """Percent of the least time; None when neither kernel ran."""
    seconds = ctx.trace.device_time_s(lambda name: bool(PATTERN.search(name)))
    if seconds <= 0:
        return None
    cfg = ctx.config
    b, n, k = ctx.traffic["batch_size"], cfg["num_negatives"], cfg["emb_dim"]
    width = work.row_bytes(k, cfg["table_format"])
    least = 0.0
    for users, pos, _ in ctx.batches:
        if cfg["history_len"] > 0:
            user_rows, user_width = b, 4 * k
        else:
            user_rows, user_width = int(users.unique().numel()), width
        nbytes = work.ccl_bytes(user_rows, user_width, int(pos.unique().numel()),
                                width, min(cfg["tile_size"], b * n), k)
        least += peaks.least_time_s(nbytes, work.ccl_flops(b, n, k))
    return 100.0 * least / len(ctx.batches) * ctx.steps / seconds
