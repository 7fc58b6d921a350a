"""``kernel.rows_roofline`` (%): the least time of the step's work in the
row kernels, over their device time.  fp32 tables: #6 ``csrc/gather_fma.cu``
(the row update, one launch a table): each distinct row read, its summed
gradient read and the row written.  int8 tables: #5
``csrc/gather_dequant.cu`` (the user, positive and history gathers, one
launch each): each distinct row read at int8 width with its scale and its
fp32 row written once (``kernels/embedding_update.py``).  Least times are
the larger of bytes over 3.35 TB/s and FLOPs over 67 TFLOP/s
(``heatbench/work.py``), distinct rows counted from the traced steps'
batches.  It moves ``train_samples_per_s`` most in the device-bound cells."""
import re

import torch

from heatbench import peaks, work

FP32 = re.compile(r"\bgather_fma_kernel\b")
INT8 = re.compile(r"\bgather_dequant_kernel\b")


def read(ctx):
    """Percent of the least time; None when the kernel did not run."""
    cfg = ctx.config
    int8 = cfg["table_format"] == "int8"
    pattern = INT8 if int8 else FP32
    seconds = ctx.trace.device_time_s(lambda name: bool(pattern.search(name)))
    if seconds <= 0:
        return None
    k = cfg["emb_dim"]
    least = 0.0
    for users, pos, hist in ctx.batches:
        if int8:
            calls = [users, pos] + ([] if hist is None else [hist.reshape(-1)])
            for ids in calls:
                least += peaks.least_time_s(
                    work.dequant_gather_bytes(int(ids.unique().numel()), k),
                    ids.numel() * k)
        else:
            items = torch.cat([pos, ctx.tile_ids])
            for ids, lanes in ((users, users.numel()),
                               (items, pos.numel() + ctx.tile_ids.numel())):
                rows = int(ids.unique().numel())
                least += peaks.least_time_s(work.update_bytes(rows, k),
                                            (lanes + 2 * rows) * k)
    return 100.0 * least / len(ctx.batches) * ctx.steps / seconds
