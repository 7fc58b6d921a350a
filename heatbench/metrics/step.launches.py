"""``step.launches`` (launches/step): device operations (kernels, copies and
sets) in the traced stretch over its steps, an exact count.  Layer: the
train loop and step (``train/trainer.py::EpochExecutor``,
``core/mf.py::make_scan_body``, ``::heat_train_step``, ``core/engine.py``,
``data/pipeline.py::cf_batch_device``).  It moves ``train_samples_per_s``
most where the host's dispatch sets the pace (batch 1,024)."""


def read(ctx):
    """Device operations a step; None when the trace saw none."""
    if not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.steps
