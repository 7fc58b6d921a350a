"""Configuration kinds: what a cell runs, checks and counts.

A configuration's file names its kind under ``"kind"`` (absent: ``mf``).
:func:`heatbench.spec.kind_module` loads ``kinds/<kind>.py`` by path, so a
new kind is one new module here plus files of its own (its plain reference
under ``reference/``, its traffic mixes, its cells' limits, its metric
readers and its work counts), and no file that is already here changes.
The harness (``harness.run_cell``, ``harness.timed_window``,
``calibrate.py``, ``metrics/train.mfu_pct.py``) knows nothing of a kind but
this contract.  A kind module defines:

``NAMES``
    The numbers its check reports.  A cell whose ``limits`` name any other
    is refused before it runs.
``FAULTS``
    The faults that ``calibrate.py --fault NAME:SEEDS`` may plant in the
    kind's reference.
``CONTROL``
    The keywords of :func:`reference_reading` that give the control: the
    reference in the program's place at the nearest precision below the
    configuration's.
``build(cell, seed, dev, clock) -> run``
    The training object of one cell and seed on ``dev``, driven from the
    seed through the first steps that its check follows (each part of the
    set-up timed through ``clock.part(name, fn)``; a part named ``check``
    is left out of ``setup_s``), every shape of the window warmed up.  The
    run has:

    * ``k``: steps a window; ``rows``: samples a step (batch rows for MF,
      sequences for an LM); ``step``: the next step's number;
    * ``window()``: one window of ``k`` steps, read back at its edge;
      returns its host losses, one a step;
    * ``sync()``: waits for the device;
    * ``metric_inputs(start)``: the fields of ``harness.MetricContext``
      beyond the generic ones, for the steps from ``start`` to ``step``
      (``batches``, ``tile_ids``, ``extra``);
    * ``free_program()``: drops the program's state;
    * ``readings()``: ``(values, detail)``, the numbers of ``NAMES``
      against the kind's own plain reference, and what they came from.
``reference_reading(cell, seed, dev, **kw) -> {"values", "detail"}``
    The reference under ``kw`` (``CONTROL``, or ``fault=NAME``) in the
    program's place, against the reference, for ``calibrate.py``.
``model_flops(config, traffic) -> (flops, peak)``
    Model FLOPs of one sample, and the card's peak FLOP/s for the
    configuration's dtype (``train.mfu_pct``).
"""
