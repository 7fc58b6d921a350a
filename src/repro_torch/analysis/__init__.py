"""Runtime sanitizers of the port (the port of ``src/repro/analysis``):
:mod:`repro_torch.analysis.sanitize` — the :func:`sanitize` guards (hidden
readbacks, rank promotion, NaNs), call-shape budgets and in-place reuse of
the carried state.  The reference's static pass (``analysis/rules.py``) is
not ported: ``tools/heatlint.py`` lints the port's sources with it.
"""
from repro_torch.analysis.sanitize import (  # noqa: F401
    DonationError,
    DonationReport,
    RetraceError,
    Sanitizer,
    TraceCounter,
    TransferError,
    assert_donation,
    donation_report,
    sanitize,
    trace_counter,
)
