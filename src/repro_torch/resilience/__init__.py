"""Self-healing layer (the port of ``src/repro/resilience/``): divergence
guard, stream retry, chaos harness.

Detection and recovery for every fault class the streaming service can hit:
checkpoint corruption (``repro_torch.train.checkpoint`` verify, quarantine
and fallback), numerical divergence (:class:`DivergenceGuard` + rollback
with a salted restart window), transient stream faults
(:class:`RetryingStream` over any
:class:`~repro_torch.stream.sources.InteractionStream`), and degraded
serving (``BatchingRecommender.refresh_from`` keeps the previous snapshot
live).  :mod:`repro_torch.resilience.chaos` drives all four end to end
against a live service on a seeded fault schedule.
"""
from repro_torch.resilience.guard import (DivergenceError, DivergenceGuard,
                                          GuardConfig)
from repro_torch.resilience.streams import (FlakyStream, RetryingStream,
                                            TransientStreamError)

__all__ = [
    "DivergenceError", "DivergenceGuard", "GuardConfig",
    "FlakyStream", "RetryingStream", "TransientStreamError",
]
