"""Compatibility shim: the step-level fault-tolerance helpers live in the
runtime-wide resilience layer (``repro_torch.core.resilience``), where they
share one transient-error taxonomy and backoff policy with the executor
degradation ladder, as ``src/repro/runtime/fault.py`` re-exports the
reference's.  This module re-exports the names its callers use
(``launch/train.py``)."""

from __future__ import annotations

from repro_torch.core.resilience import (  # noqa: F401
    FaultConfig,
    StepFailure,
    StepTimer,
    TRANSIENT_ERRORS,
    run_with_restarts,
    with_retries,
)

__all__ = ["FaultConfig", "StepFailure", "StepTimer", "TRANSIENT_ERRORS",
           "run_with_restarts", "with_retries"]
