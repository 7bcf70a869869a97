"""Step-level fault tolerance for the training loop: the counterpart of
``src/repro/runtime/fault.py`` (which re-exports these helpers from the
reference's resilience layer).  Retries with exponential backoff, a
straggler watchdog and a restart loop over the newest complete checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

log = logging.getLogger("repro_torch.fault")

#: errors a *retry* can plausibly fix: runtime failures (a CUDA error or
#: ``torch.cuda.OutOfMemoryError`` is a RuntimeError), host I/O, memory
#: pressure.  Programming errors and control-flow exceptions are not here:
#: retrying those hides bugs.
TRANSIENT_ERRORS: tuple = (RuntimeError, OSError, MemoryError)


class StepFailure(RuntimeError):
    """A training step failed after exhausting its retries."""


@dataclasses.dataclass
class FaultConfig:
    max_retries_per_step: int = 2
    max_restarts: int = 3
    #: straggler watchdog: a step slower than median * factor is flagged
    straggler_factor: float = 3.0
    straggler_window: int = 20
    min_steps_for_baseline: int = 5
    #: base sleep between retries; attempt ``i`` backs off ``base * 2**i``
    backoff_s: float = 0.0


class StepTimer:
    """Rolling per-step wall-clock stats + straggler flagging."""

    def __init__(self, cfg: FaultConfig,
                 on_straggler: Callable[[int, float, float], None] | None = None):
        self.cfg = cfg
        self.times: list[float] = []
        self.stragglers: list[int] = []
        self.on_straggler = on_straggler

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler vs the rolling median."""
        window = self.times[-self.cfg.straggler_window:]
        is_straggler = False
        if len(window) >= self.cfg.min_steps_for_baseline:
            med = sorted(window)[len(window) // 2]
            if seconds > med * self.cfg.straggler_factor:
                is_straggler = True
                self.stragglers.append(step)
                log.warning("step %d took %.3fs (median %.3fs): straggler",
                            step, seconds, med)
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
        self.times.append(seconds)
        return is_straggler


def with_retries(fn: Callable[[], Any], *, retries: int,
                 on_retry: Callable[[int, Exception], None] | None = None,
                 backoff_s: float = 0.0) -> Any:
    """Run ``fn``; retry the transient classes with exponential backoff.
    Non-transient errors propagate immediately."""
    last: Exception | None = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except TRANSIENT_ERRORS as e:
            last = e
            log.warning("step attempt %d failed: %s", attempt, e)
            if on_retry:
                on_retry(attempt, e)
            if backoff_s and attempt < retries:
                time.sleep(backoff_s * (2 ** attempt))
    raise StepFailure(f"exhausted {retries} retries") from last


def run_with_restarts(
    make_state: Callable[[int | None], tuple[Any, int]],
    run_from: Callable[[Any, int], Any],
    *,
    fault_cfg: FaultConfig,
    latest_step: Callable[[], int | None],
):
    """Build state (fresh or from the latest checkpoint) and run; on a
    transient failure rebuild from the newest complete checkpoint and
    continue.  Returns the final result of ``run_from``.

    make_state(step|None) -> (state, start_step)
    run_from(state, start_step) -> result       (raises on fatal error)
    """
    restarts = 0
    while True:
        state, start = make_state(latest_step())
        try:
            return run_from(state, start)
        except TRANSIENT_ERRORS as e:       # restart boundary
            restarts += 1
            log.error("run crashed at restart %d: %s", restarts, e)
            if restarts > fault_cfg.max_restarts:
                raise
            time.sleep(min(fault_cfg.backoff_s * (2 ** restarts), 2.0)
                       if fault_cfg.backoff_s else 0.1)
