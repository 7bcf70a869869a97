"""Runtime-wide failure domains: fault injection, degradation, retries.

The counterpart of ``src/repro/core/resilience.py``.  The one place the
runtime's failure policy lives; the boundaries it guards call in from
``stage_exec``, ``executor``, ``cost_model``, ``plan_cache``, ``pipeline``
and ``serving``.

1. **Deterministic fault injection.**  ``MOZART_FAULTS=<spec>`` (or
   ``mozart.inject_faults(spec)`` as a context manager) arms failures at
   named boundaries: ``split``, ``chunk`` (drive), ``merge``, ``ingest``
   (stage input resolution), ``compile`` (a driver build or a kernel
   lowering), ``persist`` (plan-cache save) and ``serve_step`` (batcher
   step).  Each armed spec fires a bounded number of times and disarms, so
   the same spec and the same crossing order give the same failures.  Fired
   faults and every recovery action are recorded as MZ4xx events.

2. **Graceful degradation.**  ``run_stage`` is the stage-dispatch wrapper:
   when an executor raises a recoverable error it demotes along
   ``DEGRADE_ORDER`` (``cuda`` -> ``sharded`` -> ``scan`` -> ``fused`` ->
   ``pipelined`` -> ``eager``) until the stage completes, quarantines the broken choice on
   the plan entry (persisted: warm calls and restarted processes skip it)
   and ages the quarantine so the executor is retried after
   ``QUARANTINE_TTL`` dispatches.  Chunk-loop resource exhaustion is handled
   below the ladder: ``core/executor.py`` halves the chunk batch, at most
   ``MAX_OOM_HALVINGS`` times, and re-pins the surviving size.  On a mesh
   of several ranks every rank runs the stage (SPMD): after each attempt
   the ranks compare outcomes (``_run_rung``), and a failure on one rank
   demotes every rank alike, so their collectives stay matched.

3. **Shared error taxonomy.**  ``TRANSIENT_ERRORS`` / ``PROBE_ERRORS``:
   probe and measurement sites (the tuner's samples, ``auto``'s candidate
   timings) catch exactly these classes and count every swallow
   (``stats["swallowed_errors"]``, ``note_swallowed``).  ``with_retries``,
   ``StepTimer`` and ``run_with_restarts`` live here;
   ``repro_torch.runtime.fault`` re-exports them.

**Kernel faults are never recoverable.**  Where the port is narrower than
the reference: the reference counts any ``RuntimeError`` as recoverable,
and in the port every failure to build or launch a hand-written kernel is
one.  Demoting around it would run a stage on ``scan`` or ``fused`` and hide
the kernel.  So a :class:`~repro_torch.kernels.build.KernelError` (``nvcc``
missing or failing, a library that will not load, a failed launch) and a
CUDA error reported after a launch (``torch.AcceleratorError``: the context
is unusable) propagate unchanged: ``_recoverable`` refuses them,
``note_swallowed`` re-raises them (so the tuner and ``auto`` never skip
them) and the retry helpers do not retry them.  On ``cuda`` only what the
reference recovers from and the port can recover from demotes: an injected
fault.  Real resource exhaustion on ``cuda`` (a ``torch.OutOfMemoryError``
from the kernel's wrapper) propagates too: demoting would finish the stage
on plain PyTorch with its tensors on the card, and quarantining would keep
later calls (and, through the persisted plan, restarted processes) off the
kernel.  ``auto`` applies the same rule to its ``cuda`` candidate.

**Sanitizer trips are never recoverable either.**  A
``stage_exec.SanitizerError`` (MZ301-303, ``MOZART_SANITIZE=1``) is an
invariant violation: ``_recoverable`` refuses it first, on every executor
(``auto`` included), as the reference's does.  The port goes one step
further at the probe sites, where the reference counts it as one more
swallowed ``RuntimeError``: ``note_swallowed`` re-raises it, as a kernel
fault, so neither the tuner nor ``auto``'s candidate scoring carries on
past it, and the retry helpers do not retry it.

A failed attempt is re-driven only if it released no stream
(``ctx.stats["streams_released"]``, counted by
``stage_exec.mark_stream_consumed``): torch has no buffer donation, and a
counted donation point (``donated_chunks``) releases nothing until the
stage has consumed its inputs.  The recorded MZ4xx events come back as
``analysis.Diagnostic``s (``events()``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
import threading
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch.kernels.build import KernelError

log = logging.getLogger("repro_torch.resilience")

__all__ = [
    "BOUNDARIES", "DEGRADE_ORDER", "FaultPlan", "FaultSpec", "InjectedFault",
    "InjectedResourceExhausted", "KernelError", "PROBE_ERRORS", "QUARANTINE_TTL",
    "RankFailure",
    "StepFailure", "StepTimer", "FaultConfig", "TRANSIENT_ERRORS",
    "clear_events", "cuda_may_skip", "events", "inject_faults", "is_kernel_fault",
    "is_resource_exhausted", "maybe_fail", "note_swallowed", "record_event",
    "run_stage", "run_with_restarts", "stats", "with_retries",
]


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


class StepFailure(RuntimeError):
    """A training/serving step failed after exhausting its retries."""


class InjectedFault(RuntimeError):
    """A deterministic fault armed by a :class:`FaultPlan` fired."""


class InjectedResourceExhausted(InjectedFault):
    """Injected stand-in for device or host memory exhaustion."""


#: errors a *retry* can plausibly fix: runtime failures (a CUDA
#: ``OutOfMemoryError`` is a RuntimeError), host I/O, memory pressure.
#: Programming errors and control-flow exceptions are not here.
TRANSIENT_ERRORS: tuple = (RuntimeError, OSError, MemoryError)

#: errors a *probe* of one candidate may legitimately raise for "not
#: available on this input": the transient classes plus the shape/dtype
#: rejections a library call makes before doing any work.
PROBE_ERRORS: tuple = TRANSIENT_ERRORS + (
    ValueError, TypeError, ArithmeticError, NotImplementedError)

#: a CUDA error reported after a launch (illegal address, launch failure):
#: the context is unusable, so nothing may re-drive the stage.
_CUDA_ERRORS: tuple = tuple(
    c for c in (getattr(torch, "AcceleratorError", None),) if c is not None)


def is_kernel_fault(e: BaseException) -> bool:
    """Whether ``e`` is a fault of a hand-written kernel or of the card:
    never demoted around, never swallowed, never retried."""
    if isinstance(e, (KernelError, *_CUDA_ERRORS)):
        return True
    return isinstance(e, RuntimeError) and str(e).startswith("CUDA error")


def _never_absorbed(e: BaseException) -> bool:
    """A kernel fault or a boundary-sanitizer trip (MZ3xx): never demoted
    around, never swallowed, never retried."""
    from repro_torch.core.stage_exec import SanitizerError
    return isinstance(e, SanitizerError) or is_kernel_fault(e)


def is_resource_exhausted(e: BaseException) -> bool:
    """Whether ``e`` is memory pressure (halve the chunk batch and retry)
    rather than a generic failure (demote down the executor ladder)."""
    if isinstance(e, (MemoryError, InjectedResourceExhausted,
                      torch.OutOfMemoryError)):
        return True
    msg = str(e)
    return ("RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg
            or "CUDA out of memory" in msg)


#: process-global resilience counters (per-session counts additionally land
#: in ``ctx.stats``).
stats: collections.Counter = collections.Counter()

_stats_lock = threading.Lock()


def note_swallowed(where: str, e: BaseException, ctx=None) -> None:
    """Count a deliberately swallowed probe error so it is observable.  A
    kernel fault or a sanitizer trip is re-raised instead: it is never
    skipped."""
    if _never_absorbed(e):
        raise e
    with _stats_lock:
        stats["swallowed_errors"] += 1
        stats[f"swallowed:{where}"] += 1
    if ctx is not None:
        ctx.stats["swallowed_errors"] += 1
    record_event("MZ406", f"{where}: {type(e).__name__}: {e}",
                 severity="info")


# ---------------------------------------------------------------------------
# Event log (MZ4xx records)
# ---------------------------------------------------------------------------

_EVENT_CAP = 512
_events: collections.deque = collections.deque(maxlen=_EVENT_CAP)


def record_event(code: str, where: str, severity: str = "warning") -> None:
    """Append one MZ4xx record (code, where) to the bounded process log and
    bump its counter.  Records become ``analysis.Diagnostic``s on demand
    (``events()``): this path must not import the verifier."""
    with _stats_lock:
        stats[code] += 1
    _events.append((code, severity, where))


def events() -> list:
    """The recorded MZ4xx events as ``analysis.Diagnostic``s (most recent
    last)."""
    from repro_torch.core.analysis import CODES, Diagnostic
    return [Diagnostic(code, sev, where, CODES.get(code, code))
            for code, sev, where in list(_events)]


def clear_events() -> None:
    """Reset the event log and the resilience counters."""
    _events.clear()
    with _stats_lock:
        stats.clear()


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------

#: the named boundaries ``maybe_fail`` guards, in pipeline order.
BOUNDARIES = ("split", "chunk", "merge", "ingest", "compile", "persist",
              "serve_step")


@dataclasses.dataclass
class FaultSpec:
    """One armed failure: fire ``count`` times at ``boundary`` crossings
    whose ``where`` string contains ``match`` (empty = every crossing),
    after skipping the first ``after`` matching crossings."""

    boundary: str
    kind: str = "fail"                   # "fail" | "oom"
    count: int = 1
    match: str = ""
    after: int = 0

    def __post_init__(self) -> None:
        if self.boundary not in BOUNDARIES:
            raise ValueError(
                f"unknown fault boundary {self.boundary!r}; "
                f"known: {BOUNDARIES}")
        if self.kind not in ("fail", "oom"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """A set of armed :class:`FaultSpec`s.  Firing is a pure function of the
    sequence of boundary crossings: no randomness, so a failing run
    reproduces exactly from its ``MOZART_FAULTS`` value."""

    def __init__(self, specs: list[FaultSpec]):
        self.specs = list(specs)
        self.fired: list[tuple[str, str]] = []      # (boundary, where)
        self._lock = threading.Lock()

    def check(self, boundary: str, where: str) -> None:
        armed = None
        with self._lock:
            for spec in self.specs:
                if spec.boundary != boundary or spec.count <= 0:
                    continue
                if spec.match and spec.match not in where:
                    continue
                if spec.after > 0:
                    spec.after -= 1
                    continue
                spec.count -= 1
                armed = spec
                self.fired.append((boundary, where))
                break
        if armed is None:
            return
        record_event("MZ401", f"{boundary} @ {where} (kind={armed.kind})")
        if armed.kind == "oom":
            raise InjectedResourceExhausted(
                f"injected RESOURCE_EXHAUSTED at {boundary} ({where})")
        raise InjectedFault(f"injected fault at {boundary} ({where})")

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a ``MOZART_FAULTS`` spec: comma-separated
        ``boundary[:kind[:count[:match]]]`` entries, e.g. ``compile:fail:1``,
        ``chunk:oom:2``, ``merge:fail:1:stage 0``; ``+N`` after the count
        skips N matching crossings first (``chunk:fail:1+3``)."""
        specs = []
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            parts = raw.split(":", 3)
            boundary = parts[0]
            kind = parts[1] if len(parts) > 1 and parts[1] else "fail"
            count_s = parts[2] if len(parts) > 2 and parts[2] else "1"
            match = parts[3] if len(parts) > 3 else ""
            after = 0
            if "+" in count_s:
                count_s, after_s = count_s.split("+", 1)
                after = int(after_s)
            specs.append(FaultSpec(boundary, kind, int(count_s or 1),
                                   match, after))
        return cls(specs)


_active_plan: FaultPlan | None = None
_env_spec_seen: str | None = None


def _plan() -> FaultPlan | None:
    """The active plan: an ``inject_faults`` install wins; else
    ``MOZART_FAULTS`` (parsed once per distinct value, so a spent plan stays
    spent)."""
    global _active_plan, _env_spec_seen
    if _active_plan is not None:
        return _active_plan
    spec = os.environ.get("MOZART_FAULTS", "")
    if not spec:
        return None
    if spec != _env_spec_seen:
        _env_spec_seen = spec
        _active_plan = FaultPlan.parse(spec)
    return _active_plan


@contextlib.contextmanager
def inject_faults(spec: "str | FaultPlan"):
    """``mozart.inject_faults("chunk:oom:1")``: arm a fault plan for the
    ``with`` block; yields the plan (``plan.fired`` afterwards).  Nesting
    replaces (the inner plan wins) and restores on exit."""
    global _active_plan
    plan = FaultPlan.parse(spec) if isinstance(spec, str) else spec
    prev = _active_plan
    _active_plan = plan
    try:
        yield plan
    finally:
        _active_plan = prev


def clear_faults() -> None:
    """Disarm everything, including an env-armed plan."""
    global _active_plan, _env_spec_seen
    _active_plan = None
    _env_spec_seen = os.environ.get("MOZART_FAULTS", "")


def maybe_fail(boundary: str, where: str = "") -> None:
    """The boundary hook: a no-op unless a plan is armed."""
    plan = _plan()
    if plan is not None:
        plan.check(boundary, where)


# ---------------------------------------------------------------------------
# The executor degradation ladder
# ---------------------------------------------------------------------------

#: demotion order: after a failure the ladder continues below the failed
#: executor, ending at the un-annotated library baseline: the reference's,
#: ``cuda`` in ``pallas``'s place.  A session without a mesh walks through
#: ``sharded`` (which raises there) to ``scan``, as the reference's does.
DEGRADE_ORDER = ("cuda", "sharded", "scan", "fused", "pipelined", "eager")

#: dispatches a quarantined executor sits out before it is retried
#: (``MOZART_QUARANTINE_TTL``).  Read at every dispatch, so a caller may set
#: the module attribute.
QUARANTINE_TTL = int(os.environ.get("MOZART_QUARANTINE_TTL", "32"))

#: bounded halvings of the chunk batch on resource exhaustion before the
#: failure propagates to the ladder.
MAX_OOM_HALVINGS = 4


def demotion_ladder(name: str) -> list[str]:
    """Executors to try, in order, after ``name`` failed.  Unknown names
    (custom registrations, ``auto``) restart from the top minus the failed
    name; known names continue strictly downward."""
    if name in DEGRADE_ORDER:
        i = DEGRADE_ORDER.index(name)
        return list(DEGRADE_ORDER[i + 1:])
    return [n for n in DEGRADE_ORDER if n != name]


def run_stage(name: str, stage, graph, ctx, _tick: bool = True) -> None:
    """Dispatch one stage with the degradation ladder armed.

    On a recoverable failure the stage is re-driven by the next executor
    down ``DEGRADE_ORDER`` and the broken choice is quarantined on the plan
    entry.  Unrecoverable errors (kernel faults, programming errors, an
    attempt that released a stream) propagate unchanged.  ``_tick=False``
    (``auto``'s delegate) reads the quarantine without ageing it again."""
    entry = getattr(ctx, "_plan_entry", None)
    blocked: set = set()
    if entry is not None:
        blocked = (entry.tick_quarantine(stage.id, QUARANTINE_TTL)
                   if _tick else entry.quarantined_execs(stage.id))

    first = name
    if name in blocked:
        for alt in demotion_ladder(name):
            if alt not in blocked:
                first = alt
                break
        ctx.stats["exec_quarantine_skips"] += 1
        record_event("MZ404", f"stage {stage.id}: {name} quarantined, "
                              f"dispatching {first}", severity="info")

    group = None
    if first != "auto":                  # auto's delegate agrees in its own ladder
        from repro_torch.core.sharded import mesh_group
        group = mesh_group(ctx)
    last = _run_rung(first, stage, graph, ctx, group)
    if last is None:
        return

    failed = first
    for alt in demotion_ladder(first):
        if alt in blocked:
            continue
        if entry is not None:
            entry.quarantine_exec(stage.id, failed)
            record_event("MZ404", f"stage {stage.id}: quarantined {failed} "
                                  f"({type(last).__name__}: {last})")
        ctx.stats["exec_demotions"] += 1
        ctx.stats[f"exec_demoted_to_{alt}"] += 1
        record_event("MZ402", f"stage {stage.id}: {failed} -> {alt} "
                              f"({type(last).__name__})")
        log.warning("stage %s: executor %s failed (%s); demoting to %s",
                    stage.id, failed, last, alt)
        last = _run_rung(alt, stage, graph, ctx, group)
        if last is None:
            return
        failed = alt
    raise last


class RankFailure(RuntimeError):
    """A stage attempt that failed on another rank of the mesh: this rank
    demotes with it, or raises with it where the failure cannot be
    recovered from."""


def _run_rung(name: str, stage, graph, ctx, group) -> BaseException | None:
    """One attempt of ``stage`` on ``name``: None when it ran, the error
    when it failed and may be re-driven by the next rung; raises what may
    not.  With ``group`` (a mesh of several ranks) the ranks first compare
    outcomes: the attempt stands only where it ran on every rank, and if
    any rank cannot go on (an unrecoverable error, or a stream released by
    an attempt that must now be re-driven) every rank raises."""
    from repro_torch.core.stage_exec import get_executor
    released = ctx.stats.get("streams_released", 0)
    err, fatal = None, False
    try:
        get_executor(name).run(stage, graph, ctx)
    except PROBE_ERRORS as e:
        if name == "auto":
            raise                        # auto's delegate dispatch ran the ladder
        err, fatal = e, not _recoverable(e, ctx, released, name)
        if fatal and group is None:
            raise
    if group is None:
        return err
    from repro_torch.core.sharded import agree
    moved = ctx.stats.get("streams_released", 0) != released
    states = agree(group, (err is not None, fatal, moved))
    failed_on = [r for r, (failed, _f, _m) in enumerate(states) if failed]
    if not failed_on:
        return None
    if any(f or (m and not failed) for failed, f, m in states):
        if fatal:
            raise err
        raise RankFailure(f"stage {stage.id}: {name} failed on group rank(s) "
                          f"{failed_on} and cannot be re-driven") from err
    return err or RankFailure(f"stage {stage.id}: {name} failed on group rank(s) "
                              f"{failed_on}")


def _recoverable(e: BaseException, ctx, released_before: int,
                 executor: str | None = None) -> bool:
    """Whether a failed attempt on ``executor`` may be re-driven by another.

    Never for a sanitizer trip (an invariant violation) or a kernel fault;
    never for an attempt that released a stream's buffers (re-reading them
    would fail); on ``cuda`` only for an injected fault (see
    :func:`cuda_may_skip`)."""
    if _never_absorbed(e):
        return False
    if ctx.stats.get("streams_released", 0) != released_before:
        return False
    if executor == "cuda":
        return cuda_may_skip(e)
    return True


def cuda_may_skip(e: BaseException) -> bool:
    """Whether a failure of the ``cuda`` executor may be routed around (by
    the ladder, or by ``auto`` leaving the candidate unscored): only an
    injected fault.  Anything else, real memory exhaustion included,
    propagates, so a stage on the card never finishes on plain PyTorch."""
    return isinstance(e, InjectedFault)


# ---------------------------------------------------------------------------
# Step-level fault tolerance (``repro_torch.runtime.fault`` re-exports these)
# ---------------------------------------------------------------------------


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
                with _stats_lock:
                    stats["stragglers"] += 1
                log.warning("step %d took %.3fs (median %.3fs): straggler",
                            step, seconds, med)
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
        self.times.append(seconds)
        return is_straggler


def with_retries(fn: Callable[[], Any], *, retries: int,
                 on_retry: Callable[[int, Exception], None] | None = None,
                 backoff_s: float = 0.0,
                 agree: Callable[[str], list[str]] | None = None) -> Any:
    """Run ``fn``; retry the transient classes with exponential backoff.
    Non-transient errors, kernel faults and sanitizer trips propagate
    immediately.

    ``agree``, for SPMD ranks whose ``fn`` makes collectives (ZeRO-1
    training, ``launch/train.py``): called after every attempt with this
    rank's outcome (``"ok"``, ``"retry"`` or ``"fatal"``), it returns every
    rank's (``core.sharded.agree``).  The ranks then return, retry or raise
    together: a rank that retried alone would wait on collectives the
    others never make.  ``fn`` must leave no state changed when it raises
    (the caller commits after), and a fault is recoverable where it
    surfaces after the attempt's last collective."""
    last: Exception | None = None
    for attempt in range(retries + 1):
        if agree is not None:
            outcome, result, err = _attempt(fn)
            outcomes = agree(outcome)
            if "fatal" in outcomes:
                if err is not None and outcome == "fatal":
                    raise err
                raise StepFailure(f"rank {outcomes.index('fatal')} failed: not retried")
            if all(o == "ok" for o in outcomes):
                return result
            e = err or StepFailure(f"ranks {[r for r, o in enumerate(outcomes) if o != 'ok']} "
                                   f"failed attempt {attempt}")
        else:
            try:
                return fn()
            except TRANSIENT_ERRORS as exc:
                if _never_absorbed(exc):
                    raise
                e = exc
        last = e
        with _stats_lock:
            stats["step_retries"] += 1
        log.warning("step attempt %d failed: %s", attempt, e)
        if on_retry:
            on_retry(attempt, e)
        _release_frames(e)
        del e
        if backoff_s and attempt < retries:
            time.sleep(backoff_s * (2 ** attempt))
    raise StepFailure(f"exhausted {retries} retries") from last


def _release_frames(e: BaseException) -> None:
    """Clear the locals of the frames a failed attempt's exception holds
    (ROADMAP C15): its traceback keeps the attempt's frames, and with them
    its tensors (activations, the autograd graph, gradients), alive into
    the retry, which on a full card fails for want of that memory.  The
    exception keeps its type, message and line numbers for the chained
    ``StepFailure``; so do the exceptions chained to it."""
    seen: set[int] = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        traceback.clear_frames(e.__traceback__)
        e = e.__cause__ or e.__context__


def _attempt(fn: Callable[[], Any]) -> tuple[str, Any, BaseException | None]:
    """One attempt of ``fn`` for ``with_retries(agree=...)``: ``(outcome,
    result, error)``.  Every failure is caught so that this rank still
    takes part in the agreement; the caller re-raises it."""
    try:
        return "ok", fn(), None
    except TRANSIENT_ERRORS as e:
        return ("fatal" if _never_absorbed(e) else "retry"), None, e
    except Exception as e:             # re-raised after the ranks agree
        return "fatal", None, e


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
        # The failed run's exception is gone with its ``except`` block; its
        # state is released here, before the next one is built (C15).
        state = None
        state, start = make_state(latest_step())
        try:
            return run_from(state, start)
        except TRANSIENT_ERRORS as e:       # restart boundary
            if _never_absorbed(e):
                raise
            restarts += 1
            with _stats_lock:
                stats["restarts"] += 1
            log.error("run crashed at restart %d: %s", restarts, e)
            if restarts > fault_cfg.max_restarts:
                raise
            time.sleep(min(fault_cfg.backoff_s * (2 ** restarts), 2.0)
                       if fault_cfg.backoff_s else 0.1)
