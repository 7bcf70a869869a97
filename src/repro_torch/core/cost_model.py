"""Cost-model-driven executor auto-selection (``executor="auto"``).

The counterpart of ``src/repro/core/cost_model.py``.  The paper's Mozart
commits to ONE execution strategy per session; this module scores every
registered ``StageExecutor`` per stage and dispatches each stage to the
cheapest:

1. **Analytic prior.**  ``analytic_seconds`` combines the stage's runtime
   features (element count, per-element bytes, chain length, the SA's
   arithmetic-intensity hint) with chip constants (``hardware.Chip``: memory
   bandwidth, peak FLOPs, per-dispatch overhead blended with the device's
   measured dispatch) into an estimated wall time per strategy: eager pays
   one memory round trip per *function*, chunked drivers one dispatch per
   chunk (x chain length when not fused), scan one driver call, ``cuda``
   one kernel launch on the card.  Off the card the ``cuda`` executor runs
   the kernel's plain version, so it takes the penalty the reference gives
   interpreted Pallas and ``auto`` never picks it there.  ``sharded``
   divides the stream over the mesh's data extent (infinite without a mesh
   or when the extent does not divide the element count).

2. **Measured feedback.**  On the first execution of a *cached* plan the
   ``AutoExecutor`` times one bounded sample, the same size for every
   viable candidate (``StageExecutor.sampled_time``), times the ones within
   ``_CONFIRM_RATIO`` of the fastest again and keeps each one's fastest
   run, records the extrapolated seconds into
   the plan-cache entry (``PlanEntry.exec_timings``) and pins the winner
   (``PlanEntry.chosen_exec``).  Fresh measurements overwrite recorded
   timings.  Pinned choices persist across processes
   (``plan_cache.save/load``).

Selection is deterministic: candidates are scored in a fixed preference
order and ties keep the earlier candidate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import hardware
from repro_torch.core import resilience
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.planner import Stage
from repro_torch.core.sharded import agree, mesh_group
from repro_torch.core.stage_exec import (
    StageExecutor,
    get_executor,
    has_dynamic,
    materialize_inputs,
    register_executor,
    resolve_stage_inputs,
    stage_elem_bytes,
    stage_num_elements,
)

#: fixed preference order = deterministic tie-break: on equal estimated cost
#: the strategy with fewer moving parts wins (the reference's, ``cuda`` in
#: ``pallas``'s place).
CANDIDATE_ORDER = ("scan", "fused", "pipelined", "cuda", "sharded", "eager")

#: off the card ``cuda`` runs the kernel's plain version, op by op over the
#: whole value: keep it out of the measurement candidates too.
_INTERPRET_PENALTY_S_PER_ELEM = 1e-4

#: measure only candidates whose analytic estimate is within this factor of
#: the best candidate's.
_MEASURE_RATIO = 50.0

#: re-time the measured candidates within this factor of the fastest
#: ``_CONFIRM_RUNS`` more times each, keeping each one's fastest run.
_CONFIRM_RATIO = 10.0
_CONFIRM_RUNS = 2

#: FLOPs one unit of SA ``cost_hint`` stands for (one elementwise op).
_FLOPS_PER_HINT = 8.0


@dataclasses.dataclass(frozen=True)
class StageFeatures:
    """Everything the cost model knows about one stage at dispatch time."""

    n: int                     # splittable element count
    elem_bytes: int            # Σ bytes per element over live pipeline values
    n_nodes: int               # chain length
    flops_per_elem: float      # arithmetic-intensity proxy from SA cost hints
    dynamic: bool              # chain contains dynamic-shape fns
    cuda_eligible: bool        # stage lowers onto the split-pipeline kernel
    on_cuda: bool              # the session runs on the card
    mesh_devices: int = 0      # data-mesh extent (0: no mesh configured)


def features_of(stage: Stage, concrete: dict[tuple, Any], ctx) -> StageFeatures:
    from repro_torch.core.cuda_exec import _eligible as cuda_eligible
    from repro_torch.core.sharded import mesh_extent
    n = stage_num_elements(stage, concrete, ctx.pedantic)
    return StageFeatures(
        n=n,
        elem_bytes=stage_elem_bytes(stage, concrete, n),
        n_nodes=len(stage.nodes),
        flops_per_elem=stage.flops_hint() * _FLOPS_PER_HINT,
        dynamic=has_dynamic(stage),
        cuda_eligible=n > 0 and cuda_eligible(stage, concrete),
        on_cuda=ctx.device.type == "cuda",
        mesh_devices=mesh_extent(ctx) if getattr(ctx, "mesh", None) is not None else 0,
    )


def analytic_seconds(name: str, f: StageFeatures, chip: hardware.Chip,
                     device: torch.device | str = "cpu") -> float:
    """Estimated stage wall time under ``name``; ``inf`` = not applicable.

    Only the *relative* ordering matters; the absolute scale is the roofline
    ``bytes/bandwidth`` + ``flops/peak`` plus dispatch overheads, the latter
    blended with the measured dispatch on ``device``."""
    total_bytes = max(f.n, 1) * f.elem_bytes
    bw = chip.hbm_bandwidth
    compute = f.n * f.flops_per_elem / chip.peak_bf16_flops
    dispatch = hardware.effective_dispatch_overhead_s(chip, device)
    est_batch = hardware.mozart_batch_elements(f.elem_bytes, chip)
    chunks = max(1, math.ceil(max(f.n, 1) / max(est_batch, 1)))
    stream = max(total_bytes / bw, compute)

    if name == "eager":
        # every function round-trips its full operands through slow memory
        return f.n_nodes * (total_bytes / bw) + f.n_nodes * dispatch
    if f.dynamic and name != "pipelined":
        return math.inf                  # dynamic chains run call by call
    if name == "pipelined":
        # chunks stay cache-resident between functions, but every function of
        # every chunk is a separate black-box dispatch
        return stream + chunks * f.n_nodes * dispatch
    if name == "fused":
        return stream + chunks * dispatch
    if name == "scan":
        # one driver call over the whole chunk carry
        return stream + dispatch
    if name == "cuda":
        if not f.cuda_eligible:
            return math.inf
        if not f.on_cuda:
            return f.n * _INTERPRET_PENALTY_S_PER_ELEM + dispatch
        return stream + dispatch
    if name == "sharded":
        if f.mesh_devices < 1 or f.n % max(f.mesh_devices, 1) != 0:
            return math.inf
        return stream / f.mesh_devices + 2 * dispatch
    return math.inf                      # strategies the model cannot score


def candidates(f: StageFeatures, ctx,
               blocked: "set | frozenset" = frozenset()) -> list[str]:
    """Applicable executors in deterministic preference order.  ``blocked``
    removes quarantined names (the degradation ladder,
    ``core/resilience.py``) unless that would leave nothing: a wrong answer
    is never an option, a retried crash is recoverable."""
    out = []
    for name in CANDIDATE_ORDER:
        if math.isfinite(analytic_seconds(name, f, ctx.chip, ctx.device)):
            out.append(name)
    if blocked:
        unblocked = [n for n in out if n not in blocked]
        if unblocked:
            out = unblocked
    return out or ["pipelined"]


def choose(f: StageFeatures, ctx, timings: dict[str, float] | None = None,
           blocked: "set | frozenset" = frozenset()) -> str:
    """Pick the cheapest applicable executor.

    Measured seconds (plan-cache feedback) are authoritative: when any
    applicable candidate has a recorded timing, the choice is the fastest
    *measured* one.  Candidates are scanned in fixed order with strict
    improvement, so the choice is a pure function of (features, chip,
    device, recorded timings)."""
    cands = candidates(f, ctx, blocked)
    if timings:
        best, best_s = None, math.inf
        for name in cands:
            if name in timings and timings[name] < best_s:
                best, best_s = name, timings[name]
        if best is not None:
            return best
    best, best_s = None, math.inf
    for name in cands:
        s = analytic_seconds(name, f, ctx.chip, ctx.device)
        if s < best_s:
            best, best_s = name, s
    return best or "pipelined"


@register_executor("auto")
class AutoExecutor(StageExecutor):
    """Per-stage dispatch: score, (optionally) measure, pin, delegate.

    The session-level ``executor="auto"`` resolves to a concrete strategy
    for every stage independently.  Decisions are pinned into the
    plan-cache entry, so later hits (and restarted processes, through
    ``plan_cache.save/load``) replay them with zero extra work."""

    tunable = False              # the delegate's own tuner handles batch size

    def run(self, stage: Stage, graph: DataflowGraph, ctx) -> None:
        # Streams pass through for scoring (features read types and avals);
        # the delegate's own run() re-resolves with its capability and owns
        # the ingest/materialize stats (tally=False here).
        # shard_ok too: a sharded-form stream is not gathered just to score
        # the stage; the delegate decides.
        concrete = resolve_stage_inputs(stage, graph, ctx, streams_ok=True,
                                        tally=False, shard_ok=True)
        entry = getattr(ctx, "_plan_entry", None)
        # Quarantined executors (the degradation ladder) sit out selection;
        # read-only here: run_stage already aged the quarantine this dispatch.
        blocked = (entry.quarantined_execs(stage.id)
                   if entry is not None else set())
        name = entry.chosen_exec.get(stage.id) if entry is not None else None
        if name is not None and name in blocked:
            # A pinned choice that later failed: skip it (the pin stays, and
            # warm calls replay it again once the quarantine ages out).
            ctx.stats["auto_quarantine_skips"] += 1
            name = None
        elif name is not None and self._recheck_due(stage, concrete, ctx, entry):
            name = None              # periodic re-analysis: pin drifted
        elif name is not None and self._aged_out(stage, concrete, ctx, entry):
            name = None              # shape drift past a crossover: re-measure
        if name is not None:
            plan = ("replay", name)
        elif (entry is not None and entry.hits > 0
                and getattr(ctx, "autotune", True)
                and not has_dynamic(stage)
                and entry.try_claim_exec(stage.id)):
            plan = ("measure", None)
        else:
            feats = features_of(stage, concrete, ctx)
            timings = entry.exec_timings.get(stage.id) if entry is not None else None
            plan = ("choose", choose(feats, ctx, timings, blocked))
        group = mesh_group(ctx)
        if group is not None:
            # SPMD: every rank of the mesh must run the stage on the same
            # executor, or their collectives no longer match.  The analytic
            # model reads each process's measured dispatch, so the first
            # rank's decision stands (the ladder keeps the quarantines
            # equal on every rank).
            lead = tuple(agree(group, plan)[0])
            if lead != plan:
                ctx.stats["auto_mesh_overrides"] += 1
                if plan[0] == "measure":
                    entry.release_exec(stage.id)
                elif lead[0] == "measure":
                    entry.try_claim_exec(stage.id)
                plan = lead
        kind, name = plan
        if kind == "replay":
            ctx.stats["auto_pinned_replays"] += 1
        elif kind == "measure":
            concrete = materialize_inputs(stage, concrete, ctx)
            name = self._measure_and_pin(stage, concrete, ctx, entry, blocked, group)
        ctx.stats["auto_stages"] += 1
        ctx.stats[f"auto_pick_{name}"] += 1
        if ctx.log:
            print(f"[mozart] stage {stage.id}: auto -> {name}")
        # Delegate through the degradation ladder (no re-tick: this dispatch
        # already aged the quarantine at the outer run_stage).
        resilience.run_stage(name, stage, graph, ctx, _tick=False)

    def _aged_out(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                  entry) -> bool:
        """Re-measurement aging: a pinned choice recorded its measurement-time
        shape bucket (``PlanEntry.exec_meta``); when a warm call's element
        count has drifted to another power-of-two bucket AND the analytic
        model's ranking flips between the two sizes, the pin is dropped and
        the next execution re-measures."""
        meta = entry.exec_meta.get(stage.id) if entry is not None else None
        if not meta:
            return False                      # no recorded regime
        n = stage_num_elements(stage, concrete, ctx.pedantic)
        if int(n).bit_length() == meta["bucket"]:
            return False                      # same shape regime: replay
        feats_now = features_of(stage, concrete, ctx)
        if not drifted_past_crossover(feats_now, meta, ctx):
            # drifted, but the model ranks the same winner at both sizes:
            # refresh the recorded regime and keep replaying the pin
            entry.pin_exec(stage.id, entry.chosen_exec[stage.id], n=n)
            return False
        if not (getattr(ctx, "autotune", True) and not has_dynamic(stage)):
            return False                      # cannot re-measure here
        entry.unpin_exec(stage.id)
        ctx.stats["auto_repinned_drift"] += 1
        return True

    def _recheck_due(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                     entry) -> bool:
        """Periodic re-analysis (``MOZART_REANALYZE_EVERY``): the tick in
        ``plan_cache._maybe_reanalyze`` flags every stage for one drift
        re-check, consumed here; the pin is dropped only when the analytic
        winner flipped between the measured and current shapes."""
        if entry is None:
            return False
        with entry._lock:
            due = stage.id in entry.recheck_stages
            entry.recheck_stages.discard(stage.id)
        if not due:
            return False
        meta = entry.exec_meta.get(stage.id)
        if not meta:
            return False
        feats_now = features_of(stage, concrete, ctx)
        if not drifted_past_crossover(feats_now, meta, ctx):
            return False                      # pin still justified: replay it
        entry.unpin_exec(stage.id)
        ctx.stats["auto_repinned_periodic"] += 1
        return True

    def _measure_and_pin(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                         entry, blocked: "set | frozenset" = frozenset(),
                         group=None) -> str:
        """Time a bounded sample under each viable candidate (those within
        ``_CONFIRM_RATIO`` of the fastest ``_CONFIRM_RUNS`` more times,
        keeping each one's fastest run), record the extrapolated seconds
        (overwriting stale values) and pin the measured winner.  Quarantined candidates are neither measured nor pinned; a
        candidate that fails its sample stays unscored, counted
        (``note_swallowed``), unless the failure is a kernel fault or a
        failure of the ``cuda`` candidate other than an injected fault
        (``resilience.cuda_may_skip``), which propagate.  With ``group`` (a
        mesh of several ranks) every rank samples the first rank's
        candidates, and a candidate's seconds are its slowest rank's, kept
        only where every rank timed it: every rank pins the same winner."""
        pinned = False
        try:
            feats = features_of(stage, concrete, ctx)
            cands = candidates(feats, ctx, blocked)
            scores = {c: analytic_seconds(c, feats, ctx.chip, ctx.device) for c in cands}
            floor = min(scores.values())
            cands = [c for c in cands
                     if scores[c] <= floor * _MEASURE_RATIO] or cands[:1]
            if group is not None:
                cands = agree(group, cands)[0]
            if feats.n == 0 or len(cands) == 1:
                entry.pin_exec(stage.id, cands[0], n=feats.n)
                pinned = True
                return cands[0]
            n = feats.n
            runs = []
            for c in cands:
                d = get_executor(c)
                batch = d.choose_batch(stage, concrete, ctx, n)
                runs.append((c, d, batch, d.sample_elems(stage, concrete, ctx, batch, n)))
            # One sample size for every candidate: the largest any of them
            # asks for (``cuda``'s whole-launch floor), so a whole-value
            # strategy's fixed cost is not extrapolated from a smaller sample.
            elems = max(s for _c, _d, _b, s in runs)
            if group is not None:
                elems = agree(group, elems)[0]

            def timed(which):
                got = {}
                for c, d, batch, _s in runs:
                    if c not in which:
                        continue
                    try:
                        got[c] = d.sampled_time(stage, concrete, ctx, batch, n, elems)
                    except resilience.PROBE_ERRORS as e:
                        if c == "cuda" and not resilience.cuda_may_skip(e):
                            raise
                        resilience.note_swallowed("auto_measure", e, ctx)
                if group is not None:
                    every = agree(group, got)
                    got = {c: max(r[c] for r in every) for c in got
                           if all(c in r for r in every)}
                return got

            fresh = timed({c for c, *_ in runs})
            # One timed run on the host clock can be stretched by a stall of
            # the host: re-time the contenders and keep each one's fastest run.
            if fresh:
                best = min(fresh.values())
                close = {c for c, s in fresh.items() if s <= best * _CONFIRM_RATIO}
                for _r in range(_CONFIRM_RUNS):
                    for c, s in timed(close).items():
                        fresh[c] = min(fresh[c], s)
            for c, secs in fresh.items():
                entry.record_exec_timing(stage.id, c, secs)
            measured = entry.exec_timings.get(stage.id, {})
            name = choose(feats, ctx, measured, blocked)
            if group is not None:
                name = agree(group, name)[0]
            entry.pin_exec(stage.id, name, n=feats.n)
            pinned = True
            ctx.stats["auto_measured_stages"] += 1
            return name
        finally:
            if not pinned:
                entry.release_exec(stage.id)


def drifted_past_crossover(feats_now: StageFeatures, meta: dict, ctx) -> bool:
    """True when the analytic model's winner differs between the shape a
    pinned executor choice was measured at (``meta["n"]``) and the shape a
    warm call sees now: the drift crossed a cost-model crossover."""
    feats_then = dataclasses.replace(feats_now, n=int(meta["n"]))
    return choose(feats_now, ctx) != choose(feats_then, ctx)
