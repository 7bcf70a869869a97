"""Cross-stage chunk handoff analysis (the merge -> re-split eliminator).

The counterpart of ``src/repro/core/handoff.py``.  Within one stage Mozart
already pipelines cache-sized chunks through the whole chain; at every
stage *boundary*, however, the producer merges its partials into a full
value and the consumer re-splits it: an O(data) round trip per boundary.
This pass walks the planned stages and decides, per producer -> consumer
edge, whether the consumer can ingest the producer's chunk list directly:

* the producer's resolved output split type must ``can_handoff`` the
  consumer's resolved input split type (same concrete geometry and
  iteration axis, ``core/split_types.py``), and
* a node is left unmerged (:class:`~repro_torch.core.stage_exec.ChunkStream`)
  only when EVERY in-plan consumer edge accepts the grid; values that any
  consumer must see whole (broadcast arguments, axis changes) merge as
  before.

Nodes with no in-plan consumer (pure pipeline outputs) stream too: their
merge happens when the ``Future`` is observed, and not at all if it never
is.  Fresh-output (``ConcatSplit``) producers hand off to concrete
``ArraySplit``/``PytreeSplit`` consumers on the same axis: the analysis
records the *permission* (``StageHandoff.convert_in``) and the runtime
derives the grid from the buffers (``stage_exec.adapt_stream``).

Donation points (``last_use``) are vetoed for in-plan producers whose
``Future`` is alive during analysis (``vetoed``); the runtime's
``stage_exec.DONATED_MERGE_ERROR`` stays as the backstop.

Cross-*evaluation* edges (a stage consuming a ``done`` node from an earlier
``evaluate()``) cannot be decided structurally: the ingest is *permitted*
and ``stage_exec.resolve_stage_inputs`` re-checks the concrete stream's
grid at run time.

The analysis is pure and structural (a function of the stage templates
only), so ``plan_cache.lookup_or_plan`` runs it once at plan time and
records the result on the entry (``PlanEntry.handoff``); warm calls replay
it with zero analysis, and ``plan_cache.save/load`` persist it.
Uncacheable pipelines analyze fresh per evaluation.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import split_types as st
from repro_torch.core.graph import NodeRef
from repro_torch.core.planner import Stage


@dataclasses.dataclass(frozen=True)
class StageHandoff:
    """Handoff decisions for one stage (positions, never node/value ids)."""

    #: stage-local node positions whose output stays a ChunkStream.
    stream_out: frozenset
    #: stage input positions permitted to ingest a producer's chunk list.
    stream_in: frozenset
    #: input positions where this stage is the LAST in-plan consumer of the
    #: handed-off stream: its buffers may be given up after this stage
    #: (re-checked against ``future_alive`` at run time).
    last_use: frozenset
    #: input positions permitted to convert a producer's stream onto the
    #: consumer's grid (the ConcatSplit -> {ArraySplit, PytreeSplit} rules,
    #: and every cross-evaluation ingest into such a consumer).
    convert_in: frozenset = frozenset()
    #: input positions permitted to ingest a sharded-form stream; recorded
    #: only for executors that place per-shard buffers ("sharded", "auto");
    #: ``core/sharded.py`` re-checks the concrete mesh and placements per
    #: call.
    shard_in: frozenset = frozenset()
    #: input positions that WOULD be ``last_use`` donation points but were
    #: vetoed because the producer's Future was alive during analysis.
    vetoed: frozenset = frozenset()

    def to_json(self) -> dict:
        return {"stream_out": sorted(self.stream_out),
                "stream_in": sorted(self.stream_in),
                "last_use": sorted(self.last_use),
                "convert_in": sorted(self.convert_in),
                "shard_in": sorted(self.shard_in),
                "vetoed": sorted(self.vetoed)}

    @classmethod
    def from_json(cls, d: dict) -> "StageHandoff":
        return cls(stream_out=frozenset(int(p) for p in d["stream_out"]),
                   stream_in=frozenset(int(p) for p in d["stream_in"]),
                   last_use=frozenset(int(p) for p in d["last_use"]),
                   convert_in=frozenset(int(p) for p in d.get("convert_in", ())),
                   shard_in=frozenset(int(p) for p in d.get("shard_in", ())),
                   vetoed=frozenset(int(p) for p in d.get("vetoed", ())))


def _liveness_stale(ho_map: dict[int, StageHandoff], stages: list[Stage]) -> bool:
    """Whether recorded donation decisions disagree with CURRENT liveness:
    a ``vetoed`` position whose in-plan producer is now dead, or a
    ``last_use`` position whose producer is now alive.  Cross-evaluation
    edges are skipped (their liveness varies per call by design)."""
    nodes = {n.id: n for s in stages for n in s.nodes}
    by_id = {s.id: s for s in stages}
    for sid, ho in ho_map.items():
        s = by_id.get(sid)
        if s is None or not (ho.vetoed or ho.last_use):
            continue
        for i, si in enumerate(s.inputs.values()):
            v = si.value
            if not isinstance(v, NodeRef):
                continue
            n = nodes.get(v.node_id)
            if n is None:
                continue                   # cross-evaluation edge
            if i in ho.vetoed and not n.future_alive():
                return True
            if i in ho.last_use and n.future_alive():
                return True
    return False


def decisions_fresh(ho_map: dict[int, StageHandoff], stages: list[Stage]) -> bool:
    """Whether a recorded decision map still describes ``stages``' current
    Future liveness (the reuse guard for a recorded analysis)."""
    return not _liveness_stale(ho_map, stages)


#: consecutive stale observations before a recorded handoff re-analyzes:
#: one flap is noise (liveness legitimately varies call to call), a
#: persistent disagreement means the plan-time donation vetoes no longer
#: describe this workload.
STALE_THRESHOLD = 2


def resolve_decisions(ctx, entry, stages: list[Stage]):
    """Handoff decisions for one evaluation of ``stages``; None when the
    context has handoff disabled.

    Replays the entry's recorded analysis when present; otherwise analyzes
    fresh and records the result on the entry (rekeyed entries, or entries
    whose decisions the ``MOZART_REANALYZE_EVERY`` tick dropped).  Recorded
    donation decisions AGE: when current Future liveness disagrees with the
    recorded ``vetoed``/``last_use`` sets for ``STALE_THRESHOLD``
    consecutive calls, the plan re-analyzes against this call's liveness
    (counted in ``handoff_reanalyzed``)."""
    if not getattr(ctx, "handoff", True):
        return None
    if entry is not None and entry.handoff is not None:
        if _liveness_stale(entry.handoff, stages):
            entry.ho_age += 1
            if entry.ho_age >= STALE_THRESHOLD:
                with entry._lock:
                    entry.handoff = analyze(stages, getattr(ctx, "executor", None))
                    entry.ho_age = 0
                ctx.stats["handoff_reanalyzed"] += 1
                from repro_torch.core import plan_cache as _pc
                _pc._mark_dirty()
        else:
            entry.ho_age = 0
        return entry.handoff
    ho = analyze(stages, getattr(ctx, "executor", None))
    if entry is not None:
        entry.handoff = ho
    return ho


def _streamable_out(t: st.SplitType, stage_count: int | None) -> bool:
    """Concrete array-like grids stream when the output's count rides the
    stage's iteration grid; ConcatSplit producers emit one piece per range
    by construction, so they stream without a count."""
    if isinstance(t, st.ConcatSplit):
        return True
    if not isinstance(t, (st.ArraySplit, st.PytreeSplit)):
        return False
    info_count = t.shape[t.axis] if isinstance(t, st.ArraySplit) and t.shape \
        else (t.length if isinstance(t, st.PytreeSplit) else None)
    return stage_count is None or info_count == stage_count


def _stage_count(stage: Stage) -> int | None:
    for si in stage.inputs.values():
        t = si.split_type
        if isinstance(t, st.ArraySplit) and t.shape:
            return t.shape[t.axis]
        if isinstance(t, st.PytreeSplit):
            return t.length
    return None


def edge_fallback_reason(pt: st.SplitType, ct: st.SplitType,
                         stage_count: int | None = None) -> str | None:
    """Why a producer -> consumer edge cannot stream, or None when it can:
    the conjunction ``analyze`` tests per edge, decomposed so a caller can
    name the failing conjunct."""
    if not ct.splittable:
        return f"unsplittable consumer type ({type(ct).__name__})"
    if not _streamable_out(pt, stage_count):
        if isinstance(pt, (st.ArraySplit, st.PytreeSplit)):
            return ("producer chunk grid does not ride the stage's "
                    "iteration grid (extent {} vs stage count {})".format(
                        pt.shape[pt.axis] if isinstance(pt, st.ArraySplit)
                        else pt.length, stage_count))
        return f"non-streamable producer type ({type(pt).__name__})"
    if not pt.can_handoff(ct):
        pa = getattr(pt, "axis", None)
        ca = getattr(ct, "axis", None)
        if pa is not None and ca is not None and pa != ca:
            return f"axis mismatch (producer axis {pa}, consumer axis {ca})"
        return f"geometry mismatch ({pt} cannot hand off to {ct})"
    return None


def analyze(stages: list[Stage],
            executor: str | None = None) -> dict[int, StageHandoff]:
    """Per-stage handoff decisions for one planned evaluation; O(edges).
    ``executor`` is the context's executor name: sharded-capable executors
    ("sharded", "auto") also record ``shard_in``."""
    # node id -> (producer stage, position) over this plan
    producer: dict[int, tuple[Stage, int]] = {}
    for s in stages:
        for n in s.nodes:
            producer[n.id] = (s, s.pos[n.id])

    # First pass: every in-plan edge and whether it accepts the grid.
    accepts: dict[int, list[bool]] = {}            # node id -> per-edge verdicts
    edges: dict[tuple[int, int], int] = {}         # (stage id, input pos) -> node id
    done_edges: dict[tuple[int, int], int] = {}    # cross-evaluation ingests
    convert_edges: set[tuple[int, int]] = set()    # ConcatSplit -> ArraySplit
    for s in stages:
        for i, (_key, si) in enumerate(s.inputs.items()):
            v = si.value
            if not isinstance(v, NodeRef):
                continue
            prod = producer.get(v.node_id)
            if prod is None:
                # Cross-evaluation edge: the producer already ran.  Permit
                # the ingest (and a conversion) into a concrete array or
                # pytree grid; the runtime re-checks the stream's type.
                if isinstance(si.split_type, (st.ArraySplit, st.PytreeSplit)):
                    done_edges[(s.id, i)] = v.node_id
                    convert_edges.add((s.id, i))
                continue
            ps, _pos = prod
            if ps.id == s.id:
                continue                           # self-edge: internal value
            pt = ps.out_types[v.node_id]
            ok = edge_fallback_reason(pt, si.split_type, _stage_count(ps)) is None
            accepts.setdefault(v.node_id, []).append(ok)
            if ok:
                edges[(s.id, i)] = v.node_id
                if isinstance(pt, st.ConcatSplit):
                    convert_edges.add((s.id, i))

    # A node streams iff every in-plan consumer edge accepts its grid; pure
    # outputs (no in-plan consumer) stream too: merged only on observation.
    streamed: set[int] = set()
    for s in stages:
        for n in s.nodes:
            if n.id not in s.escaping:
                continue
            if not _streamable_out(s.out_types[n.id], _stage_count(s)):
                continue
            if all(accepts.get(n.id, [])):
                streamed.add(n.id)

    # Plan-time donation veto: an in-plan producer whose Future is alive at
    # analysis time is observable and never gives up its buffers.
    # Cross-evaluation producers are not vetoed: their liveness varies call
    # to call and ``undonatable_stream_keys`` decides per call.
    observable = {n.id for s in stages for n in s.nodes if n.future_alive()}

    # Last pending consumer of each handed-off value (the donation point),
    # and whether that point is vetoed.
    last_consumer: dict[int, tuple[int, int, bool]] = {}
    for (sid, i), nid in list(edges.items()) + list(done_edges.items()):
        if nid in streamed or (sid, i) in done_edges:
            veto = nid in producer and nid in observable
            cur = last_consumer.get(nid)
            if cur is None or sid > cur[0]:
                last_consumer[nid] = (sid, i, veto)

    shard_exec = executor in ("sharded", "auto")

    out: dict[int, StageHandoff] = {}
    for s in stages:
        stream_out = frozenset(s.pos[n.id] for n in s.nodes if n.id in streamed)
        stream_in = frozenset(
            i for (sid, i), nid in edges.items()
            if sid == s.id and nid in streamed
        ) | frozenset(i for (sid, i) in done_edges if sid == s.id)
        last_use = frozenset(
            i for nid, (sid, i, veto) in last_consumer.items()
            if sid == s.id and not veto)
        vetoed = frozenset(
            i for nid, (sid, i, veto) in last_consumer.items()
            if sid == s.id and veto)
        convert_in = frozenset(
            i for (sid, i) in convert_edges
            if sid == s.id and ((sid, i) in done_edges
                                or edges.get((sid, i)) in streamed))
        shard_in = stream_in if shard_exec else frozenset()
        if stream_out or stream_in:
            out[s.id] = StageHandoff(stream_out, stream_in, last_use,
                                     convert_in, shard_in, vetoed)
    return out
