"""Static dataflow rewrite pass: optimize the captured graph before planning.

The counterpart of ``src/repro/core/rewrite.py``.  ``plan_cache.lookup_or_plan``
calls :func:`apply` between capture and planning, so the planner, the
handoff analysis and the fingerprint only ever see the rewritten graph, and
warm calls replay it with zero re-analysis.

Four rewrite kinds, each justified by ``cost_model.analytic_seconds`` and
recorded as a :class:`RewriteRecord` (persisted on the plan entry,
``PlanEntry.rewrites``, schema v7):

* **MZ501 dead-stage elimination**: nodes with no in-graph consumer and no
  live ``Future``, applied transitively, are retired before they reach a
  stage.
* **MZ502 common-subexpression sharing**: annotated calls are
  value-numbered (function identity, static values, input value numbers,
  normalized split types, the output's shape and dtype; external tensors by
  identity and by shape, dtype and device type, as the plan-cache
  fingerprint keys them); identical repeats collapse onto one node.  Never
  across distinct split types, distinct captured scalars (``1`` and ``1.0``
  differ), dynamic-shape functions or functions with donation (``mut``)
  hints.
* **MZ503 filter pushdown**: a selective stage (``sa.selective`` names the
  filtered data argument: ``compress``) hoists ahead of an elementwise map
  whose only consumer it is, when the map has one array operand (an
  elementwise map commutes with any row subset), shrinking the map's extent.
* **MZ504 splitting-friendly reassociation**: independent chains whose
  program order interleaves are regrouped when ``planner.simulate_stage_breaks``
  proves strictly fewer stages (stage merges are associative).

Rewrites that almost apply are recorded as **MZ505 declines** with the
failing condition; the periodic re-analysis tick (``MOZART_REANALYZE_EVERY``,
``plan_cache._maybe_reanalyze``) refreshes the records.

The pass is deterministic and idempotent: re-applying it to its own output
is a no-op (retired nodes are ``done`` and leave ``pending``; pushed-down
patterns no longer match; the clustering order is a fixpoint).  The
``Pipeline`` fast-path build relies on this: it re-enters
``lookup_or_plan`` once more when it declines a call.

Its decisions are a pure function of the graph's structure (what the plan
cache fingerprints, plus which nodes have a live Future and which captured
scalars are equal), so ``apply`` also writes a :class:`Script`: the
mutations it made, by position in the unrewritten pending list, and its
records.  The plan cache keeps the script per unrewritten graph and warm
calls :func:`replay` it, which does none of the analysis
(``ctx.stats``: ``rewrite_passes`` counts analyses, ``rewrite_replays``
replays, ``rewrite_simulations`` the planner simulations MZ504 runs).

``records_to_diagnostics`` gives the records as ``analysis.Diagnostic``s:
``mozart.verify`` and ``analysis.rewrite_report`` report a dry run of the
pass so.  ``lint --rewrite-report`` waits for ``launch/lint.py`` (ROADMAP
A10.2).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import re
from typing import Any

from torch.utils import _pytree as pytree

from repro_torch import hardware
from repro_torch.core import split_types as st
from repro_torch.core.graph import DataflowGraph, Node, NodeRef, live_consumers

#: assumed selectivity of a filter whose mask is unknowable statically; the
#: cost-model justification for a pushdown states it explicitly.
ASSUMED_SELECTIVITY = 0.5

#: rewrite kind -> MZ5xx code.
REWRITE_CODES = {
    "dead": "MZ501",
    "cse": "MZ502",
    "pushdown": "MZ503",
    "reassoc": "MZ504",
    "declined": "MZ505",
}


@dataclasses.dataclass(frozen=True)
class RewriteRecord:
    """One applied (or declined) rewrite, with its cost-model justification.
    JSON-stable: persisted verbatim on the plan entry."""

    code: str            # MZ501..MZ505
    kind: str            # "dead" | "cse" | "pushdown" | "reassoc" | "declined"
    subject: str         # e.g. "exp#3" or "exp#3 -> compress#5"
    detail: str          # justification / decline reason
    saved_s: float       # analytic_seconds delta (0.0 for declines)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "RewriteRecord":
        return cls(code=str(d["code"]), kind=str(d["kind"]),
                   subject=str(d["subject"]), detail=str(d["detail"]),
                   saved_s=float(d.get("saved_s", 0.0)))


def records_to_diagnostics(records: list) -> list:
    """RewriteRecords as MZ5xx ``analysis.Diagnostic``s (all info-severity:
    rewrites are optimizations, never gate failures)."""
    from repro_torch.core.analysis import Diagnostic
    out = []
    for r in records:
        msg = r.detail
        if r.kind != "declined" and r.saved_s > 0:
            msg = f"{msg} (est {r.saved_s * 1e6:.1f}us saved)"
        out.append(Diagnostic(r.code, "info", r.subject, msg))
    return out


@dataclasses.dataclass
class RewriteResult:
    pending: list                    # the (possibly reordered) surviving nodes
    records: list                    # [RewriteRecord]

    @property
    def applied(self) -> list:
        return [r for r in self.records if r.kind != "declined"]


@dataclasses.dataclass
class Script:
    """What one ``apply`` did, replayable on another capture of the same
    graph: ``ops`` by position in the unrewritten pending list (``retire``,
    ``merge``, ``hoist``, ``order``, in the pass's order), and the records
    with the node ids (``ids``, by position) they name."""

    ops: list = dataclasses.field(default_factory=list)
    records: list = dataclasses.field(default_factory=list)
    ids: tuple = ()


# ---------------------------------------------------------------------------
# Cost-model justification
# ---------------------------------------------------------------------------


def _nbytes(v: Any) -> int:
    try:
        return sum(st.nbytes_of(l) for l in pytree.tree_leaves(v))
    except (TypeError, ValueError):
        return 0


def _node_cost_features(node: Node, graph: DataflowGraph) -> tuple[int, int]:
    """(element count, bytes per element) of one node's work, from its
    output aval and split type, else its first array-shaped input."""
    n = None
    total = 0
    t = node.out_type
    if isinstance(t, st.ArraySplit) and t.shape:
        n = t.shape[t.axis]
    if node.out_aval is not None:
        total = _nbytes(node.out_aval)
    if n is None or not total:
        for name, v in node.bound.items():
            if name in node.fn.sa.static:
                continue
            src = graph.nodes.get(v.node_id) if isinstance(v, NodeRef) else None
            a = src.out_aval if src is not None else v
            shape = tuple(getattr(a, "shape", ()) or ())
            if not shape:
                continue
            if n is None:
                n = shape[0]
            if not total:
                total = _nbytes(a)
            break
    n = max(int(n) if n is not None else 1, 1)
    elem_bytes = max(total // n, 1) if total else 4
    return n, elem_bytes


def node_seconds(node: Node, graph: DataflowGraph, ctx,
                 n_override: int | None = None) -> float:
    """Analytic wall time of executing ``node`` alone, scored under a fixed
    representative strategy (``fused``; ``pipelined`` for dynamic chains) so
    records are comparable whatever the session's executor."""
    from repro_torch.core import cost_model
    n, elem_bytes = _node_cost_features(node, graph)
    if n_override is not None:
        n = max(int(n_override), 1)
    dynamic = node.out_aval is None or getattr(node.fn.sa, "dynamic", False)
    feats = cost_model.StageFeatures(
        n=n, elem_bytes=elem_bytes, n_nodes=1,
        flops_per_elem=float(getattr(node.fn.sa, "cost_hint", 1.0))
        * cost_model._FLOPS_PER_HINT,
        dynamic=dynamic, cuda_eligible=False, on_cuda=False)
    name = "pipelined" if dynamic else "fused"
    s = cost_model.analytic_seconds(name, feats, ctx.chip, ctx.device)
    return s if math.isfinite(s) else 0.0


# ---------------------------------------------------------------------------
# MZ501: dead-stage elimination
# ---------------------------------------------------------------------------


def _retire(node: Node) -> None:
    """Remove a node from execution: done with no result, it leaves
    ``graph.pending()`` at once and ``graph.prune()`` collects it."""
    node.done = True
    node.result = None
    node.future_ref = None
    node.alias_refs = []


def _eliminate_dead(pending: list, graph: DataflowGraph, ctx,
                    records: list, ops: list) -> list:
    """Transitively retire nodes with no consumer and no live Future."""
    while True:
        cons = live_consumers(pending)
        dead = [n for n in pending
                if not cons.get(n.id) and not n.future_alive()]
        if not dead:
            return pending
        for n in dead:
            saved = node_seconds(n, graph, ctx)
            records.append(RewriteRecord(
                "MZ501", "dead", f"{n.fn.name}#{n.id}",
                "output has no consumer and no live Future; "
                "eliminated before planning", saved))
            ops.append(("retire", n))
            _retire(n)
        pending = [n for n in pending if not n.done]


# ---------------------------------------------------------------------------
# MZ502: common-subexpression sharing
# ---------------------------------------------------------------------------

_HASHABLE_SCALARS = (bool, int, float, complex, str, bytes, type(None))


def _vn_key(node: Node, vn: dict[int, int]) -> tuple | None:
    """Structural value number of one annotated call, or None (never merge).

    Two calls share a key iff they call the SAME function object on the
    same value-numbered inputs with equal static values, equal captured
    scalars (by type and value), identical external tensors and identical
    normalized split types and output shape/dtype."""
    sa = node.fn.sa
    if getattr(sa, "dynamic", False) or node.out_aval is None or sa.mut:
        return None                      # dynamic output / donation hint
    from repro_torch.core.plan_cache import (_aval_fingerprint, _type_fingerprint,
                                             value_fingerprint)
    parts: list = [("fn", id(node.fn))]
    varmap: dict[int, int] = {}
    for name, v in node.bound.items():
        if name in sa.static:
            f = value_fingerprint(v, with_value=True)
            if f is None:
                return None
            parts.append(("static", name, f))
        elif isinstance(v, NodeRef):
            if v.node_id in vn:
                parts.append(("ref", name, vn[v.node_id]))
            else:
                parts.append(("done", name, v.node_id))
        elif isinstance(v, _HASHABLE_SCALARS):
            parts.append(("pyval", name, type(v).__name__, v))
        else:
            # external tensors and containers: identity, plus the shape,
            # dtype and device type the plan cache keys them by
            parts.append(("extid", name, id(v), value_fingerprint(v)))
        if name not in sa.static:
            tf = _type_fingerprint(node.arg_types[name], varmap)
            if tf is None:
                return None
            parts.append(("T", name, tf))
    of = _type_fingerprint(node.out_type, varmap)
    af = _aval_fingerprint(node.out_aval)
    if of is None or af is None:
        return None
    parts.append(("out", of, af))
    return tuple(parts)


def _merge_into(rep: Node, dupe: Node, pending: list) -> None:
    """Redirect every consumer and live Future of ``dupe`` onto ``rep``,
    then retire ``dupe``."""
    for c in pending:
        if c is dupe:
            continue
        for name, v in c.bound.items():
            if isinstance(v, NodeRef) and v.node_id == dupe.id:
                c.bound[name] = NodeRef(rep.id)
    if dupe.future_ref is not None:
        fut = dupe.future_ref()
        if fut is not None:
            fut._node = rep              # observation now reads the shared node
        # while the dupe's Future lives, the shared output stays escaping
        rep.alias_refs = list(rep.alias_refs) + [dupe.future_ref]
    rep.alias_refs = list(rep.alias_refs) + list(dupe.alias_refs)
    dupe.future_ref = None
    dupe.alias_refs = []
    _retire(dupe)


def _share_common(pending: list, graph: DataflowGraph, ctx,
                  records: list, ops: list) -> list:
    vn: dict[int, int] = {}
    table: dict[tuple, Node] = {}
    changed = False
    for n in pending:
        key = _vn_key(n, vn)
        vn[n.id] = n.id
        if key is None:
            continue
        rep = table.get(key)
        if rep is None:
            table[key] = n
            continue
        saved = node_seconds(n, graph, ctx)
        records.append(RewriteRecord(
            "MZ502", "cse", f"{n.fn.name}#{n.id}",
            f"structurally identical to {rep.fn.name}#{rep.id}; "
            "collapsed onto the shared call", saved))
        ops.append(("merge", rep, n))
        _merge_into(rep, n, pending)
        vn[n.id] = rep.id
        changed = True
    if changed:
        pending = [n for n in pending if not n.done]
    return pending


# ---------------------------------------------------------------------------
# MZ503: filter pushdown (selective stage ahead of an elementwise map)
# ---------------------------------------------------------------------------


def _is_scalarish(v: Any) -> bool:
    if isinstance(v, NodeRef):
        return False
    return not tuple(getattr(v, "shape", ()) or ())


def _rebuild_types(node: Node, graph: DataflowGraph) -> None:
    """Re-run the node's split-type constructors after its bound arguments
    changed (the construction ``runtime.register_call`` performs)."""
    avals: dict[str, Any] = {}
    for name, v in node.bound.items():
        if isinstance(v, NodeRef):
            src = graph.nodes.get(v.node_id)
            avals[name] = src.out_aval if src is not None else None
        else:
            avals[name] = v
    node.out_aval = None if (getattr(node.fn.sa, "dynamic", False)
                             or any(a is None for a in avals.values())) \
        else node.fn.abstract_eval(avals)
    node.arg_types, node.out_type = node.fn.construct_types(
        dict(avals), avals, node.out_aval)


def _reorder_graph(graph: DataflowGraph, new_pending: list) -> None:
    """Rebuild the node dict so ``graph.pending()`` iterates the rewritten
    order (done nodes first: they never consume pending ones)."""
    order = {n.id for n in new_pending}
    rebuilt: dict[int, Node] = {}
    for n in graph.nodes.values():
        if n.id not in order:
            rebuilt[n.id] = n
    for n in new_pending:
        rebuilt[n.id] = n
    graph.nodes = rebuilt


def _decline(records: list, declined: set, pair: tuple, subject: str,
             reason: str) -> None:
    if pair not in declined:
        declined.add(pair)
        records.append(RewriteRecord("MZ505", "declined", subject, reason, 0.0))


def _pushdown(pending: list, graph: DataflowGraph, ctx,
              records: list, ops: list) -> list:
    """Hoist ``sa.selective`` stages ahead of elementwise maps.

    Pattern: ``flt = F(sel..., data=M(...))`` where M is elementwise with a
    single array operand, F is M's only consumer and M's own output is never
    observed; the edge becomes ``M(F(sel..., data=x))``."""
    declined: set[tuple] = set()      # (map id, filter id): one MZ505 each
    # Reduce-past-map cannot be licensed by the SA contracts (no
    # distributivity law): record the decline so the report explains it.
    cons0 = live_consumers(pending)
    for r_node in pending:
        if not isinstance(r_node.out_type, st.ReduceSplit):
            continue
        for v in r_node.bound.values():
            if not isinstance(v, NodeRef):
                continue
            p = graph.nodes.get(v.node_id)
            if (p is None or p.done or not p.fn.sa.elementwise
                    or cons0.get(p.id, []) != [r_node.id]):
                continue
            _decline(records, declined, (p.id, r_node.id),
                     f"{p.fn.name}#{p.id} -> {r_node.fn.name}#{r_node.id}",
                     "pushdown declined: reduction past a map — "
                     "reduce/map commutation is not provable from SA "
                     "contracts (no distributivity law)")
    for _ in range(len(pending)):
        cons = live_consumers(pending)
        pos = {n.id: i for i, n in enumerate(pending)}
        swap = None
        for f_node in pending:
            data_arg = getattr(f_node.fn.sa, "selective", None)
            if not data_arg:
                continue
            v = f_node.bound.get(data_arg)
            if not isinstance(v, NodeRef) or v.node_id not in pos:
                continue
            m_node = graph.nodes[v.node_id]
            reason = _pushdown_blocker(f_node, m_node, data_arg, cons, pos)
            if reason is not None:
                _decline(records, declined, (m_node.id, f_node.id),
                         f"{m_node.fn.name}#{m_node.id} -> "
                         f"{f_node.fn.name}#{f_node.id}",
                         f"pushdown declined: {reason}")
                continue
            swap = (f_node, m_node, data_arg)
            break
        if swap is None:
            return pending
        f_node, m_node, data_arg = swap
        n_full = _node_cost_features(m_node, graph)[0]
        n_filtered = max(int(math.ceil(n_full * ASSUMED_SELECTIVITY)), 1)
        saved = (node_seconds(m_node, graph, ctx, n_override=n_full)
                 - node_seconds(m_node, graph, ctx, n_override=n_filtered))
        ops.append(("hoist", f_node, m_node, data_arg))
        pending = _hoist(f_node, m_node, data_arg, pending, graph)
        records.append(RewriteRecord(
            "MZ503", "pushdown",
            f"{f_node.fn.name}#{f_node.id} <- {m_node.fn.name}#{m_node.id}",
            f"selective stage hoisted ahead of elementwise map "
            f"{m_node.fn.name} (assumed selectivity "
            f"{ASSUMED_SELECTIVITY:g}: {n_full} -> {n_filtered} elements)",
            max(saved, 0.0)))
    return pending


def _hoist(f_node: Node, m_node: Node, data_arg: str, pending: list,
           graph: DataflowGraph) -> list:
    """Make the edge ``F(sel..., data=M(x))`` into ``M(F(sel..., data=x))``;
    returns the new pending order."""
    m_data = next(name for name, mv in m_node.bound.items()
                  if name not in m_node.fn.sa.static
                  and not _is_scalarish(mv))
    # Downstream consumers of the filter now read the (filtered) map.
    for c in pending:
        if c is m_node or c is f_node:
            continue
        for name, cv in c.bound.items():
            if isinstance(cv, NodeRef) and cv.node_id == f_node.id:
                c.bound[name] = NodeRef(m_node.id)
    f_node.bound[data_arg] = m_node.bound[m_data]
    m_node.bound[m_data] = NodeRef(f_node.id)
    _rebuild_types(f_node, graph)
    _rebuild_types(m_node, graph)
    # The observable final value moves from the filter to the map.
    if f_node.future_ref is not None:
        fut = f_node.future_ref()
        if fut is not None:
            fut._node = m_node
        m_node.future_ref = f_node.future_ref
        f_node.future_ref = None
    m_node.alias_refs = list(m_node.alias_refs) + list(f_node.alias_refs)
    f_node.alias_refs = []
    # The filter takes the map's slot (its other deps precede it: checked
    # by _pushdown_blocker).
    new_pending = [n for n in pending if n is not f_node]
    new_pending.insert(new_pending.index(m_node), f_node)
    _reorder_graph(graph, new_pending)
    return new_pending


def _pushdown_blocker(f_node: Node, m_node: Node, data_arg: str,
                      cons: dict, pos: dict) -> str | None:
    """Why F cannot hoist ahead of M, or None when the commutation holds."""
    sa = m_node.fn.sa
    if isinstance(m_node.out_type, st.ReduceSplit):
        return ("producer is a reduction; filter/reduce commutation is not "
                "provable from SA contracts (no distributivity law)")
    if not sa.elementwise:
        return (f"producer {m_node.fn.name} is not elementwise; the SA "
                "contracts cannot prove commutation with a row filter")
    if sa.mut:
        return "producer carries a donation (mut) hint"
    if sa.static:
        return "producer has static parameters; commutation unproven"
    array_args = [name for name, v in m_node.bound.items()
                  if name not in sa.static and not _is_scalarish(v)]
    if len(array_args) != 1:
        return ("producer has multiple array operands; filtering one "
                "operand does not commute with the map")
    consumers = cons.get(m_node.id, [])
    if len(consumers) != 1 or consumers[0] != f_node.id:
        return "producer's full (unfiltered) output has other consumers"
    if m_node.future_alive():
        return "producer's full output is observed (live Future)"
    for name, v in f_node.bound.items():
        if name == data_arg or not isinstance(v, NodeRef):
            continue
        if v.node_id in pos and pos[v.node_id] >= pos[m_node.id]:
            return (f"selector argument {name!r} is defined after the map; "
                    "hoisting would break program order")
    return None


# ---------------------------------------------------------------------------
# MZ504: splitting-friendly reassociation
# ---------------------------------------------------------------------------


def _cluster(pending: list) -> list:
    """Chain-clustered topological order: after emitting a node, prefer a
    ready consumer of it (continue the chain); otherwise the earliest ready
    node in program order.  Deterministic, and a fixpoint of itself.  (The
    reference's order, kept with in-degree counts and a heap instead of a
    rescan of every node per step.)"""
    ids = {n.id for n in pending}
    order = {n.id: i for i, n in enumerate(pending)}
    deps = {n.id: [d for d in n.deps() if d in ids] for n in pending}
    consumers: dict[int, list[int]] = {n.id: [] for n in pending}
    for n in pending:
        for d in deps[n.id]:
            consumers[d].append(n.id)
    waiting = {nid: len(ds) for nid, ds in deps.items()}
    ready = {nid for nid, k in waiting.items() if k == 0}
    heap = sorted(order[nid] for nid in ready)
    out: list = []
    last: int | None = None
    while len(out) < len(pending):
        pick = None
        if last is not None:
            chain = [c for c in consumers[last] if c in ready]
            if chain:
                pick = min(chain, key=lambda c: order[c])
        if pick is None:
            while pending[heap[0]].id not in ready:
                heapq.heappop(heap)      # emitted earlier as a chain pick
            pick = pending[heapq.heappop(heap)].id
        ready.discard(pick)
        out.append(pending[order[pick]])
        for c in consumers[pick]:
            waiting[c] -= 1
            if waiting[c] == 0:
                ready.add(c)
                heapq.heappush(heap, order[c])
        last = pick
    return out


def _reassociate(pending: list, graph: DataflowGraph, ctx,
                 records: list, ops: list) -> list:
    if len(pending) < 3:
        return pending
    clustered = _cluster(pending)
    if [n.id for n in clustered] == [n.id for n in pending]:
        return pending
    from repro_torch.core.planner import simulate_stage_breaks
    max_nodes = None if getattr(ctx, "pipeline", True) else 1
    base = simulate_stage_breaks(pending, graph, max_stage_nodes=max_nodes)
    alt = simulate_stage_breaks(clustered, graph, max_stage_nodes=max_nodes)
    ctx.stats["rewrite_simulations"] += 2
    if len(alt) >= len(base):
        records.append(RewriteRecord(
            "MZ505", "declined",
            f"{len(pending)}-node graph",
            f"reassociation declined: chain clustering yields {len(alt)} "
            f"stage(s) vs {len(base)} — no boundary eliminated", 0.0))
        return pending
    # Each eliminated boundary skips one merge + re-split round trip of
    # roughly a stage's interior bytes through memory, plus a dispatch.
    bytes_est = max(math.prod(_node_cost_features(n, graph)) for n in pending)
    eliminated = len(base) - len(alt)
    saved = eliminated * (2.0 * bytes_est / ctx.chip.hbm_bandwidth
                          + hardware.effective_dispatch_overhead_s(ctx.chip, ctx.device))
    ops.append(("order", clustered))
    _reorder_graph(graph, clustered)
    records.append(RewriteRecord(
        "MZ504", "reassoc",
        ",".join(f"{n.fn.name}#{n.id}" for n in clustered),
        f"independent chains regrouped: {len(base)} -> {len(alt)} stage(s) "
        f"({eliminated} boundary(ies) eliminated; merge associativity "
        "[MZ102] preserves results)", max(saved, 0.0)))
    return clustered


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def apply(pending: list, graph: DataflowGraph, ctx,
          script: Script | None = None) -> RewriteResult:
    """Rewrite the pending graph in place; returns the surviving node order
    and the records.  Gated by the context's ``rewrite`` knob; a disabled
    (or empty) pass returns the input untouched.  ``script``, when given,
    receives what the pass did (:func:`replay` repeats it)."""
    if not getattr(ctx, "rewrite", True) or not pending:
        return RewriteResult(list(pending), [])
    ctx.stats["rewrite_passes"] += 1
    orig = list(pending)
    records: list[RewriteRecord] = []
    ops: list = []
    pending = _eliminate_dead(pending, graph, ctx, records, ops)
    if pending:
        pending = _share_common(pending, graph, ctx, records, ops)
    if pending:
        pending = _pushdown(pending, graph, ctx, records, ops)
    if pending:
        pending = _reassociate(pending, graph, ctx, records, ops)
    if script is not None:
        at = {id(n): i for i, n in enumerate(orig)}
        script.ops = [(op[0],) + tuple(at[id(a)] if isinstance(a, Node) else
                                       [at[id(n)] for n in a] if isinstance(a, list)
                                       else a for a in op[1:]) for op in ops]
        script.records = list(records)
        script.ids = tuple(n.id for n in orig)
    _count(records, ctx)
    return RewriteResult(pending, records)


def _count(records: list, ctx) -> None:
    applied = sum(r.kind != "declined" for r in records)
    if applied:
        ctx.stats["rewrites_applied"] += applied
    if applied != len(records):
        ctx.stats["rewrites_declined"] += len(records) - applied


_NODE_ID = re.compile(r"#(\d+)")


def replay(pending: list, graph: DataflowGraph, ctx,
           script: Script) -> RewriteResult:
    """Repeat a :class:`Script` on another capture of the graph it was
    written for (same plan-cache key): the same mutations in the same
    order, with none of the analysis, and the records renamed to this
    capture's node ids.  The list the mutations see is filtered of retired
    nodes exactly where ``apply`` filters it (after the dead and the merge
    phases), so the graph, its consumer map included, ends as ``apply``
    leaves it."""
    ctx.stats["rewrite_replays"] += 1
    orig = list(pending)
    cur = list(pending)
    prev = None
    for op in script.ops:
        if op[0] != prev:
            cur = [n for n in cur if not n.done]
            prev = op[0]
        if op[0] == "retire":
            _retire(orig[op[1]])
        elif op[0] == "merge":
            _merge_into(orig[op[1]], orig[op[2]], cur)
        elif op[0] == "hoist":
            cur = _hoist(orig[op[1]], orig[op[2]], op[3], cur, graph)
        else:                            # "order"
            cur = [orig[i] for i in op[1]]
            _reorder_graph(graph, cur)
    cur = [n for n in cur if not n.done]
    new_id = {str(old): str(n.id) for old, n in zip(script.ids, orig)}

    def rename(text: str) -> str:
        return _NODE_ID.sub(lambda m: "#" + new_id.get(m.group(1), m.group(1)), text)

    records = [dataclasses.replace(r, subject=rename(r.subject),
                                   detail=rename(r.detail))
               for r in script.records]
    _count(records, ctx)
    return RewriteResult(cur, records)
