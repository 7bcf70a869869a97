"""The Mozart planner (paper §5.1): dataflow graph -> pipelined stages.

Two adjacent functions live in the same *stage* iff every value flowing
between them has the same split type (after generic inference).  A mismatch
forces the producer's outputs to be merged, the stage to close, and the
consumer to start a new stage whose inputs are re-split.

Generic inference "pushes known types along the edges" with a union-find
``TypeEnv``; anything still generic when a stage closes falls back to the
per-data-type default split type (paper §5.1).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import split_types as st
from repro_torch.core.graph import DataflowGraph, Node, NodeRef, live_consumers


def _value_key(v: Any) -> tuple:
    if isinstance(v, NodeRef):
        return ("node", v.node_id)
    return ("ext", id(v))


@dataclasses.dataclass
class StageInput:
    key: tuple
    value: Any                      # concrete value or NodeRef (resolved later)
    split_type: st.SplitType        # resolved, concrete


@dataclasses.dataclass
class Stage:
    id: int
    nodes: list[Node]
    inputs: dict[tuple, StageInput]
    out_types: dict[int, st.SplitType]      # node_id -> resolved output type
    escaping: set[int]                       # node ids whose output leaves the stage
    arg_types: dict[tuple[int, str], st.SplitType]  # (node, arg) resolved

    def __post_init__(self):
        # Position-based canonical env keys: ("in", input position) and
        # ("n", node position) depend only on the stage's shape, never on
        # per-call value ids or node ids.
        self.canon: dict[tuple, tuple] = {}
        for i, key in enumerate(self.inputs):
            self.canon[key] = ("in", i)
        self.pos: dict[int, int] = {}        # node_id -> position in the stage
        for j, n in enumerate(self.nodes):
            self.pos[n.id] = j
            self.canon[("node", n.id)] = ("n", j)

    def ckey(self, key: tuple) -> tuple:
        """Canonical (position-based) form of a runtime env key."""
        return self.canon[key]

    def out_key(self, node: Node) -> tuple:
        return ("n", self.pos[node.id])

    def escape_positions(self) -> list[int]:
        """Stage-local positions of escaping nodes, in deterministic order."""
        return sorted(self.pos[nid] for nid in self.escaping)

    def internal(self, node: Node, argname: str) -> bool:
        v = node.bound.get(argname)
        return isinstance(v, NodeRef) and any(n.id == v.node_id for n in self.nodes)

    def flops_hint(self) -> float:
        """Arithmetic-intensity proxy: summed SA ``cost_hint`` over the chain
        (relative to one elementwise op), read by ``core/cost_model.py``."""
        return sum(float(getattr(n.fn.sa, "cost_hint", 1.0)) for n in self.nodes)


def _count_of_type(t: Any) -> int | None:
    if isinstance(t, st.ArraySplit):
        return t.shape[t.axis] if t.shape else None
    if isinstance(t, st.PytreeSplit):
        return t.length
    return None


def _is_whole_array_source(node: Node) -> bool:
    """True when every non-static input is concretely broadcast ("_") but the
    output is splittable: the node computes on WHOLE arrays.  It must form
    its own stage — its output materializes and downstream stages re-split
    it — or chunked consumers would mix full-size values with chunks."""
    args = [t for name, t in node.arg_types.items()
            if name not in node.fn.sa.static]
    if not args or not all(isinstance(t, st.ScalarSplit) for t in args):
        return False
    return not isinstance(node.out_type, (st.ScalarSplit, st.ReduceSplit))


class _OpenStage:
    def __init__(self, sid: int):
        self.id = sid
        self.nodes: list[Node] = []
        self.env = st.TypeEnv()
        self.input_tvars: dict[tuple, Any] = {}    # key -> SplitType|GenericVar
        self.input_vals: dict[tuple, Any] = {}
        self.out_tvars: dict[int, Any] = {}
        self.count: int | None = None              # split element count
        self.closed = False                        # whole-array source stage

    def _candidate_count(self, node: Node, graph) -> int | None:
        """Element count this node's splittable inputs imply.  Generic args
        use the value's per-datatype default split (paper §5.1 fallback)."""
        for name, val in node.bound.items():
            if name in node.fn.sa.static:
                continue
            declared = self.env.resolve(node.arg_types[name])
            c = _count_of_type(declared)
            if c is not None:
                return c
            if isinstance(declared, st.GenericVar):
                aval = (graph.nodes[val.node_id].out_aval
                        if isinstance(val, NodeRef) else val)
                if aval is not None:
                    c = _count_of_type(st.default_split_type(aval))
                    if c is not None:
                        return c
        return None

    def try_place(self, node: Node, graph) -> bool:
        if _is_whole_array_source(node):
            if self.nodes:
                return False               # boundary: own stage
            self.closed = True             # and nothing joins after it
        # the per-stage driver loop iterates ONE chunk range: every
        # splittable value in a stage must agree on its element count
        cand = self._candidate_count(node, graph)
        if cand is not None and self.count is not None and cand != self.count:
            return False
        snap = self.env.snapshot()
        added_inputs: list[tuple] = []
        try:
            for name, val in node.bound.items():
                if name in node.fn.sa.static:
                    continue
                declared = node.arg_types[name]
                if isinstance(val, NodeRef) and val.node_id in self.out_tvars:
                    # intra-stage edge: source out type must equal dest arg type
                    self.env.unify(self.out_tvars[val.node_id], declared)
                else:
                    key = _value_key(val)
                    if key in self.input_tvars:
                        # same value used twice in one stage: one split only
                        self.env.unify(self.input_tvars[key], declared)
                    else:
                        self.input_tvars[key] = declared
                        self.input_vals[key] = val
                        added_inputs.append(key)
            self.out_tvars[node.id] = node.out_type
            self.nodes.append(node)
            node.stage_id = self.id
            if cand is not None and self.count is None:
                self.count = cand
            return True
        except st.UnificationError:
            self.env.restore(snap)
            for key in added_inputs:
                self.input_tvars.pop(key, None)
                self.input_vals.pop(key, None)
            return False


def _resolve(env: st.TypeEnv, t: Any, aval_like: Any) -> st.SplitType:
    r = env.resolve(t)
    if isinstance(r, st.GenericVar):
        r = (st.default_split_type(aval_like)
             if aval_like is not None else st.BROADCAST)
    # A generic unified across broadcasting operands of different shapes
    # must not be split with the larger operand's geometry: shape-mismatched
    # values are copied whole instead (the paper's "_" semantics).
    if isinstance(r, st.ArraySplit) and aval_like is not None:
        shape = tuple(getattr(aval_like, "shape", ()) or ())
        if shape and shape != r.shape:
            return st.BROADCAST
    return r


#: process-global count of actual planner invocations; the plan cache's
#: "a warm call makes zero planner calls" guarantee is asserted against it.
N_CALLS = 0


def _group(nodes: list[Node], graph: DataflowGraph,
           max_stage_nodes: int | None) -> list[_OpenStage]:
    """The greedy grouping loop shared by ``plan`` and
    ``simulate_stage_breaks``."""
    groups: list[_OpenStage] = []
    cur: _OpenStage | None = None
    for node in nodes:
        full = (cur is not None and
                (cur.closed or (max_stage_nodes is not None
                                and len(cur.nodes) >= max_stage_nodes)))
        if cur is None or full or not cur.try_place(node, graph):
            cur = _OpenStage(len(groups))
            groups.append(cur)
            if not cur.try_place(node, graph):
                raise AssertionError(f"cannot place {node} in empty stage")
    return groups


def simulate_stage_breaks(nodes: list[Node], graph: DataflowGraph,
                          max_stage_nodes: int | None = None
                          ) -> list[list[Node]]:
    """The stage partition ``plan`` would produce for this node order,
    without building ``Stage`` objects and without counting as a planner
    call (``N_CALLS`` untouched).  ``try_place`` tags ``node.stage_id`` as a
    side effect; callers re-plan afterwards, so the tags are transient."""
    return [g.nodes for g in _group(nodes, graph, max_stage_nodes)]


def plan(nodes: list[Node], graph: DataflowGraph,
         max_stage_nodes: int | None = None) -> list[Stage]:
    """Greedy consecutive grouping in topological (= program) order.

    ``max_stage_nodes=1`` disables cross-function pipelining (each function
    still splits alone) — the paper's Table 4 "-pipe" ablation.
    """
    global N_CALLS
    N_CALLS += 1
    open_stages = _group(nodes, graph, max_stage_nodes)

    consumers = live_consumers(graph.pending())
    stages: list[Stage] = []
    for s in open_stages:
        inputs: dict[tuple, StageInput] = {}
        for key, tvar in s.input_tvars.items():
            val = s.input_vals[key]
            if isinstance(val, NodeRef):
                aval = graph.nodes[val.node_id].out_aval
            else:
                aval = val          # default_split_type dispatches on type
            inputs[key] = StageInput(key, val, _resolve(s.env, tvar, aval))
        out_types: dict[int, st.SplitType] = {}
        escaping: set[int] = set()
        node_ids = {n.id for n in s.nodes}
        invariant: set[int] = set()
        for n in s.nodes:
            out_types[n.id] = _resolve(s.env, s.out_tvars[n.id], n.out_aval)
            ext_consumer = any(c not in node_ids for c in consumers.get(n.id, []))
            if ext_consumer or n.future_alive():
                escaping.add(n.id)
            # A function of chunk-invariant values only (broadcast inputs, or
            # such functions' outputs) returns the same value in every chunk:
            # a partial it returns (a reduction, a group, a filtered rest) is
            # taken once, never combined once per chunk.  The reference
            # combines it per chunk (ROADMAP C10).
            if all(name in n.fn.sa.static
                   or (v.node_id in invariant
                       if isinstance(v, NodeRef) and v.node_id in node_ids
                       else not inputs[_value_key(v)].split_type.splittable)
                   for name, v in n.bound.items()):
                invariant.add(n.id)
                t = out_types[n.id]
                if not t.splittable and not isinstance(t, st.ScalarSplit):
                    out_types[n.id] = st.BROADCAST
        arg_types: dict[tuple[int, str], st.SplitType] = {}
        for n in s.nodes:
            for name in n.bound:
                if name in n.fn.sa.static:
                    continue
                v = n.bound[name]
                if isinstance(v, NodeRef):
                    aval = graph.nodes[v.node_id].out_aval
                else:
                    aval = v
                arg_types[(n.id, name)] = _resolve(s.env, n.arg_types[name], aval)
        stages.append(Stage(s.id, s.nodes, inputs, out_types, escaping, arg_types))
    return stages
