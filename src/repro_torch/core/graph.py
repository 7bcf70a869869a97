"""Dataflow graph capture — the libmozart client library (paper §4).

Annotated calls are recorded as ``Node``s in a ``DataflowGraph`` instead of
executing.  Each node stores the *bound* arguments with lazy values replaced
by ``NodeRef``s (so that intermediate ``Future`` handles can die, which is
how Mozart learns that a value never escapes its pipeline stage and need not
be merged/materialized).  Evaluation is forced when arbitrary code touches a
``Future``.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any


@dataclasses.dataclass(frozen=True)
class NodeRef:
    """Reference to the output of an earlier node in the same graph."""

    node_id: int


class Node:
    __slots__ = (
        "id", "fn", "bound", "arg_types", "out_type", "out_aval",
        "result", "done", "future_ref", "stage_id", "pinned", "alias_refs",
    )

    def __init__(self, node_id: int, fn, bound: dict[str, Any],
                 arg_types: dict[str, Any], out_type, out_aval):
        self.id = node_id
        self.fn = fn                     # AnnotatedFn
        self.bound = bound               # name -> value | NodeRef
        self.arg_types = arg_types       # name -> SplitType | GenericVar
        self.out_type = out_type         # SplitType | GenericVar
        self.out_aval = out_aval         # pytree of meta tensors
        self.result: Any = None
        self.done = False
        self.future_ref: weakref.ref | None = None
        self.stage_id: int | None = None
        # Pinned nodes survive prune(): the Pipeline bound-arguments fast
        # path re-executes a retained node set per call (core/pipeline.py).
        self.pinned = False
        # Futures of nodes CSE-merged into this one (core/rewrite.py): while
        # any of them is alive, this node's output is observable.
        self.alias_refs: list[weakref.ref] = []

    def future_alive(self) -> bool:
        if self.future_ref is not None and self.future_ref() is not None:
            return True
        return any(r() is not None for r in self.alias_refs)

    def deps(self) -> list[int]:
        out = []
        for v in self.bound.values():
            if isinstance(v, NodeRef):
                out.append(v.node_id)
        return out

    def __repr__(self) -> str:
        return f"Node#{self.id}({self.fn.name})"


def live_consumers(pending: list[Node]) -> dict[int, list[int]]:
    """Consumer map over not-yet-executed nodes only: the edges a plan can
    still need.  ``DataflowGraph.consumers()`` also counts edges from done
    nodes, and a node the rewrite pass retired is done with its ``bound``
    intact: counted, it would keep its producers escaping."""
    out: dict[int, list[int]] = {}
    for n in pending:
        for d in n.deps():
            out.setdefault(d, []).append(n.id)
    return out


class DataflowGraph:
    """Pending (not yet executed) annotated calls, in program order.

    Program order is a valid topological order: a ``Future`` can only refer
    to an already-registered node.
    """

    def __init__(self) -> None:
        self.nodes: dict[int, Node] = {}
        self._next_id = 0

    def register(self, fn, bound, arg_types, out_type, out_aval) -> Node:
        node = Node(self._next_id, fn, bound, arg_types, out_type, out_aval)
        self.nodes[node.id] = node
        self._next_id += 1
        return node

    def pending(self) -> list[Node]:
        return [n for n in self.nodes.values() if not n.done]

    def consumers(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {nid: [] for nid in self.nodes}
        for n in self.nodes.values():
            for d in n.deps():
                if d in out:            # producer may already be pruned
                    out[d].append(n.id)
        return out

    def prune(self) -> None:
        """Drop executed nodes whose results can no longer be observed."""
        cons = self.consumers()
        dead = [
            nid for nid, n in self.nodes.items()
            if n.done and not n.pinned and not n.future_alive()
            and all(self.nodes[c].done for c in cons[nid])
        ]
        for nid in dead:
            del self.nodes[nid]

    def resolve(self, value: Any) -> Any:
        """NodeRef -> materialized result (must be done)."""
        if isinstance(value, NodeRef):
            node = self.nodes[value.node_id]
            if not node.done:
                raise RuntimeError(f"{node} consumed before evaluation")
            return node.result
        return value
