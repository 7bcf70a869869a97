"""The StageExecutor subsystem: shared split → drive → merge machinery.

Every Mozart execution strategy follows the same three-phase shape from the
paper (§5.2): split the stage inputs into fast-memory-sized batches, drive
each batch through the unmodified library functions, and merge the partial
results associatively.  This module holds that machinery in one base class
and a registry so that strategies are *pluggable*:

    @register_executor("my-strategy")
    class MyExecutor(StageExecutor):
        def execute(self, stage, concrete, ctx):
            ...split / drive / merge using the shared helpers...

``runtime.MozartContext.evaluate`` dispatches through ``get_executor``.  The
built-in strategies live in ``core/executor.py`` ("eager", "pipelined",
"fused") and ``core/cuda_exec.py`` ("cuda"), registered as a side effect of
importing those modules.

Batch sizing goes through ``StageExecutor.choose_batch``: an explicit
per-context ``batch_elements``, else the paper's §5.2 fast-memory estimate
(``hardware.mozart_batch_elements``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Callable

from torch.utils import _pytree as pytree

from repro_torch import hardware
from repro_torch.core import split_types as st
from repro_torch.core.graph import DataflowGraph, NodeRef
from repro_torch.core.planner import Stage, _value_key


class PedanticError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type["StageExecutor"]] = {}
_INSTANCES: dict[str, "StageExecutor"] = {}


def register_executor(name: str) -> Callable[[type], type]:
    """Class decorator: make a StageExecutor reachable as ``executor=name``."""

    def deco(cls: type) -> type:
        cls.name = name
        _REGISTRY[name] = cls
        _INSTANCES.pop(name, None)
        return cls

    return deco


def _ensure_builtin_executors() -> None:
    # Importing these modules registers their executor classes.
    import repro_torch.core.cuda_exec  # noqa: F401  (cuda)
    import repro_torch.core.executor   # noqa: F401  (eager/pipelined/fused)


def get_executor(name: str) -> "StageExecutor":
    if name not in _REGISTRY:
        _ensure_builtin_executors()
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown executor {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    inst = _INSTANCES.get(name)
    if inst is None or type(inst) is not cls:
        inst = _INSTANCES[name] = cls()
    return inst


def available_executors() -> tuple[str, ...]:
    _ensure_builtin_executors()
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Runtime parameter discovery (paper §5.2 step 1)
# ---------------------------------------------------------------------------


def stage_num_elements(stage: Stage, concrete: dict[tuple, Any], pedantic: bool) -> int:
    counts = set()
    for key, si in stage.inputs.items():
        if not si.split_type.splittable:
            continue
        info = si.split_type.info(concrete[key])
        if info is not None:
            counts.add(info.num_elements)
    if len(counts) > 1:
        raise PedanticError(f"stage {stage.id}: inputs disagree on element count: {counts}")
    return counts.pop() if counts else 1


def stage_elem_bytes(stage: Stage, concrete: dict[tuple, Any], n: int) -> int:
    """Σ sizeof(element) over live pipeline values (inputs + outputs)."""
    total = 0
    for key, si in stage.inputs.items():
        if not si.split_type.splittable:
            continue
        info = si.split_type.info(concrete[key])
        if info is not None:
            total += info.elem_bytes
    for node in stage.nodes:
        t = stage.out_types[node.id]
        if t.splittable and node.out_aval is not None:
            leaves = pytree.tree_leaves(node.out_aval)
            nb = sum(st.nbytes_of(l) for l in leaves)
            total += max(nb // max(n, 1), 1)
    return total


def batch_ranges(n: int, batch: int) -> list[tuple[int, int]]:
    if n <= 0:
        # Empty splits: one degenerate chunk, so the chain still runs (on
        # zero-size slices) and merges produce the library's empty-input
        # result instead of crashing on an empty partial list.
        return [(0, 0)]
    return [(s, min(s + batch, n)) for s in range(0, n, batch)]


def effective_elements(ctx, n: int) -> int:
    """Stage element count, clamped while a tuner measures on a sliced
    sample (``ctx._n_cap``; split-type ``info`` reports the FULL value's
    count, so executors running on a sample must cap their ranges)."""
    cap = getattr(ctx, "_n_cap", None)
    return n if cap is None else min(n, cap)


# ---------------------------------------------------------------------------
# Stage-boundary traffic accounting (scoped per execution context)
# ---------------------------------------------------------------------------

#: bounded trail of recent materialization events ``(kind, where, nbytes)``.
_EVENT_LIMIT = 256


class BoundaryCounters:
    """One scope's view of stage-boundary traffic.

    INTERIOR bytes are round trips at stage boundaries: merges of
    multi-chunk partials (``finish_stage``) plus bytes re-sliced when a stage
    splits a value that another stage produced.  Splitting EXTERNAL pipeline
    inputs is not counted (that split is inherent to chunking).

    Every ``MozartContext`` owns one of these (``ctx.counters``); executor
    dispatch runs inside ``counter_scope``, so two concurrent sessions never
    pollute each other's figures.  ``bytes_interior()`` below reads the
    PROCESS-GLOBAL aggregate, which every event also updates.
    """

    __slots__ = ("interior", "events")

    def __init__(self) -> None:
        self.interior = 0
        self.events: "collections.deque[tuple[str, str, int]]" = \
            collections.deque(maxlen=_EVENT_LIMIT)

    def bytes_interior(self) -> int:
        return self.interior

    def materialize_events(self) -> list[tuple[str, str, int]]:
        return list(self.events)

    def reset(self) -> None:
        self.interior = 0
        self.events.clear()


#: the process-global aggregate: every note_* call lands here in addition to
#: whatever scopes are active.
_GLOBAL_COUNTERS = BoundaryCounters()

_scope_tls = threading.local()

#: guards counter increments: concurrent sessions must never lose an
#: increment to a racing ``+=``.
_counts_lock = threading.Lock()


def _scopes() -> list:
    s = getattr(_scope_tls, "stack", None)
    if s is None:
        s = _scope_tls.stack = []
    return s


@contextlib.contextmanager
def counter_scope(counters: "BoundaryCounters | None"):
    """Attribute boundary events to ``counters`` for the duration.

    Scopes nest (re-entering with a scope already active is a no-op), and
    distinct scopes stack.  Thread local; the process-global aggregate is
    always updated regardless."""
    if counters is None:
        yield
        return
    stack = _scopes()
    if any(c is counters for c in stack):
        yield                             # already attributed: no double count
        return
    stack.append(counters)
    try:
        yield
    finally:
        stack.remove(counters)


def note_materialized(nbytes: int, kind: str = "merge", where: str = "") -> None:
    event = ("interior:" + kind, where, int(nbytes))
    with _counts_lock:
        for c in (_GLOBAL_COUNTERS, *_scopes()):
            c.interior += event[2]
            c.events.append(event)


def bytes_interior() -> int:
    """Interior-boundary bytes, process-global; per-session figures read
    ``ctx.counters`` instead."""
    return _GLOBAL_COUNTERS.interior


def _value_nbytes(v: Any) -> int:
    return sum(st.nbytes_of(l) for l in pytree.tree_leaves(v)
               if hasattr(l, "shape") or isinstance(l, (int, float, bool)))


# ---------------------------------------------------------------------------
# Per-chunk chain driving (position-keyed)
# ---------------------------------------------------------------------------
#
# Chunk envs are keyed CANONICALLY — ``("in", input_position)`` for stage
# inputs and ``("n", node_position)`` for node outputs (``Stage.ckey``) —
# never by per-call node ids or value ids.


def chunk_env_for(stage: Stage, concrete: dict[tuple, Any], s: int, e: int,
                  pedantic: bool) -> dict[tuple, Any]:
    """Build one chunk's canonical env."""
    env: dict[tuple, Any] = {}
    for key, si in stage.inputs.items():
        v = concrete[key]
        if si.split_type.splittable:
            if s == 0 and not pedantic:
                info = si.split_type.info(v)
                if info is not None and e == info.num_elements:
                    # Identity slice (single-chunk stage): pass the whole
                    # value through — no dispatch, no boundary traffic.
                    env[stage.ckey(key)] = v
                    continue
            piece = si.split_type.split(v, s, e)
            if isinstance(si.value, NodeRef):
                # Re-slicing another stage's merged output: a boundary
                # round trip.
                note_materialized(_value_nbytes(piece), kind="resplit",
                                  where=f"stage {stage.id} input {stage.ckey(key)}"
                                        f" range [{s},{e})")
            if pedantic and hasattr(piece, "shape") and 0 in piece.shape:
                raise PedanticError(f"empty split for {key} range [{s},{e})")
            env[stage.ckey(key)] = piece
        else:
            env[stage.ckey(key)] = v          # "_" values: pointer copy
    return env


def chain_plan(stage: Stage) -> tuple:
    """Driving recipe for the stage chain, cached on the stage.

    Per node: ``(fn, out_key, ((argname, env_key | None, static_value), ...))``
    — ``AnnotatedFn`` identities, static argument values and canonical env
    keys only."""
    cached = getattr(stage, "_chain_plan", None)
    if cached is not None:
        return cached
    steps = []
    for node in stage.nodes:
        srcs = []
        for name, v in node.bound.items():
            if name in node.fn.sa.static:
                srcs.append((name, None, v))
            else:
                srcs.append((name, stage.ckey(_value_key(v)), None))
        steps.append((node.fn, stage.out_key(node), tuple(srcs)))
    stage._chain_plan = tuple(steps)
    return stage._chain_plan


def run_plan(plan: tuple, env: dict[tuple, Any]) -> None:
    """Drive one chunk env through every function of a chain plan in order:
    each step is one black-box library call."""
    for fn, out_key, srcs in plan:
        kw = {name: (static if key is None else env[key])
              for name, key, static in srcs}
        env[out_key] = fn.call_eager(kw)


def run_chain(stage: Stage, env: dict[tuple, Any]) -> None:
    """Drive one (canonically keyed) chunk env through the stage chain."""
    run_plan(chain_plan(stage), env)


def finish_stage(stage: Stage, partials: dict[int, list[Any]]) -> None:
    """Merge per-chunk partials (keyed by stage-local node POSITION)."""
    for node in stage.nodes:
        p = stage.pos[node.id]
        if p in partials:
            t = stage.out_types[node.id]
            pieces = partials[p]
            node.result = t.merge(pieces)
            if len(pieces) > 1 and not isinstance(t, st.ScalarSplit):
                note_materialized(_value_nbytes(node.result), kind="merge",
                                  where=f"stage {stage.id} node {p}")
        node.done = True


def has_dynamic(stage: Stage) -> bool:
    return any(
        getattr(n.fn.sa, "dynamic", False) or n.out_aval is None
        for n in stage.nodes
    )


def resolve_stage_inputs(stage: Stage, graph: DataflowGraph) -> dict[tuple, Any]:
    """Concrete value of every stage input (producers' merged results)."""
    return {key: graph.resolve(si.value) for key, si in stage.inputs.items()}


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------


class StageExecutor:
    """One execution strategy: split inputs → drive chunks → merge partials.

    Subclasses implement ``execute``; ``run`` is the template method the
    runtime calls per stage.  It resolves concrete inputs and does the
    done/stats bookkeeping shared by every strategy.
    """

    name: str = "abstract"

    # -- template method ----------------------------------------------------
    def run(self, stage: Stage, graph: DataflowGraph, ctx) -> None:
        concrete = resolve_stage_inputs(stage, graph)
        self.execute(stage, concrete, ctx)
        ctx.stats["stages"] += 1
        for node in stage.nodes:
            node.done = True

    def execute(self, stage: Stage, concrete: dict[tuple, Any], ctx) -> None:
        raise NotImplementedError

    # -- batch sizing (paper §5.2) ------------------------------------------
    def estimate_batch(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                       n: int) -> int:
        elem_bytes = stage_elem_bytes(stage, concrete, n)
        return hardware.mozart_batch_elements(elem_bytes, ctx.chip)

    def choose_batch(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                     n: int) -> int:
        if ctx.batch_elements:
            return max(1, min(ctx.batch_elements, n))
        return max(1, min(self.estimate_batch(stage, concrete, ctx, n), n))
