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
"fused", "scan"), ``core/cuda_exec.py`` ("cuda") and ``core/cost_model.py``
("auto"), registered as a side effect of importing those modules.

Cross-stage chunk handoff lives here too: ``ChunkStream`` (a stage output
left unmerged), ``finish_stage`` (which keeps the outputs the decisions of
``core/handoff.py`` mark as streams), ``resolve_stage_inputs`` (which hands
a stream to a stream-capable executor, or merges it with a counted reason)
and the boundary counters that show what a boundary cost.

Batch sizing goes through ``StageExecutor.choose_batch``: the tuner's
sample override, an explicit per-context ``batch_elements``, the size the
auto-tuner pinned into the plan-cache entry, else the paper's §5.2
fast-memory estimate (``hardware.mozart_batch_elements``).  The tuner runs
on the first execution of a *cached* plan (``StageExecutor._tune``).

Built drivers and lowered kernel programs are pinned per plan entry
(``pinned_exec``), so a warm call builds nothing.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import hardware
from repro_torch.core import resilience
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
    import repro_torch.core.cost_model  # noqa: F401  (auto)
    import repro_torch.core.cuda_exec  # noqa: F401  (cuda)
    import repro_torch.core.executor   # noqa: F401  (eager/pipelined/fused/scan)


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


def _info_arg(v: Any) -> Any:
    """What to hand a split type's ``info``: a handed-off ChunkStream stands
    in for its full value through its aval."""
    return v.aval if isinstance(v, ChunkStream) else v


def stage_num_elements(stage: Stage, concrete: dict[tuple, Any], pedantic: bool) -> int:
    counts = set()
    for key, si in stage.inputs.items():
        if not si.split_type.splittable:
            continue
        info = si.split_type.info(_info_arg(concrete[key]))
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
        info = si.split_type.info(_info_arg(concrete[key]))
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
# Trace + stage-boundary traffic accounting (scoped per execution context)
# ---------------------------------------------------------------------------

#: bounded trail of recent materialization events ``(kind, where, nbytes)``.
_EVENT_LIMIT = 256


class BoundaryCounters:
    """One scope's view of trace and stage-boundary traffic accounting.

    TRACES count the program builds a warm call should not repeat: each
    ``torch.fx`` trace of a library function (``cuda_exec.traced_graph``)
    and each stage lowering not served from a cache (PyTorch has no jit;
    these are the port's counterpart of the reference's jax traces).

    BOUNDARY BYTES split in two.  INTERIOR bytes are the round trips that
    chunk handoff exists to remove: merges of multi-chunk partials
    (``finish_stage``), ``SplitType.rechunk`` copies, materialize-on-ingest
    by a stream-incapable executor, and bytes re-sliced when a stage splits
    a value that another stage produced.  TERMINAL bytes are the lazy
    ``ChunkStream.materialize`` of an *observed* output (``Future.value``),
    inherent to observation.  Splitting EXTERNAL pipeline inputs is counted
    by neither (that split is inherent to chunking).

    Every ``MozartContext`` owns one of these (``ctx.counters``); executor
    dispatch and terminal observation run inside ``counter_scope``, so two
    concurrent sessions never pollute each other's figures.  The module
    functions (``bytes_interior``, ``trace_count``, ...) read the
    PROCESS-GLOBAL aggregate, which every event also updates.
    """

    __slots__ = ("traces", "interior", "terminal", "events")

    def __init__(self) -> None:
        self.traces = 0
        self.interior = 0
        self.terminal = 0
        self.events: "collections.deque[tuple[str, str, int]]" = \
            collections.deque(maxlen=_EVENT_LIMIT)

    def trace_count(self) -> int:
        return self.traces

    def bytes_interior(self) -> int:
        return self.interior

    def bytes_terminal(self) -> int:
        return self.terminal

    def bytes_materialized(self) -> int:
        return self.interior + self.terminal

    def materialize_events(self) -> list[tuple[str, str, int]]:
        return list(self.events)

    def reset(self) -> None:
        self.traces = 0
        self.interior = 0
        self.terminal = 0
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
    """Attribute trace and boundary events to ``counters`` for the duration.

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


def note_trace() -> None:
    with _counts_lock:
        for c in (_GLOBAL_COUNTERS, *_scopes()):
            c.traces += 1


def note_materialized(nbytes: int, terminal: bool = False,
                      kind: str = "merge", where: str = "") -> None:
    nbytes = int(nbytes)
    event = (("terminal:" if terminal else "interior:") + kind, where, nbytes)
    with _counts_lock:
        for c in (_GLOBAL_COUNTERS, *_scopes()):
            if terminal:
                c.terminal += nbytes
            else:
                c.interior += nbytes
            c.events.append(event)


def trace_count() -> int:
    """Process-global trace count (aggregate across every scope)."""
    return _GLOBAL_COUNTERS.traces


def bytes_materialized() -> int:
    """Total boundary bytes (interior + terminal), process-global."""
    return _GLOBAL_COUNTERS.bytes_materialized()


def bytes_interior() -> int:
    """Interior-boundary bytes, process-global (0 on a fully handed-off
    chain); per-session figures read ``ctx.counters`` instead."""
    return _GLOBAL_COUNTERS.interior


def bytes_terminal() -> int:
    """Bytes merged lazily at *observed* outputs only (global)."""
    return _GLOBAL_COUNTERS.terminal


def reset_materialized() -> None:
    """Zero the GLOBAL byte counters and drop its event trail.  Scoped
    counters are unaffected (``ctx.counters.reset()``)."""
    with _counts_lock:
        _GLOBAL_COUNTERS.interior = 0
        _GLOBAL_COUNTERS.terminal = 0
        _GLOBAL_COUNTERS.events.clear()


def materialize_events() -> list[tuple[str, str, int]]:
    """Recent ``(kind, where, nbytes)`` materialization events (global)."""
    return _GLOBAL_COUNTERS.materialize_events()


def _value_nbytes(v: Any) -> int:
    return sum(st.nbytes_of(l) for l in pytree.tree_leaves(v)
               if hasattr(l, "shape") or isinstance(l, (int, float, bool)))


# ---------------------------------------------------------------------------
# ChunkStream: the unmerged stage-output value form (cross-stage handoff)
# ---------------------------------------------------------------------------


#: message of the late-merge raise on a stream whose buffers a stage
#: released.  The plan-time veto in ``handoff.analyze`` (observable producers
#: never donate) makes it unreachable; it stays as the runtime backstop.
DONATED_MERGE_ERROR = (
    "[MZ301] ChunkStream buffers were donated to a driver and can no longer "
    "be merged (handoff analysis bug: a donated stream was observed "
    "afterwards)")


class ChunkStream:
    """A stage output left as its chunk list + grid metadata.

    When every consumer of a node can ingest the producer's chunk grid
    directly (``core/handoff.py``), ``finish_stage`` stores one of these
    instead of merging: the merge -> re-split round trip at the stage
    boundary disappears.  The merge happens lazily, and only if the value is
    *observed* (a ``Future`` forces it, or a stream-incapable executor
    resolves it); ``materialize`` caches the merged value, so it is paid at
    most once.

    Two storage forms share this class.  The chunk-LIST form holds one
    tensor per grid range (the chunk-loop executors' output).  The STACKED
    form (``from_stacked``) holds the ``scan`` driver's output carry: one
    ``(n_chunks, batch, ...)`` leaf per pytree leaf (split axis moved to
    position 1) plus an optional ragged ``tail`` chunk, so a scan -> scan
    boundary hands the carry over untouched.  A chunk-loop consumer derives
    the chunk list from it (rows of the carry: views in torch, counted as
    the reference counts its unstack pass).
    """

    __slots__ = ("_chunks", "ranges", "split_type", "aval", "_merged",
                 "consumed", "donor", "stacked", "tail")

    def __init__(self, chunks: list | None, ranges: list,
                 split_type: st.SplitType, aval: Any):
        self._chunks = list(chunks) if chunks is not None else None
        self.ranges = [tuple(r) for r in ranges]
        self.split_type = split_type
        self.aval = aval                   # full-value pytree of meta tensors
        self._merged = None
        self.consumed = False              # buffers released after last use
        self.donor = ""                    # "stage N input K" that released them
        self.stacked = None                # (n_chunks, batch, ...) carry layout
        self.tail = None                   # ragged tail chunk (chunk-shaped)

    @classmethod
    def from_stacked(cls, stacked: Any, tail: Any, ranges: list,
                     split_type: st.SplitType, aval: Any) -> "ChunkStream":
        """Wrap a scan driver's output carry without unstacking it.

        ``stacked`` leaves are ``(n_chunks, batch, ...)`` with the split axis
        moved to position 1; ``tail`` is the ragged last chunk in normal
        chunk form, or None."""
        s = cls(None, ranges, split_type, aval)
        s.stacked = stacked
        s.tail = tail
        return s

    # -- aval-like surface (batch sizing reads .shape/.dtype) ---------------
    @property
    def shape(self):
        return self.aval.shape

    @property
    def dtype(self):
        return self.aval.dtype

    @property
    def ndim(self):
        return len(self.aval.shape)

    @property
    def n(self) -> int:
        return self.ranges[-1][1] if self.ranges else 0

    def _axis(self) -> int:
        ax = split_axis_of(self.split_type)
        return 0 if ax is None else ax

    def _empty_value(self) -> Any:
        """A zero-element value shaped like the aval (zero-chunk streams)."""
        return pytree.tree_map(
            lambda a: torch.zeros(tuple(a.shape), dtype=a.dtype), self.aval)

    def _check_live(self) -> None:
        if self.consumed:
            raise RuntimeError(DONATED_MERGE_ERROR
                               + f" [donated at {self.donor or 'unknown stage/edge'}]")

    def _row(self, i: int) -> Any:
        ax = self._axis()
        return pytree.tree_map(lambda l: l[i].movedim(0, ax) if ax else l[i],
                               self.stacked)

    @property
    def chunks(self) -> list:
        """The chunk list, deriving (and counting) it from stacked storage.

        A stacked stream pays this pass only when a chunk-loop consumer
        iterates it; a scan consumer uses ``stacked`` directly."""
        self._check_live()
        if self._chunks is None:
            k = len(self.ranges) - (1 if self.tail is not None else 0)
            derived = [self._row(i) for i in range(k)]
            if self.tail is not None:
                derived.append(self.tail)
            self._chunks = derived
            note_materialized(sum(_value_nbytes(c) for c in derived),
                              kind="unstack",
                              where=f"stream n={self.n} {self.split_type}")
        return self._chunks

    def chunk(self, i: int) -> Any:
        """Chunk ``i`` of the grid without deriving the whole list.

        Zero-element grids (``ranges == [(0, 0)]``) may carry no buffer at
        all; they resolve to an empty value built from the aval."""
        self._check_live()
        if self._chunks is None and self.stacked is not None:
            k = len(self.ranges) - (1 if self.tail is not None else 0)
            if i >= k and self.tail is not None:
                return self.tail
            piece = self._row(i)
            s, e = self.ranges[i]
            note_materialized(_value_nbytes(piece), kind="unstack",
                              where=f"stream chunk [{s},{e})")
            return piece
        if not self._chunks and self.n == 0:
            return self._empty_value()
        return self._chunks[i]

    def uniform_batch(self) -> int | None:
        """Chunk size when the grid is regular (ragged tail allowed)."""
        if not self.ranges:
            return None
        sizes = [e - s for s, e in self.ranges]
        body = sizes[:-1] or sizes
        return body[0] if len(set(body)) == 1 else None

    def compatible(self, consumer_type: st.SplitType) -> bool:
        return (not self.consumed
                and self.split_type.can_handoff(consumer_type))

    def materialize(self, terminal: bool = False) -> Any:
        """Merge (once) and return the full value; counts boundary bytes.

        ``terminal=True`` marks the merge as observation of a pipeline
        output (``Future.value``), accounted under ``bytes_terminal``."""
        if self._merged is None:
            self._check_live()
            if self.stacked is not None and self._chunks is None:
                self._merged = self._merge_stacked()
            elif not self._chunks:
                # Zero-chunk stream (empty pipeline): the aval names the
                # empty result.
                self._merged = self._empty_value()
            else:
                self._merged = self.split_type.merge(self._chunks)
            if (self._chunks is None and self.stacked is not None) \
                    or len(self._chunks or ()) > 1:
                note_materialized(_value_nbytes(self._merged),
                                  terminal=terminal, kind="materialize",
                                  where=f"stream n={self.n} {self.split_type}")
        return self._merged

    def _merge_stacked(self) -> Any:
        ax = self._axis()

        def flat(l):
            body = l.reshape((l.shape[0] * l.shape[1],) + tuple(l.shape[2:]))
            return body.movedim(0, ax) if ax else body

        main = pytree.tree_map(flat, self.stacked)
        if self.tail is None:
            return main
        return self.split_type.merge([main, self.tail])

    def release(self, donor: str) -> None:
        """Drop the buffers after their last consumer (the port's rendering
        of the reference's donation: the caching allocator reuses them); a
        later merge raises ``DONATED_MERGE_ERROR``."""
        self.consumed = True
        self.donor = self.donor or donor
        self._chunks = self.stacked = self.tail = None

    def __repr__(self) -> str:
        if self.consumed:
            form = "released"
        elif self._chunks is None and self.stacked is not None:
            form = "stacked"
        else:
            form = f"{len(self._chunks or ())} chunks"
        return f"ChunkStream({form}, n={self.n}, {self.split_type})"


def materialize(v: Any) -> Any:
    """ChunkStream -> merged value; anything else passes through."""
    return v.materialize() if isinstance(v, ChunkStream) else v


# ---------------------------------------------------------------------------
# Per-chunk chain driving (position-keyed)
# ---------------------------------------------------------------------------
#
# Chunk envs are keyed CANONICALLY — ``("in", input_position)`` for stage
# inputs and ``("n", node_position)`` for node outputs (``Stage.ckey``) —
# never by per-call node ids or value ids.


def chunk_env_for(stage: Stage, concrete: dict[tuple, Any], s: int, e: int,
                  pedantic: bool, chunk_index: int | None = None) -> dict[tuple, Any]:
    """Build one chunk's canonical env; a ``ChunkStream`` input supplies its
    chunk ``chunk_index`` (the range's piece, with no slice)."""
    resilience.maybe_fail("split", f"stage {stage.id} range [{s},{e})")
    env: dict[tuple, Any] = {}
    for key, si in stage.inputs.items():
        v = concrete[key]
        if isinstance(v, ChunkStream):
            env[stage.ckey(key)] = v.chunk(chunk_index)
            continue
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
                # Re-slicing another stage's merged output: the round trip
                # chunk handoff exists to remove.
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
    narrowed: dict = {}      # one narrowed copy per 64-bit tensor of this env
    for fn, out_key, srcs in plan:
        kw = {name: (static if key is None else env[key])
              for name, key, static in srcs}
        env[out_key] = fn.call_eager(kw, narrowed)


def run_chain(stage: Stage, env: dict[tuple, Any]) -> None:
    """Drive one (canonically keyed) chunk env through the stage chain."""
    run_plan(chain_plan(stage), env)


def finish_stage(stage: Stage, partials: dict[int, list[Any]],
                 ranges: list[tuple[int, int]] | None = None,
                 ctx=None) -> None:
    """Merge per-chunk partials (keyed by stage-local node POSITION).

    With handoff decisions active (``ctx._handoff``), nodes whose every
    consumer accepts the producer grid stay UNMERGED as a
    :class:`ChunkStream` over ``ranges``; the merge happens lazily and only
    if the value is observed."""
    resilience.maybe_fail("merge", f"stage {stage.id}")
    ho = None
    if ctx is not None and ranges is not None:
        plan = getattr(ctx, "_handoff", None)
        ho = plan.get(stage.id) if plan else None
    for node in stage.nodes:
        p = stage.pos[node.id]
        if p in partials:
            t = stage.out_types[node.id]
            pieces = partials[p]
            if (ho is not None and p in ho.stream_out
                    and len(pieces) == len(ranges) and len(pieces) > 1):
                node.result = ChunkStream(pieces, ranges, t, node.out_aval)
                ctx.stats["streamed_outputs"] += 1
            else:
                node.result = t.merge(pieces)
                if len(pieces) > 1 and not isinstance(t, st.ScalarSplit):
                    note_materialized(_value_nbytes(node.result), kind="merge",
                                      where=f"stage {stage.id} node {p}")
        node.done = True


# ---------------------------------------------------------------------------
# Pinned executables
# ---------------------------------------------------------------------------


def pinned_exec(stage: Stage, ctx, kind: str, extra_key: tuple,
                build: Callable[[], Any]) -> Any:
    """One built driver (or lowered program) per (plan entry, stage
    position, kind, extra_key).

    When the stage belongs to a cached plan, what ``build()`` returns is
    pinned into the entry's executable table (``PlanEntry.exec_table``):
    every later instantiation of the same template, in this session or any
    other, reuses it, so a warm call builds nothing.  What ``build`` returns
    must not hold the Stage or concrete values (drivers close over
    ``chain_plan``; a lowered program is plain data).
    Without an entry (uncacheable plan) the table lives on the Stage, which
    keeps same-call reuse (tuner candidates, warm-up-then-time runs)."""
    key = (stage.id, kind) + tuple(extra_key)
    entry = getattr(ctx, "_plan_entry", None)
    table = entry.exec_table() if entry is not None else None
    if table is None:
        table = getattr(stage, "_exec_cache", None)
        if table is None:
            table = stage._exec_cache = {}
    if key not in table:
        resilience.maybe_fail("compile", f"stage {stage.id} {kind}")
        table[key] = build()
        ctx.stats["exec_builds"] += 1
    return table[key]


def has_dynamic(stage: Stage) -> bool:
    return any(
        getattr(n.fn.sa, "dynamic", False) or n.out_aval is None
        for n in stage.nodes
    )


# ---------------------------------------------------------------------------
# Stream-aware input resolution (cross-stage handoff)
# ---------------------------------------------------------------------------


def adapt_stream(v: "ChunkStream", consumer: st.SplitType) -> "ChunkStream | None":
    """Reinterpret a fresh-output (ConcatSplit) stream under the consumer's
    concrete grid: the runtime half of the ConcatSplit -> {ArraySplit,
    PytreeSplit} handoff rules.

    The piece sizes are read off the chunk buffers; when they tile the
    consumer's geometry the SAME buffers are re-wrapped under the consumer's
    split type (zero copies).  An ArraySplit consumer takes single-leaf
    chunks; a PytreeSplit consumer decides per leaf (every leaf of a chunk
    must agree on its split-axis extent).  None when the pieces do not form
    the consumer's grid; the caller materializes instead."""
    if not isinstance(v.split_type, st.ConcatSplit) or v._chunks is None:
        return None
    if isinstance(consumer, st.ArraySplit) and consumer.shape:
        ax, total = consumer.axis, consumer.shape[consumer.axis]
        sizes = []
        for c in v._chunks:
            leaves = pytree.tree_leaves(c)
            if len(leaves) != 1 or len(getattr(leaves[0], "shape", ())) <= ax:
                return None
            sizes.append(int(leaves[0].shape[ax]))
    elif isinstance(consumer, st.PytreeSplit):
        ax, total = consumer.axis, consumer.length
        sizes = []
        for c in v._chunks:
            leaf_sizes = set()
            for l in pytree.tree_leaves(c):
                shp = getattr(l, "shape", ())
                if len(shp) <= ax:
                    return None
                leaf_sizes.add(int(shp[ax]))
            if len(leaf_sizes) != 1:   # leaves disagree (or chunk is leafless)
                return None
            sizes.append(leaf_sizes.pop())
    else:
        return None
    if sum(sizes) != total:
        return None
    ranges, s = [], 0
    for z in sizes:
        ranges.append((s, s + z))
        s += z
    if not ranges:                     # zero-chunk stream of an empty value
        ranges = [(0, 0)]
    return ChunkStream(v._chunks, ranges, consumer, v.aval)


def resolve_stage_inputs(stage: Stage, graph: DataflowGraph, ctx,
                         streams_ok: bool, tally: bool = True) -> dict[tuple, Any]:
    """Resolve stage inputs, ingesting producer ChunkStreams where allowed.

    An input keeps its stream form only when (a) the executor can iterate a
    chunk list (``streams_ok``), (b) the handoff decisions mark this input
    position as a stream ingest, and (c) the stream's grid fits the input's
    split type at run time (cross-evaluation edges carry whatever grid the
    previous evaluation produced).  A permitted ConcatSplit -> {ArraySplit,
    PytreeSplit} edge re-wraps the producer's pieces under the consumer's
    grid (``adapt_stream``).  Anything else is materialized, with a
    zero-byte ``fallback`` event naming the reason.  ``tally=False`` skips
    the ingest/materialize stats and the ``ingest`` fault boundary."""
    if tally:
        resilience.maybe_fail("ingest", f"stage {stage.id}")
    plan = getattr(ctx, "_handoff", None)
    ho = plan.get(stage.id) if plan else None
    concrete: dict[tuple, Any] = {}
    for i, (key, si) in enumerate(stage.inputs.items()):
        v = graph.resolve(si.value)
        if isinstance(v, ChunkStream):
            reason = _stream_fallback_reason(v, si, i, ho, streams_ok)
            if reason is None and type(v.split_type) is not type(si.split_type):
                # Grid conversion only where the decisions permit it.
                if i in ho.convert_in:
                    adapted = adapt_stream(v, si.split_type)
                    if adapted is None:
                        reason = "non-tiling ConcatSplit pieces"
                    else:
                        v = adapted
                        if tally:
                            ctx.stats["stream_converted"] += 1
                else:
                    reason = "grid conversion not planned"
            if reason is None:
                if tally:
                    ctx.stats["stream_ingests"] += 1
            else:
                if tally:
                    note_materialized(
                        0, kind="fallback",
                        where=f"[MZ203] stage {stage.id} input "
                              f"{stage.ckey(key)}: {reason}")
                v = v.materialize()
                if tally:
                    ctx.stats["stream_materialized"] += 1
        concrete[key] = v
    return concrete


def regrid_stream(stage: Stage, ctx, key: tuple, v: "ChunkStream",
                  grid: list[tuple[int, int]]) -> "ChunkStream":
    """``v`` moved onto ``grid`` by ``SplitType.rechunk`` (at most one
    copy, counted as interior bytes and in ``handoff_rechunks``)."""
    chunks, copied = v.split_type.rechunk(v.chunks, v.ranges, grid)
    note_materialized(copied, kind="rechunk",
                      where=f"stage {stage.id} input {stage.ckey(key)}")
    ctx.stats["handoff_rechunks"] += 1
    return ChunkStream(chunks, grid, v.split_type, v.aval)


def _stream_fallback_reason(v: "ChunkStream", si, i: int, ho,
                            streams_ok: bool) -> str | None:
    """Why this stream input must materialize, or None to ingest it."""
    if not streams_ok:
        return "stream-incapable executor"
    if ho is None or i not in ho.stream_in:
        return "edge not planned for streaming"
    if v.consumed:
        return "stream already donated"
    if not v.split_type.can_handoff(si.split_type):
        pa, ca = split_axis_of(v.split_type), split_axis_of(si.split_type)
        if pa is not None and ca is not None and pa != ca:
            return f"axis mismatch (producer axis {pa}, consumer axis {ca})"
        return f"grid geometry mismatch ({v.split_type} vs {si.split_type})"
    return None


# ---------------------------------------------------------------------------
# Chunk-buffer donation (shared by the fused / scan / cuda drivers)
# ---------------------------------------------------------------------------
#
# The DECISIONS are the reference's: which input positions are donation
# points (``donatable_input_keys``), which of those must not give up their
# buffers because the producer is still observable
# (``undonatable_stream_keys``), and which count in ``donated_chunks``.  The
# mechanism differs: torch has no buffer donation, and every annotated
# function returns fresh tensors, so nothing is ever written into a buffer a
# live Future can see.  A dead stream's buffers are RELEASED after the stage
# consumed them (``mark_stream_consumed``), which lets the caching allocator
# reuse them; an observable one keeps them, with no defensive copy
# (``donation_copies`` stays 0 where the reference copies).


def _aval_sig(aval) -> tuple:
    return tuple((tuple(l.shape), str(l.dtype))
                 for l in pytree.tree_leaves(aval) if hasattr(l, "shape"))


def donatable_input_keys(stage: Stage, ctx) -> tuple:
    """Canonical env keys of inputs whose per-chunk buffers die here.

    Structural: the stage is the handed-off value's LAST in-plan consumer
    (the plan-time veto in ``handoff.analyze`` already excluded observable
    producers), the input is NodeRef-sourced and splittable, and an escaping
    output of the same shape and dtype could take its buffer (at most one
    input per such output, as the reference's XLA donation)."""
    plan = getattr(ctx, "_handoff", None)
    ho = plan.get(stage.id) if plan else None
    if ho is None or not ho.last_use:
        return ()
    out_sigs: dict[tuple, int] = {}
    for n in stage.nodes:
        if (n.id in stage.escaping and n.out_aval is not None
                and stage.out_types[n.id].splittable):
            sig = _aval_sig(n.out_aval)
            out_sigs[sig] = out_sigs.get(sig, 0) + 1
    keys = []
    for i, (key, si) in enumerate(stage.inputs.items()):
        if not (i in ho.last_use and isinstance(si.value, NodeRef)
                and si.split_type.splittable):
            continue
        node = ctx.graph.nodes.get(si.value.node_id)
        aval = node.out_aval if node is not None else None
        if aval is not None and out_sigs.get(_aval_sig(aval), 0) > 0:
            out_sigs[_aval_sig(aval)] -= 1
            keys.append(stage.ckey(key))
    return tuple(sorted(keys))


def undonatable_stream_keys(stage: Stage, concrete: dict[tuple, Any], ctx,
                            donate: tuple) -> set:
    """Donate-marked keys whose ChunkStream may still be observed (the
    producer's Future is alive): their buffers are kept."""
    unsafe = set()
    for key, si in stage.inputs.items():
        ck = stage.ckey(key)
        if ck in donate and isinstance(concrete.get(key), ChunkStream):
            node = ctx.graph.nodes.get(si.value.node_id)
            if node is None or node.future_alive():
                unsafe.add(ck)
    return unsafe


def mark_stream_consumed(stage: Stage, concrete: dict[tuple, Any], ctx,
                         consumed: "set | frozenset | tuple") -> None:
    """After the stage consumed the canonical keys in ``consumed``: release
    the stream AND its graph-node original, so a late ``materialize`` hits
    the backstop error instead of returning released buffers.  Each input
    released counts in ``ctx.stats["streams_released"]``: an attempt that
    moved it is never re-driven (``resilience._recoverable``)."""
    for key, si in stage.inputs.items():
        v = concrete.get(key)
        if stage.ckey(key) in consumed and isinstance(v, ChunkStream):
            donor = f"stage {stage.id} input {stage.ckey(key)}"
            orig = ctx.graph.nodes[si.value.node_id].result
            for t in {id(v): v, id(orig): orig}.values():
                if isinstance(t, ChunkStream):
                    t.release(donor)
            ctx.stats["streams_released"] += 1


def materialize_inputs(stage: Stage, concrete: dict[tuple, Any],
                       ctx=None) -> dict[tuple, Any]:
    """Merge any stream inputs (paths that need whole tensors)."""
    out = dict(concrete)
    for key, v in concrete.items():
        if isinstance(v, ChunkStream):
            out[key] = v.materialize()
            if ctx is not None:
                ctx.stats["stream_materialized"] += 1
    return out


def split_axis_of(t: st.SplitType) -> int | None:
    if isinstance(t, (st.ArraySplit, st.PytreeSplit)):
        return t.axis
    return None


def _block_stage_outputs(stage: Stage) -> None:
    """Wait for the card, so tuner timings measure real work (a no-op for
    stages on the CPU)."""
    for node in stage.nodes:
        if node.id in stage.escaping and node.result is not None:
            r = node.result
            if isinstance(r, ChunkStream):
                # Raw storage, never the derived chunk list: blocking must
                # not charge an unstack pass to the boundary counters.
                r = [x for x in (r._chunks, r.stacked, r.tail) if x is not None]
            for leaf in pytree.tree_leaves(r):
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
                    return


def candidate_batches(est: int, n: int) -> list[int]:
    """2-3 chunk sizes around the §5.2 fast-memory estimate."""
    if n <= 0:
        return [1]                    # empty split: nothing to tune
    est = max(1, min(est, n))
    if est >= n:
        return [n]                    # one chunk: nothing to tune
    cands = {max(1, est // 2), est, min(est * 2, n)}
    return sorted(cands)


#: chunks per timed sample when the tuner measures a candidate: a couple of
#: chunks, extrapolated, bound the first cached run's overhead to well under
#: one extra full execution (``StageExecutor.sampled_time``).
SAMPLE_CHUNKS = 2


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------


class StageExecutor:
    """One execution strategy: split inputs → drive chunks → merge partials.

    Subclasses implement ``execute``; ``run`` is the template method the
    runtime calls per stage.  It resolves concrete inputs, runs the
    chunk-size auto-tuner on the first execution of a *cached* plan, and
    does the done/stats bookkeeping shared by every strategy.
    """

    name: str = "abstract"
    #: whether ``choose_batch`` output affects this strategy: only tunable
    #: executors take part in chunk-size auto-tuning.
    tunable: bool = False
    #: whether ``execute`` can iterate a ChunkStream input directly (the
    #: chunk-loop drivers can; whole-value strategies materialize instead).
    stream_capable: bool = False

    # -- template method ----------------------------------------------------
    def run(self, stage: Stage, graph: DataflowGraph, ctx) -> None:
        concrete = resolve_stage_inputs(stage, graph, ctx, self.stream_capable)
        entry = getattr(ctx, "_plan_entry", None)
        if self._should_tune(stage, ctx, entry):
            self._tune(stage, concrete, ctx, entry)
        else:
            self.execute(stage, concrete, ctx)
        ctx.stats["stages"] += 1
        for node in stage.nodes:
            node.done = True

    def execute(self, stage: Stage, concrete: dict[tuple, Any], ctx) -> None:
        raise NotImplementedError

    # -- batch sizing (paper §5.2 + auto-tuner) -----------------------------
    def estimate_batch(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                       n: int) -> int:
        elem_bytes = stage_elem_bytes(stage, concrete, n)
        return hardware.mozart_batch_elements(elem_bytes, ctx.chip)

    def choose_batch(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                     n: int) -> int:
        override = getattr(ctx, "_batch_override", None)
        if override is not None:
            return max(1, min(override, n))
        if ctx.batch_elements:
            return max(1, min(ctx.batch_elements, n))
        entry = getattr(ctx, "_plan_entry", None)
        if entry is not None:
            pinned = entry.tuned_batch.get(stage.id)
            if pinned:
                return max(1, min(pinned, n))
        return max(1, min(self.estimate_batch(stage, concrete, ctx, n), n))

    # -- auto-tuner ---------------------------------------------------------
    def _should_tune(self, stage: Stage, ctx, entry) -> bool:
        return (
            self.tunable
            and entry is not None
            and entry.hits > 0                      # first execution of a CACHED plan
            and getattr(ctx, "autotune", True)
            and not ctx.batch_elements
            and getattr(ctx, "_batch_override", None) is None
            and stage.id not in entry.tuned_batch
            # dynamic functions may have side effects and value-dependent
            # run times: never re-execute them to time them
            and not has_dynamic(stage)
            # claim atomically so concurrent sessions never tune in duplicate
            and entry.try_claim_tuning(stage.id)
        )

    def _tune(self, stage: Stage, concrete: dict[tuple, Any], ctx, entry) -> None:
        pinned = False
        try:
            n = stage_num_elements(stage, concrete, ctx.pedantic)
            est = self.estimate_batch(stage, concrete, ctx, n)
            cands = self.tuning_candidates(stage, concrete, ctx, est, n)
            if len(cands) == 1:
                entry.pin(stage.id, cands[0])
                pinned = True
                self.execute(stage, concrete, ctx)
                return
            # Sampled tuning re-slices inputs at arbitrary offsets: a one-time
            # event, so streams are merged rather than complicating sampling
            # (and only when there is something to measure).
            concrete = materialize_inputs(stage, concrete, ctx)
            best, best_dt = None, None
            for b in cands:
                try:
                    dt = self.sampled_time(stage, concrete, ctx, b, n)
                except resilience.PROBE_ERRORS as e:
                    # unsampleable candidate: skip it, counted (a kernel
                    # fault re-raises from note_swallowed)
                    resilience.note_swallowed("tune_sample", e, ctx)
                    continue
                entry.record_trial(stage.id, b, dt)
                if best_dt is None or dt < best_dt:
                    best, best_dt = b, dt
            entry.pin(stage.id, best if best is not None else est)
            pinned = True
            if best is not None:
                ctx.stats["autotuned_stages"] += 1
        finally:
            if not pinned:
                entry.release_tuning(stage.id)
        # One real execution with the pinned size produces the stage results
        # (the sampled runs above computed throwaway partial outputs only).
        self.execute(stage, concrete, ctx)

    # -- sampled measurement ------------------------------------------------
    def tuning_candidates(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                          est: int, n: int) -> list[int]:
        """Chunk-size candidates the tuner measures (the §5.2 bracket by
        default; ``cuda`` rounds them to the kernel's tiles)."""
        return candidate_batches(est, n)

    def sample_elems(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                     batch: int, n: int) -> int:
        """Elements one timed sample re-executes: ``SAMPLE_CHUNKS`` chunks."""
        return min(n, SAMPLE_CHUNKS * batch) if n > 0 else 0

    def sampled_time(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                     batch: int, n: int, elems: int | None = None) -> float:
        """Estimated seconds for a full stage execution at ``batch``,
        measured on a bounded sample.

        Splits every splittable input down to ``elems`` elements (by default
        ``sample_elems``; ``cost_model`` passes one size for every candidate
        of a stage, so none is extrapolated from a smaller sample),
        runs the stage twice (the first run absorbs one-time builds; the
        second is timed, ending in a wait for the card) and extrapolates
        linearly to ``n`` elements.  ``ctx.stats["tuning_sample_elems"]``
        accrues the elements re-executed."""
        batch = max(1, min(batch, n)) if n > 0 else 1
        s = self.sample_elems(stage, concrete, ctx, batch, n) if elems is None else elems
        sample: dict[tuple, Any] = {}
        for key, si in stage.inputs.items():
            v = concrete[key]
            sample[key] = (si.split_type.split(v, 0, s)
                           if si.split_type.splittable else v)
        prev_cap = getattr(ctx, "_n_cap", None)
        prev_override = ctx._batch_override
        ctx._n_cap = s
        ctx._batch_override = batch
        try:
            self.execute(stage, sample, ctx)
            _block_stage_outputs(stage)
            t0 = time.perf_counter()
            self.execute(stage, sample, ctx)
            _block_stage_outputs(stage)
            dt = time.perf_counter() - t0
        finally:
            ctx._n_cap = prev_cap
            ctx._batch_override = prev_override
        ctx.stats["tuning_sample_elems"] += 2 * s
        return dt * (n / s) if s else dt
