"""The AOT pipeline API: ``mozart.pipeline`` — trace -> plan -> compile -> call.

The counterpart of ``src/repro/core/pipeline.py``.  ``mozart.session``
scopes *configuration* and evaluates whatever lazy graph the enclosed code
builds.  For serving-shaped workloads the pipeline is fixed and the per-call
budget is tiny, so this module gives a whole Mozart program an explicit
ahead-of-time lifecycle:

    p = mozart.pipeline(fn, executor="cuda", plan_cache_path="plans.json")
    p.lower(x, y)        # build the dataflow graph once, resolve a PlanEntry
    p.compile()          # pin batches, executors, drivers and kernel programs
    out = p(x, y)        # hot path: split -> drive pinned drivers -> merge

* ``lower(*args)`` traces ``fn`` lazily (nothing executes), fingerprints the
  captured graph and resolves its plan-cache entry: planning happens here,
  never on the hot path.
* ``compile()`` runs the pipeline on the lowered example until a pass is
  warm: the chunk-size tuner has pinned, ``auto`` has measured and pinned
  per-stage executors, and every per-stage driver and lowered kernel
  program is built and pinned into the entry's executable table (keyed by
  stage position, so later calls reuse them).
* ``__call__`` is the steady-state path: re-capture the (cheap, Python)
  graph, hit the plan cache, split inputs, drive the pinned executables and
  merge: zero planner calls and zero traces or lowerings, asserted through
  ``stage_exec.trace_count()`` deltas in ``last_call_stats["jit_traces"]``.

``mozart.session`` is an anonymous Pipeline's ``scope()``
(``runtime.session``), so both entry points share one lifecycle and one
cache.  The default device is the card, as for a session.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Any, Callable

from torch.utils import _pytree as pytree

from repro_torch.core import resilience, stage_exec
from repro_torch.core.annotation import canonicalize_tensors
from repro_torch.core.future import Future
from repro_torch.core.graph import NodeRef
from repro_torch.core.handoff import resolve_decisions
from repro_torch.core.plan_cache import _mark_dirty, lookup_or_plan, save
from repro_torch.core.runtime import MozartContext, _stack

#: compile() runs at most this many passes while converging to the pinned
#: steady state (plan -> measure/tune -> build -> quiescent).
MAX_COMPILE_PASSES = 6

#: per-call counters that must all be zero for a call to count as "warm".
WARM_STATS = ("planner_calls", "autotuned_stages", "auto_measured_stages",
              "jit_traces")


def _force(out: Any) -> Any:
    """Materialize every Future in a (possibly nested) return value."""
    if isinstance(out, Future):
        return out.value
    if isinstance(out, (list, tuple)):
        forced = [_force(o) for o in out]
        if hasattr(out, "_fields"):              # namedtuple
            return type(out)(*forced)
        return type(out)(forced)
    if isinstance(out, dict):
        return {k: _force(v) for k, v in out.items()}
    return out


#: sentinel: the fast path declined this call (shape/alias/value mismatch).
_NO_FAST = object()


@dataclasses.dataclass
class _FastReplay:
    """Retained capture for the bound-arguments fast path.

    When the wrapped fn is marked *arg-transparent* (its argument tensors
    flow into annotated calls unmodified and the captured graph's structure
    does not depend on argument values), re-capturing and re-fingerprinting
    the graph per call buys nothing: the SAME node set is re-executed with
    this call's tensors rebound in place.  Built once after ``compile()``;
    any call whose argument treespec, shapes/dtypes/devices, alias pattern
    or non-tensor values diverge from the example takes the full path."""

    pending: list                        # retained (pinned) Node objects
    stages: list                         # their instantiated Stage objects
    entry: Any                           # resolved plan-cache entry (or None)
    handoff: Any                         # handoff decisions used at build
    out: Any                             # fn's return structure (holds Futures)
    treespec: Any                        # example (args, kwargs) treespec
    leaf_specs: list                     # per-leaf ("arr", ...) | ("val", v)
    alias_sig: tuple                     # first-occurrence index per tensor leaf
    node_bindings: list                  # (node index, argname, leaf slot)
    input_bindings: list                 # (stage index, input key, leaf slot)


def _leaf_spec(l: Any):
    if hasattr(l, "shape") and hasattr(l, "dtype"):
        dev = getattr(l, "device", None)
        return ("arr", tuple(l.shape), str(l.dtype), str(dev))
    return ("val", l)


def _alias_sig(leaves: list) -> tuple:
    first: dict[int, int] = {}
    return tuple(first.setdefault(id(l), j) for j, l in enumerate(leaves)
                 if hasattr(l, "shape"))


class Pipeline:
    """An ahead-of-time-compilable Mozart program (see module docstring)."""

    def __init__(self, fn: Callable | None, **config):
        self.fn = fn
        #: user promise: argument tensors reach annotated calls unmodified and
        #: graph structure is value-independent -> warm calls may skip graph
        #: capture and fingerprinting entirely (the bound-arguments fast path).
        self.arg_transparent = bool(config.pop("arg_transparent", False))
        self.ctx = MozartContext(**config)
        self._lock = threading.RLock()
        self._example: tuple | None = None       # (args, kwargs) from lower()
        self._entry = None                       # resolved plan_cache.PlanEntry
        self._fast: _FastReplay | None = None
        self.compiled = False
        # stat deltas of the most recent call (with ``jit_traces``, the
        # stage_exec trace-counter delta); read through ``last_call_stats``
        # or, for concurrent callers, ``call_with_stats()``.
        self._last_call_stats: dict[str, int] = {}
        #: bucket label -> resolved PlanEntry, one per ``compile(bucket=...)``.
        self._buckets: dict[tuple, Any] = {}

    # -- session compatibility ----------------------------------------------
    @contextlib.contextmanager
    def scope(self):
        """Enter this pipeline's context as the ambient Mozart scope:
        annotated calls made inside register against it, evaluation is
        flushed at scope exit, and (when configured) plans are persisted."""
        ctx = self.ctx
        _stack().append(ctx)
        try:
            yield ctx
            ctx.evaluate()                       # flush at scope exit
            if ctx.plan_cache_path:
                save(ctx.plan_cache_path)        # persist plans + decisions
        finally:
            _stack().pop()

    # -- AOT lifecycle -------------------------------------------------------
    def lower(self, *args, **kwargs) -> "Pipeline":
        """Trace ``fn`` into a dataflow graph and resolve its plan entry.

        Nothing executes: the captured nodes are planned (or matched against
        the plan cache) and then discarded.  The arguments become the example
        ``compile()`` specializes to."""
        self._require_fn()
        args, kwargs = canonicalize_tensors((args, kwargs))
        with self._lock:
            ctx = self.ctx
            _stack().append(ctx)
            try:
                ctx.stats["graph_captures"] += 1
                out = self.fn(*args, **kwargs)
            finally:
                _stack().pop()
            pending = ctx.graph.pending()
            entry = None
            if pending:
                _stages, entry = lookup_or_plan(pending, ctx.graph, ctx)
            # lower never executes: drop the traced nodes (their Futures die
            # with `out`) so they cannot leak into the next evaluation.
            for n in pending:
                n.done = True
            del out
            ctx.graph.prune()
            self._example = (args, kwargs)
            self._entry = entry
            return self

    def compile(self, *args, bucket: tuple | None = None, **kwargs) -> "Pipeline":
        """Drive the pipeline to its pinned steady state.

        Runs the lowered example repeatedly (at most ``MAX_COMPILE_PASSES``)
        until a pass makes zero planner calls, zero tuning/measurement runs
        and zero traces or lowerings.  ``bucket`` labels the plan entry this
        example resolves to (a serving scheduler's shape bucket) and records
        it in ``self.buckets``; one pipeline may pin many buckets."""
        self._require_fn()
        if args or kwargs:
            self._example = (args, kwargs)
        if self._example is None:
            raise ValueError(
                "compile() needs example arguments: call p.lower(*args) "
                "first or pass them directly: p.compile(*args)")
        a, kw = self._example
        for _ in range(MAX_COMPILE_PASSES):
            self(*a, **kw)
            if all(self.last_call_stats.get(k, 0) == 0 for k in WARM_STATS):
                break
        else:
            warnings.warn(
                f"{self!r} did not reach the warm fixed point after "
                f"{MAX_COMPILE_PASSES} passes (last call: "
                f"{self.last_call_stats}); the pipeline is likely "
                "uncacheable (unfingerprintable values / plan_cache=False) "
                "and every call will replan", RuntimeWarning, stacklevel=2)
        if bucket is not None:
            # Resolve this example's plan entry (a hit after the warm loop
            # above) and stamp the bucket label on it.
            self.lower(*a, **kw)
            entry = self._entry
            if entry is not None:
                with entry._lock:
                    relabelled = entry.bucket != tuple(bucket)
                    entry.bucket = tuple(bucket)
                if relabelled:
                    _mark_dirty()                # the label persists too
            with self._lock:
                self._buckets[tuple(bucket)] = entry
        if self.ctx.plan_cache_path:
            save(self.ctx.plan_cache_path)
        self.compiled = True
        return self

    def __call__(self, *args, **kwargs):
        """Hot path: capture, cache hit, split, drive pinned drivers, merge.

        With ``arg_transparent=True`` and a completed ``compile()``, warm
        calls skip even the capture: the retained node set is re-executed
        with this call's tensors rebound (``_FastReplay``).  64-bit tensor
        arguments are narrowed first (``annotation.canonicalize_tensors``),
        as every annotated call narrows them."""
        self._require_fn()
        args, kwargs = canonicalize_tensors((args, kwargs))
        with self._lock:
            ctx = self.ctx
            before = dict(ctx.stats)
            traces_before = stage_exec.trace_count()
            result = _NO_FAST
            if self._fast is not None:
                result = self._fast_call(args, kwargs)
            if result is _NO_FAST:
                _stack().append(ctx)
                try:
                    ctx.stats["graph_captures"] += 1
                    out = self.fn(*args, **kwargs)
                    if (self.arg_transparent and self.compiled
                            and self._fast is None):
                        result = self._build_fast(out, args, kwargs)
                    if result is _NO_FAST:
                        ctx.evaluate()
                        result = _force(out)
                finally:
                    _stack().pop()
                ctx.graph.prune()
            delta = {k: v - before.get(k, 0)
                     for k, v in ctx.stats.items() if v != before.get(k, 0)}
            delta["jit_traces"] = stage_exec.trace_count() - traces_before
            self._last_call_stats = delta
            return result

    def call_with_stats(self, *args, **kwargs):
        """``(result, stats_delta)`` for one call, atomically: the pipeline
        lock is held across call and read, so each concurrent caller gets
        exactly its own delta."""
        with self._lock:
            result = self(*args, **kwargs)
            return result, dict(self._last_call_stats)

    # -- bound-arguments fast path -------------------------------------------
    def _run_stages(self, stages, entry, ho) -> None:
        ctx = self.ctx
        prev = (ctx._plan_entry, ctx._handoff)
        ctx._plan_entry, ctx._handoff = entry, ho
        try:
            with stage_exec.counter_scope(ctx.counters):
                for s in stages:
                    resilience.run_stage(ctx.executor, s, ctx.graph, ctx)
        finally:
            ctx._plan_entry, ctx._handoff = prev

    def _build_fast(self, out, args, kwargs):
        """One execution that RETAINS the captured node set.

        Runs inside the capture scope.  Returns the forced result, or
        ``_NO_FAST`` when the bindings cannot be proven re-executable (an
        argument tensor never reaches a node's bound arguments, or is bound
        to a static parameter); the caller then evaluates normally and the
        fast path stays off."""
        ctx = self.ctx
        pending = ctx.graph.pending()
        if not pending:
            return _NO_FAST
        pending_ids = {n.id for n in pending}
        for n in pending:
            for v in n.bound.values():
                if isinstance(v, NodeRef) and v.node_id not in pending_ids:
                    # The fn forces evaluation internally: the retained set
                    # would reference DONE producers of the build call.
                    return _NO_FAST
        stages, entry = lookup_or_plan(pending, ctx.graph, ctx)
        # The rewrite pass (inside lookup_or_plan) may have retired nodes and
        # reordered the rest: the retained set is the REWRITTEN live graph.
        # A decline below re-enters lookup_or_plan through evaluate(), where
        # the pass is a no-op on its own output.
        live = ctx.graph.pending()
        if not live:
            return _NO_FAST              # everything rewritten away
        leaves, treespec = pytree.tree_flatten((args, kwargs))
        slot_of = {id(l): j for j, l in enumerate(leaves)}
        node_bindings, bound_ids = [], set()
        for idx, n in enumerate(live):
            for name, v in n.bound.items():
                if isinstance(v, NodeRef) or id(v) not in slot_of:
                    continue
                if name in n.fn.sa.static:
                    return _NO_FAST      # value baked into pinned drivers
                node_bindings.append((idx, name, slot_of[id(v)]))
                bound_ids.add(id(v))
        for l in leaves:
            if hasattr(l, "shape") and id(l) not in bound_ids:
                return _NO_FAST          # tensor arg never reaches a node
        input_bindings = []
        for s_idx, s in enumerate(stages):
            for key, si in s.inputs.items():
                if not isinstance(si.value, NodeRef) and id(si.value) in slot_of:
                    input_bindings.append((s_idx, key, slot_of[id(si.value)]))
        ho = resolve_decisions(ctx, entry, stages)
        self._run_stages(stages, entry, ho)
        for n in live:
            n.pinned = True              # survive prune(): re-executed per call
        self._fast = _FastReplay(
            pending=live, stages=stages, entry=entry, handoff=ho, out=out,
            treespec=treespec, leaf_specs=[_leaf_spec(l) for l in leaves],
            alias_sig=_alias_sig(leaves), node_bindings=node_bindings,
            input_bindings=input_bindings)
        return self._force_and_release(out)

    def _fast_call(self, args, kwargs):
        """Re-execute the retained node set with this call's tensors rebound.

        Validates treespec, per-leaf shapes/dtypes/devices, the identity
        alias pattern of tensor leaves and equality of non-tensor leaves
        against the build-time example; any divergence returns ``_NO_FAST``
        (full capture handles the call, the retained replay stays valid)."""
        f = self._fast
        leaves, treespec = pytree.tree_flatten((args, kwargs))
        if treespec != f.treespec or _alias_sig(leaves) != f.alias_sig:
            return _NO_FAST
        for l, spec in zip(leaves, f.leaf_specs):
            if spec[0] == "arr":
                if _leaf_spec(l) != spec:
                    return _NO_FAST
            elif hasattr(l, "shape") or type(l) is not type(spec[1]) or l != spec[1]:
                return _NO_FAST          # non-tensor args are specialized
        for idx, name, slot in f.node_bindings:
            f.pending[idx].bound[name] = leaves[slot]
        for s_idx, key, slot in f.input_bindings:
            f.stages[s_idx].inputs[key].value = leaves[slot]
        for n in f.pending:
            n.result = None
            n.done = False
        self._run_stages(f.stages, f.entry, f.handoff)
        self.ctx.stats["fast_path_calls"] += 1
        return self._force_and_release(f.out)

    def _force_and_release(self, out):
        """Force the retained capture's outputs, then drop every retained
        node's result (and the arguments bound to it): the replay keeps the
        node set between calls, not the previous call's tensors."""
        result = _force(out)
        f = self._fast
        for n in f.pending:
            n.result = None
        for idx, name, _slot in f.node_bindings:
            f.pending[idx].bound[name] = None
        for s_idx, key, _slot in f.input_bindings:
            f.stages[s_idx].inputs[key].value = None
        return result

    # -- introspection -------------------------------------------------------
    @property
    def plan_entry(self):
        """The resolved plan-cache entry (after ``lower``/first call)."""
        return self._entry if self._entry is not None else self.ctx._plan_entry

    @property
    def last_call_stats(self) -> dict:
        """Snapshot of the most recent call's stat deltas."""
        with self._lock:
            return dict(self._last_call_stats)

    @last_call_stats.setter
    def last_call_stats(self, value: dict) -> None:
        with self._lock:
            self._last_call_stats = dict(value)

    @property
    def buckets(self) -> dict:
        """Bucket label -> pinned plan entry, from ``compile(bucket=...)``."""
        with self._lock:
            return dict(self._buckets)

    @property
    def stats(self):
        """Cumulative context stats across every call of this pipeline."""
        return self.ctx.stats

    def warm(self) -> bool:
        """True when the most recent call ran at pinned steady state."""
        stats = self.last_call_stats          # one lock-consistent snapshot
        return bool(stats) and all(stats.get(k, 0) == 0 for k in WARM_STATS)

    def describe(self) -> str:
        e = self.plan_entry
        name = getattr(self.fn, "__name__", self.fn)
        if e is None:
            return f"Pipeline({name}): not lowered"
        return (f"Pipeline({name}): "
                f"{len(e.stage_templates)} stage(s), "
                f"tuned_batch={dict(e.tuned_batch)}, "
                f"block_shape={dict(e.block_shape)}, "
                f"chosen_exec={dict(e.chosen_exec)}, "
                f"executables={sorted(e.exec_table())}")

    def verify(self, *args, **kwargs):
        """Static analysis of this pipeline (never executes it): trace with
        the given example arguments — or the ones ``lower()`` saw — and run
        the Mozart dataflow analyzer (``repro_torch.core.analysis``, MZ2xx
        codes) under this Pipeline's configuration: its device and its
        mesh.  Returns an ``analysis.Report``."""
        from repro_torch.core import analysis
        self._require_fn()
        if not args and not kwargs and self._example is not None:
            args, kwargs = self._example
        c = self.ctx
        return analysis.verify_pipeline(
            lambda *a: self.fn(*a, **kwargs), *args,
            executor=c.executor, chip=c.chip, device=c.device, mesh=c.mesh,
            data_axes=c.data_axes, batch_elements=c.batch_elements,
            inner_executor=c.inner_executor, pipeline=c.pipeline,
            handoff=c.handoff, rewrite=c.rewrite)

    def _require_fn(self) -> None:
        if self.fn is None:
            raise TypeError(
                "this Pipeline wraps no function (session-scope pipeline); "
                "construct it as mozart.pipeline(fn, ...)")

    def __repr__(self) -> str:
        name = getattr(self.fn, "__name__", None) or "session"
        state = "compiled" if self.compiled else (
            "lowered" if self._example is not None else "fresh")
        return f"<mozart.Pipeline {name} [{state}]>"


def pipeline(fn: Callable | None = None, **config):
    """Build a :class:`Pipeline` over ``fn``; usable as a decorator.

        p = mozart.pipeline(my_fn, executor="cuda")

        @mozart.pipeline(executor="scan", plan_cache_path="plans.json")
        def my_fn(x, y): ...

    ``config`` accepts every ``mozart.session`` knob (executor, device,
    chip, mesh, batch_elements, plan_cache_path, ...)."""
    if fn is None:
        return lambda f: Pipeline(f, **config)
    return Pipeline(fn, **config)
