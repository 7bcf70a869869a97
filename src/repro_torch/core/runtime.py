"""The Mozart runtime facade: contexts, configuration, evaluation.

A ``MozartContext`` owns a dataflow graph (libmozart), a planner, and an
executor configuration.  ``evaluate()`` converts pending annotated calls into
stages and runs them (paper Figure 2).  Contexts nest; ``mozart.session``
is the user-facing way to scope configuration:

    with mozart.session(executor="cuda") as ctx:     # device="cuda" default
        call, put = black_scholes(price, strike, ...)  # lazy
        print(call.value)                              # forces evaluation

A context runs on the card unless it is given ``device="cpu"``; on a machine
without CUDA the default raises instead of quietly running on the CPU.
``executor="sharded"`` with ``mesh=`` (a ``DeviceMesh`` on the context's
device type, ``launch/mesh.py``) spreads each stage's split over the mesh's
``data_axes`` (``core/sharded.py``).
Outside every session annotated functions run eagerly (the plain library).

Plans are cached across evaluations (``core/plan_cache.py``): a repeated
pipeline skips the planner, replays its handoff decisions and its pinned
drivers and kernel programs.  Before planning, the static rewrite pass
(``core/rewrite.py``, ``rewrite=True`` by default) eliminates dead calls,
shares common subexpressions, pushes filters ahead of maps and regroups
interleaved chains.  Every stage dispatches through the degradation ladder
(``core/resilience.py``): a failing executor is quarantined and the stage
completes on a lower rung, except for kernel faults (and, on ``cuda``,
any failure but an injected one), which propagate;
``mozart.inject_faults(spec)`` arms deterministic faults.  ``mozart.pipeline(fn)`` is the ahead-of-time
entry point over the same machinery (``core/pipeline.py``); a session is an
anonymous pipeline's scope.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import weakref
from typing import Any

import torch
from torch.utils import _pytree as pytree
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import hardware
from repro_torch.core import resilience
from repro_torch.core.future import Future
from repro_torch.core.graph import DataflowGraph, NodeRef
from repro_torch.core.handoff import resolve_decisions
from repro_torch.core.plan_cache import lookup_or_plan
from repro_torch.core.planner import plan
from repro_torch.core.resilience import inject_faults  # noqa: F401  (mozart.inject_faults)
from repro_torch.core.stage_exec import BoundaryCounters, counter_scope


def resolve_device(device: torch.device | str) -> torch.device:
    """The concrete device a context runs on; raises where CUDA is asked for
    but absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Mozart session asks for device 'cuda' but torch.cuda is not "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_mesh(mesh, dev: torch.device):
    """A session's mesh must live on the session's device type: a card
    session never runs its shards on a CPU mesh, nor the reverse."""
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"the mesh lies on {mesh.device_type!r}, the session "
                         f"runs on {dev.type!r}")
    return mesh


def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (
        dev.index is None or t.device.index in (None, dev.index))


class MozartContext:
    def __init__(
        self,
        executor: str = "pipelined",
        device: torch.device | str = "cuda",
        chip: hardware.Chip | None = None,
        mesh=None,
        data_axes: tuple[str, ...] = ("data",),
        lazy: bool = True,
        pedantic: bool = False,
        batch_elements: int | None = None,
        log: bool = False,
        inner_executor: str = "fused",
        pipeline: bool = True,
        plan_cache: bool = True,
        autotune: bool = True,
        plan_cache_path: str | None = None,
        handoff: bool = True,
        rewrite: bool = True,
    ):
        self.executor = executor
        self.device = resolve_device(device)
        self.chip = chip if chip is not None else hardware.chip_for(self.device)
        self.mesh = _check_mesh(mesh, self.device)  # torch DeviceMesh ("sharded")
        self.data_axes = tuple(data_axes)        # mesh axes the splits spread over
        self.lazy = lazy
        self.pedantic = pedantic
        self.batch_elements = batch_elements
        self.log = log
        self.inner_executor = inner_executor     # per-shard strategy for "sharded"
        self.pipeline = pipeline                 # False: Table-4 "-pipe" ablation
        self.plan_cache = plan_cache             # reuse plans across evaluations
        self.autotune = autotune                 # measure+pin chunk sizes on cached plans
        self.handoff = handoff                   # cross-stage chunk handoff (core/handoff.py)
        self.rewrite = rewrite                   # static graph rewrite pass (core/rewrite.py)
        # Persist plans, tuned batches and executor choices across processes;
        # the MOZART_PLAN_CACHE variable pre-warms every context.
        if plan_cache_path is None:
            plan_cache_path = os.environ.get("MOZART_PLAN_CACHE") or None
        self.plan_cache_path = plan_cache_path
        self.graph = DataflowGraph()
        self.stats: collections.Counter = collections.Counter()
        #: this context's scoped trace/boundary-traffic view (stage_exec).
        self.counters = BoundaryCounters()
        self._plan_entry = None                  # active plan_cache.PlanEntry
        #: 64-bit argument -> (its version, the 32-bit copy) for this
        #: context's registrations: one narrowed copy per tensor, so every
        #: call on it names the same stage input (annotation.canonicalize)
        self._narrowed = WeakIdKeyDictionary()
        self._handoff = None                     # active handoff decisions
        self._batch_override: int | None = None  # set by the auto-tuner only
        self._n_cap: int | None = None           # set during sampled tuning only
        self._entry_keys: set = set()            # cache keys this context used
        self._last_rewrites: list = []           # RewriteRecords of the last plan
        if self.plan_cache_path:
            from repro_torch.core.plan_cache import load_once
            load_once(self.plan_cache_path)

    # -- libmozart register() -------------------------------------------------
    def register_call(self, fn, bound: dict[str, Any]) -> Future:
        avals: dict[str, Any] = {}
        ctor_bound: dict[str, Any] = {}
        stored: dict[str, Any] = {}
        for name, v in bound.items():
            if isinstance(v, Future):
                node = v._node
                avals[name] = node.out_aval
                ctor_bound[name] = node.out_aval     # ctors may read .shape
                stored[name] = NodeRef(node.id)
            else:
                for leaf in pytree.tree_leaves(v):
                    if (isinstance(leaf, torch.Tensor)
                            and not _on_device(leaf, self.device)):
                        raise ValueError(
                            f"{fn.name}: argument {name!r} lies on "
                            f"{leaf.device}, the session runs on {self.device}")
                avals[name] = v
                ctor_bound[name] = v
                stored[name] = v

        # Dynamic-shape functions (and consumers of their outputs) cannot be
        # abstractly evaluated; they run call by call per chunk (paper: filters).
        if getattr(fn.sa, "dynamic", False) or any(a is None for a in avals.values()):
            out_aval = None
        else:
            out_aval = fn.abstract_eval(avals)
        arg_types, out_type = fn.construct_types(ctor_bound, avals, out_aval)
        node = self.graph.register(fn, stored, arg_types, out_type, out_aval)
        fut = Future(self, node)
        node.future_ref = weakref.ref(fut)
        self.stats["registered"] += 1
        return fut

    # -- libmozart evaluate() ---------------------------------------------------
    def evaluate(self) -> None:
        pending = self.graph.pending()
        if not pending:
            return
        stages, entry = lookup_or_plan(pending, self.graph, self)
        self.stats["evaluations"] += 1
        if self.log:
            for s in stages:
                names = ",".join(n.fn.name for n in s.nodes)
                print(f"[mozart] stage {s.id}: [{names}] inputs="
                      f"{[str(si.split_type) for si in s.inputs.values()]}")
        # Handoff decisions: replayed from the cache entry (zero analysis on
        # warm calls); uncacheable pipelines analyze fresh per evaluation.
        ho = resolve_decisions(self, entry, stages)
        # Save/restore, not clear: a dynamic node forcing a Future of this
        # same session re-enters evaluate(), and the outer plan's entry and
        # decisions must survive the nested call.
        prev_entry, prev_ho = self._plan_entry, self._handoff
        self._plan_entry, self._handoff = entry, ho
        try:
            # Dispatch PER STAGE (``executor="auto"`` routes each stage on its
            # own, core/cost_model.py).  Trace and boundary events attribute
            # to THIS context's counters (plus the process-global aggregate).
            # ``resilience.run_stage`` arms the degradation ladder.
            with counter_scope(self.counters):
                for s in stages:
                    resilience.run_stage(self.executor, s, self.graph, self)
        finally:
            self._plan_entry, self._handoff = prev_entry, prev_ho
        self.graph.prune()

    def last_plan(self):
        """Plan (without executing) — used by tests and EXPLAIN tooling."""
        return plan(self.graph.pending(), self.graph,
                    max_stage_nodes=None if self.pipeline else 1)


_tls = threading.local()


def _stack() -> list[MozartContext]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current_context() -> MozartContext | None:
    s = _stack()
    return s[-1] if s else None


def configure(**kwargs) -> MozartContext:
    """Reconfigure the innermost context (flushes pending work first).

    When a knob that is part of the plan-cache key changes (executor, chip,
    device, mesh, pipeline, handoff), the entries THIS context used are re-keyed
    (copied) to the new configuration, so the next evaluation hits instead
    of replanning (``plan_cache.rekey_config``, counted in
    ``configure_rekeyed``)."""
    ctx = current_context()
    if ctx is None:
        if kwargs:
            raise AttributeError("no active Mozart context to configure")
        return ctx
    ctx.evaluate()
    from repro_torch.core import plan_cache as _pc
    old_prefix = _pc.context_key_prefix(ctx)
    for k, v in kwargs.items():
        if not hasattr(ctx, k):
            raise AttributeError(f"unknown Mozart option {k!r}")
        if k == "device":
            v = resolve_device(v)
        setattr(ctx, k, v)
    _check_mesh(ctx.mesh, ctx.device)
    new_prefix = _pc.context_key_prefix(ctx)
    if old_prefix != new_prefix and getattr(ctx, "plan_cache", True):
        ctx.stats["configure_rekeyed"] += _pc.rekey_config(
            old_prefix, new_prefix, only_keys=ctx._entry_keys)
    return ctx


@contextlib.contextmanager
def session(**kwargs):
    """Scope a Mozart configuration (paper-style usage): annotated calls made
    inside register against a fresh context, evaluated at scope exit.  A
    session is an anonymous :class:`repro_torch.core.pipeline.Pipeline`'s
    ``scope()``: both entry points share one lifecycle and one cache."""
    from repro_torch.core.pipeline import Pipeline
    with Pipeline(None, **kwargs).scope() as ctx:
        yield ctx


def pipeline(fn=None, **config):
    """AOT entry point: ``mozart.pipeline(fn, ...)`` with an explicit
    ``lower -> compile -> call`` lifecycle (``core/pipeline.py``)."""
    from repro_torch.core.pipeline import pipeline as _pipeline
    return _pipeline(fn, **config)


def evaluate() -> None:
    ctx = current_context()
    if ctx is not None:
        ctx.evaluate()


def verify(target=None, *args, **kwargs):
    """``mozart.verify()``: lint every registered split annotation, or
    ``mozart.verify(fn, *args, executor=...)``: trace one pipeline and run
    the dataflow analyzer over its plan.  Both run on the card unless given
    ``device="cpu"``.  Returns an ``analysis.Report``; see
    ``repro_torch.core.analysis`` for the MZ codes."""
    from repro_torch.core import analysis
    return analysis.verify(target, *args, **kwargs)
