"""Plan cache + auto-tuner state: skip the planner for repeated pipelines.

The counterpart of ``src/repro/core/plan_cache.py``.  The paper's Mozart
re-plans every ``evaluate()``; this cache keeps the materialized plan, so
the second execution of an identical pipeline touches neither the planner
nor the split-type unifier, and (through the entry's executable table) runs
no ``torch.fx`` trace and no kernel lowering either.

**Key.**  A pipeline is identified by a structural fingerprint of the
pending dataflow graph as the static rewrite pass (``core/rewrite.py``)
leaves it: per node, the annotated function's name, the
aliasing pattern of its arguments (which argument is which external value /
which earlier node), static argument values, the *constructed* split types
(SA-local generics normalized, ``unknown`` uids erased), and the shape,
dtype and device type of every external tensor and abstract output.  The
context knobs that change planning, batch sizing or the executables
(``executor``, the session's chip, ``pipeline``, the device type,
``handoff``) are part of the key; tensor *values* are not, so calling the
same pipeline on fresh data of the same shape is a hit.  The pass itself
runs once per distinct captured graph: its script is kept under the
captured graph's ``_rewrite_key`` and replayed on later captures, which
then look their entry up under the key the first one computed.

**Template.**  A hit does not reuse ``Stage`` objects (they reference the
prior call's nodes); it re-instantiates them from a symbolic template that
names values by (node position, argument name).  Escaping-output sets are
recomputed per instantiation because they depend on which ``Future``
handles are still alive *this* call.

**Auto-tuner.**  Each entry owns ``tuned_batch``: on the first execution of
a cached plan ``StageExecutor._tune`` measures 2-3 candidate chunk sizes
around the §5.2 fast-memory estimate (a bounded *sample* of chunks per
candidate, extrapolated) and pins the fastest; later hits reuse it.  The
``cuda`` executor pins the kernel's tile (``block_shape``).  Under
``executor="auto"`` the entry also owns ``chosen_exec`` and
``exec_timings``, the cost model's measured feedback
(``core/cost_model.py``).

**Persistence.**  ``save(path)`` / ``load(path)`` serialize fingerprints,
stage templates, tuned batches, tiles, chosen executors and handoff
decisions to a versioned JSON file (schema v7, the reference's layout), so
a restarted process replays pinned plans with zero planner calls and zero
tuning executions.  A schema guard and a chip guard (the card's name from
its properties) reject stale or cross-chip files (cold planning, never a
crash); saves write through a temp file + fsync + atomic rename under an
advisory file lock, merging the on-disk entries first.  Entries whose split
types cannot round-trip structurally are skipped.  Rehydrated entries carry
function *names*; the first lookup match binds the live ``AnnotatedFn``s.

Values that cannot be fingerprinted make a pipeline *uncacheable*: it is
planned from scratch every time, which is always correct, merely slower.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import threading
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch import hardware
from repro_torch.core import resilience
from repro_torch.core import rewrite as rewrite_mod
from repro_torch.core import split_types as st
from repro_torch.core.graph import DataflowGraph, Node, NodeRef, live_consumers
from repro_torch.core.planner import Stage, StageInput, _value_key, plan

_MAX_ENTRIES = 256

#: serialized file format version (the reference's v7 layout: handoff
#: decisions with ``convert_in``/``shard_in``/``vetoed``, block shapes,
#: ``exec_meta``, ``bucket``, ``quarantined``, ``rewrites``).
SCHEMA_VERSION = 7

#: older schemas the loader migrates forward in place: each lacks only
#: fields that default to empty (see the reference's notes).
_MIGRATABLE_SCHEMAS = (2, 3, 4, 5, 6)

#: process-global cache statistics.
stats: collections.Counter = collections.Counter()

_lock = threading.Lock()
_entries: "collections.OrderedDict[tuple, PlanEntry]" = collections.OrderedDict()
_loaded_paths: set[str] = set()

#: In-process side table of PINNED EXECUTABLES (the fused and scan drivers,
#: the ``cuda`` executor's lowered kernel programs), keyed by the entry's
#: uid, not its fingerprint: two function objects can share a fingerprint
#: (closures with one ``__name__``), and an entry that replaces another under
#: the same key must not inherit drivers and programs built from the other's
#: bodies.  They cannot be serialized, so a process that warm-starts from
#: ``MOZART_PLAN_CACHE`` builds each once on its first execution and replays
#: it afterwards.  Populated by ``stage_exec.pinned_exec``.
_exec_tables: dict[int, dict] = {}

#: The rewrite pass's scripts (``rewrite.Script``), keyed by the UNREWRITTEN
#: graph's ``_rewrite_key``, with the function objects they were written
#: for and the rewritten graph's fingerprint: a warm call replays the
#: script and looks its entry up without running the pass or fingerprinting
#: twice.  Runtime-only (a restarted process runs the pass once per graph),
#: bounded like ``_entries``.
_rewrite_scripts: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()

#: monotone version of the persistable state; ``save`` skips the disk write
#: when the target file already reflects the current version.
_mutations = 0
_saved_versions: dict[str, int] = {}


def _mark_dirty() -> None:
    global _mutations
    _mutations += 1


def clear() -> None:
    """Drop every cached plan and reset the global counters.  Pinned
    executables go too: ``clear()`` simulates a full process restart."""
    with _lock:
        _entries.clear()
        _exec_tables.clear()
        _rewrite_scripts.clear()
        stats.clear()
        _loaded_paths.clear()
        _mark_dirty()


def cache_info() -> dict[str, int]:
    with _lock:
        return {"entries": len(_entries), **stats}


def entries() -> list["PlanEntry"]:
    with _lock:
        return list(_entries.values())


def tuned_batches() -> dict[tuple[int, int], int]:
    """(entry uid, stage_id) -> pinned chunk size (diagnostics)."""
    out: dict[tuple[int, int], int] = {}
    for e in entries():
        for sid, batch in dict(e.tuned_batch).items():
            out[(e.uid, sid)] = batch
    return out


def _chip_name() -> str:
    """The chip this process persists plans for: the card's name from its
    properties where there is a card, else the host model's."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    return hardware.chip_for(dev).name


# ---------------------------------------------------------------------------
# Fingerprinting
# ---------------------------------------------------------------------------


def value_fingerprint(v: Any, with_value: bool = False) -> tuple | None:
    """Shape/dtype/device-level identity of an external value; None =
    uncacheable.

    Numeric scalars are keyed by *type only* unless ``with_value`` (static
    arguments): a pipeline driven with a changing rate/step scalar must
    still hit the cache, and instantiation rebinds the current call's
    values.  Custom containers opt in via a ``mozart_fingerprint()`` method
    returning a hashable tuple of their leaves' shapes/dtypes."""
    hook = getattr(v, "mozart_fingerprint", None)
    if callable(hook):
        return hook()
    if isinstance(v, (bool, int, float, complex)):
        return ("py", type(v).__name__, v) if with_value else ("py", type(v).__name__)
    if isinstance(v, (str, bytes, type(None))):
        return ("py", type(v).__name__, v)
    if isinstance(v, torch.Tensor):
        return ("arr", tuple(v.shape), str(v.dtype), v.device.type)
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return ("arr", tuple(v.shape), str(v.dtype))
    if isinstance(v, (tuple, list)):
        parts = tuple(value_fingerprint(x, with_value) for x in v)
        if any(p is None for p in parts):
            return None
        return ("seq", type(v).__name__, parts)
    if isinstance(v, dict):
        items = []
        for k in sorted(v, key=repr):
            p = value_fingerprint(v[k], with_value)
            if p is None:
                return None
            items.append((repr(k), p))
        return ("map", tuple(items))
    return None


def _aval_fingerprint(aval: Any) -> tuple | None:
    if aval is None:
        return ("dynamic",)
    leaves, treedef = pytree.tree_flatten(aval)
    leaf_fps = []
    for l in leaves:
        shape = getattr(l, "shape", None)
        dtype = getattr(l, "dtype", None)
        if shape is None or dtype is None:
            return None
        leaf_fps.append((tuple(shape), str(dtype)))
    return (str(treedef), tuple(leaf_fps))


def _type_fingerprint(t: Any, varmap: dict[int, int]) -> tuple | None:
    if isinstance(t, st.GenericVar):
        return ("var", varmap.setdefault(t.uid, len(varmap)))
    if isinstance(t, st.UnknownSplit):
        return ("unknown", t.axis)       # uid erased: unknowns are structural here
    if not isinstance(t, st.SplitType):
        return None
    try:
        hash(t.params)
    except TypeError:
        return None
    return ("T", t.name, t.params)


def fingerprint(pending: list[Node], graph: DataflowGraph, ctx) -> tuple | None:
    """Structural key of the pending graph, or None if uncacheable."""
    pos = {n.id: i for i, n in enumerate(pending)}
    ext_index: dict[int, int] = {}       # id(value) -> alias slot
    done_index: dict[int, int] = {}      # done node_id -> alias slot
    node_fps = []
    for n in pending:
        varmap: dict[int, int] = {}      # generics are fresh per call/node
        arg_fps = []
        for name, v in n.bound.items():
            if name in n.fn.sa.static:
                f = value_fingerprint(v, with_value=True)   # baked into drivers
                if f is None:
                    return None
                arg_fps.append(("static", name, f))
            elif isinstance(v, NodeRef):
                if v.node_id in pos:
                    arg_fps.append(("ref", name, pos[v.node_id]))
                else:
                    src = graph.nodes.get(v.node_id)
                    f = _aval_fingerprint(src.out_aval) if src is not None else None
                    if f is None:
                        return None
                    slot = done_index.setdefault(v.node_id, len(done_index))
                    arg_fps.append(("done", name, slot, f))
            else:
                f = value_fingerprint(v)
                if f is None:
                    return None
                # alias slot: add(x, x) and add(x, y) must key differently
                slot = ext_index.setdefault(id(v), len(ext_index))
                arg_fps.append(("ext", name, slot, f))
        type_fps = []
        for name in n.bound:
            if name in n.fn.sa.static:
                continue
            f = _type_fingerprint(n.arg_types[name], varmap)
            if f is None:
                return None
            type_fps.append((name, f))
        out_fp = _type_fingerprint(n.out_type, varmap)
        if out_fp is None:
            return None
        aval_fp = _aval_fingerprint(n.out_aval)
        if aval_fp is None:
            return None
        node_fps.append((n.fn.name, tuple(arg_fps), tuple(type_fps), out_fp, aval_fp))
    return context_key_prefix(ctx) + (tuple(node_fps),)


def context_key_prefix(ctx) -> tuple:
    """The context-knob part of every fingerprint: the configuration a plan
    was cached under.  The chip is the session's own (its name comes from
    the card's properties), the device type separates a session on the card
    from one on the CPU, and ``handoff`` is included because recorded
    handoff decisions apply only under the configuration they were analyzed
    for.  ``configure()`` uses this prefix to re-key entries when knobs
    change mid-session (``rekey_config``)."""
    return (ctx.executor, ctx.chip.name, bool(ctx.pipeline), ctx.device.type,
            bool(getattr(ctx, "handoff", True)))


_PREFIX_LEN = 5

#: prefix component indices (kept in sync with ``context_key_prefix``).
_P_EXEC, _P_CHIP, _P_PIPE, _P_DEV, _P_HANDOFF = range(_PREFIX_LEN)


def rekey_config(old_prefix: tuple, new_prefix: tuple,
                 only_keys: set | None = None) -> int:
    """Migrate cached plans across a mid-session ``configure()`` knob change.

    Stage *templates* are executor-independent, so each matching entry is
    COPIED to ``new_prefix``.  Tuned chunk sizes, their trial history and
    pinned tiles migrate when only the executor (or handoff) knob changed,
    and are dropped when the chip or device changed (measured on other
    hardware).  Executor-selection state (``chosen_exec``/``exec_timings``)
    never migrates.  Handoff decisions migrate only when the executor did
    not change; otherwise the copy re-analyzes on first use
    (``handoff.resolve_decisions``).  The originals stay in place (other
    sessions and compiled ``Pipeline``s may still run under the old
    configuration).  A ``pipeline`` flag change alters plan structure, so
    nothing is copied.  ``only_keys`` scopes the copy to the entries the
    configuring context used.  Returns the number of entries re-keyed."""
    if old_prefix == new_prefix:
        return 0
    structural = old_prefix[_P_PIPE] != new_prefix[_P_PIPE]
    same_hw = (old_prefix[_P_CHIP] == new_prefix[_P_CHIP]
               and old_prefix[_P_DEV] == new_prefix[_P_DEV])
    moved = 0
    with _lock:
        for key in [k for k in _entries if k[:_PREFIX_LEN] == old_prefix]:
            if only_keys is not None and key not in only_keys:
                continue
            if structural:
                stats["rekey_skipped_structural"] += 1
                continue
            new_key = new_prefix + key[_PREFIX_LEN:]
            if new_key in _entries:
                continue                             # existing entry wins
            e = _entries[key]
            stats["rekeyed"] += 1
            copy = PlanEntry(
                key=new_key, stage_templates=e.stage_templates,
                fns=e.fns, fn_names=e.fn_names, loaded=e.loaded,
                handoff=(e.handoff
                         if old_prefix[_P_EXEC] == new_prefix[_P_EXEC]
                         else None))
            if same_hw:
                with e._lock:
                    copy.tuned_batch = dict(e.tuned_batch)
                    copy.trials = {k: list(v) for k, v in e.trials.items()}
                    copy.block_shape = dict(e.block_shape)
                    copy.quarantined = {k: dict(v)
                                        for k, v in e.quarantined.items()}
                stats["rekey_migrated_tuned"] += len(copy.tuned_batch)
            _entries[new_key] = copy
            moved += 1
        _mark_dirty()
    return moved


# ---------------------------------------------------------------------------
# Plan templates
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _StageTemplate:
    positions: list[int]                             # indices into pending list
    inputs: list[tuple[tuple, st.SplitType]]          # (desc, resolved split type)
    out_types: dict[int, st.SplitType]                # position -> resolved type
    arg_types: dict[tuple[int, str], st.SplitType]    # (position, argname) -> type


_entry_uids = iter(range(1 << 62))


@dataclasses.dataclass
class PlanEntry:
    key: tuple
    stage_templates: list[_StageTemplate]
    fns: tuple | None                                # per-node AnnotatedFn identity
    fn_names: tuple = ()                             # per-node fn names (persistable)
    uid: int = dataclasses.field(default_factory=lambda: next(_entry_uids))
    tuned_batch: dict[int, int] = dataclasses.field(default_factory=dict)
    trials: dict[int, list[tuple[int, float]]] = dataclasses.field(default_factory=dict)
    #: executor="auto": pinned per-stage executor name (cost_model feedback).
    chosen_exec: dict[int, str] = dataclasses.field(default_factory=dict)
    #: executor="auto": measured seconds per (stage, candidate executor).
    exec_timings: dict[int, dict[str, float]] = dataclasses.field(default_factory=dict)
    #: executor="auto": element count + log2 bucket a pinned choice was
    #: measured at (the cost model's drift recheck compares against it).
    exec_meta: dict[int, dict] = dataclasses.field(default_factory=dict)
    #: cuda: the tile the split-pipeline kernel launches with, ``(1, tile)``
    #: per stage (``cuda_exec.CudaExecutor``).
    block_shape: dict[int, tuple] = dataclasses.field(default_factory=dict)
    #: handoff decisions (``handoff.analyze``) keyed by stage id; None = not
    #: analyzed (handoff disabled, or rekeyed across executors).
    handoff: dict | None = None
    #: consecutive calls whose Future liveness disagreed with the recorded
    #: donation decisions (``handoff.STALE_THRESHOLD``).  Runtime-only.
    ho_age: int = 0
    #: bucket label this entry was pinned for (``Pipeline.compile(bucket=)``).
    bucket: tuple | None = None
    #: per-stage quarantined executors ``{stage_id: {name: age}}``, written
    #: by the degradation ladder (``resilience.run_stage``); a name is
    #: skipped until its age reaches ``resilience.QUARANTINE_TTL``.
    #: Persisted.
    quarantined: dict[int, dict[str, int]] = dataclasses.field(default_factory=dict)
    #: MZ5xx records (``RewriteRecord.to_json()``) of the rewrite pass that
    #: produced this entry's graph, declines included.  Persisted.
    rewrites: list = dataclasses.field(default_factory=list)
    #: warm hits since the last periodic re-analysis tick
    #: (``MOZART_REANALYZE_EVERY``).  Runtime-only.
    evals_since_reanalysis: int = 0
    #: stage ids whose pinned executor choice the next dispatch re-checks
    #: (set by the re-analysis tick, consumed by ``cost_model``).
    recheck_stages: set = dataclasses.field(default_factory=set)
    hits: int = 0
    loaded: bool = False                             # rehydrated from disk
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    _tuning: set = dataclasses.field(default_factory=set)

    def matches(self, pending: list[Node]) -> bool:
        """Guard against hash collisions / id() reuse: the cached plan
        applies only if every node still calls the same function object.
        Rehydrated entries (``fns is None``) match on function names and
        bind identities on the first hit (``bind_fns``)."""
        if self.fns is None:
            return len(pending) == len(self.fn_names) and all(
                n.fn.name == name for n, name in zip(pending, self.fn_names)
            )
        return len(pending) == len(self.fns) and all(
            n.fn is f for n, f in zip(pending, self.fns)
        )

    def bind_fns(self, pending: list[Node]) -> None:
        with self._lock:
            if self.fns is None:
                self.fns = tuple(n.fn for n in pending)

    def try_claim_tuning(self, stage_id: int) -> bool:
        """Exactly one session tunes a stage; racers run with the estimate."""
        with self._lock:
            if stage_id in self.tuned_batch or stage_id in self._tuning:
                return False
            self._tuning.add(stage_id)
            return True

    def release_tuning(self, stage_id: int) -> None:
        with self._lock:
            self._tuning.discard(stage_id)

    def pin(self, stage_id: int, batch: int) -> None:
        with self._lock:
            self.tuned_batch[stage_id] = int(batch)
            self._tuning.discard(stage_id)
        _mark_dirty()

    def record_trial(self, stage_id: int, batch: int, seconds: float) -> None:
        with self._lock:
            self.trials.setdefault(stage_id, []).append((int(batch), seconds))

    # -- executor auto-selection state (cost model feedback) ----------------
    def try_claim_exec(self, stage_id: int) -> bool:
        """Exactly one session measures executors for a stage."""
        with self._lock:
            if stage_id in self.chosen_exec or ("exec", stage_id) in self._tuning:
                return False
            self._tuning.add(("exec", stage_id))
            return True

    def release_exec(self, stage_id: int) -> None:
        with self._lock:
            self._tuning.discard(("exec", stage_id))

    def pin_exec(self, stage_id: int, name: str, n: int | None = None) -> None:
        with self._lock:
            self.chosen_exec[stage_id] = str(name)
            if n is not None:
                self.exec_meta[stage_id] = {
                    "n": int(n), "bucket": int(n).bit_length()}
            self._tuning.discard(("exec", stage_id))
        _mark_dirty()

    def unpin_exec(self, stage_id: int) -> None:
        """Age out a pinned executor choice (shape-drift re-measurement)."""
        with self._lock:
            self.chosen_exec.pop(stage_id, None)
            self.exec_meta.pop(stage_id, None)
        _mark_dirty()

    def pin_block_shape(self, stage_id: int, shape: tuple) -> None:
        shape = tuple(int(x) for x in shape)
        with self._lock:
            if self.block_shape.get(stage_id) == shape:
                return                   # idempotent: no save-dirtying spam
            self.block_shape[stage_id] = shape
        _mark_dirty()

    def record_exec_timing(self, stage_id: int, name: str, seconds: float) -> None:
        """Fresh measurements overwrite whatever was recorded (or poisoned)."""
        with self._lock:
            self.exec_timings.setdefault(stage_id, {})[str(name)] = float(seconds)
        _mark_dirty()

    # -- executor quarantine (resilience degradation ladder) -----------------
    def quarantine_exec(self, stage_id: int, name: str) -> None:
        """Ban ``name`` for this stage until the quarantine ages out."""
        with self._lock:
            self.quarantined.setdefault(int(stage_id), {})[str(name)] = 0
        _mark_dirty()

    def quarantined_execs(self, stage_id: int) -> set:
        """The currently banned executor names for a stage (read-only)."""
        with self._lock:
            return set(self.quarantined.get(int(stage_id), ()))

    def tick_quarantine(self, stage_id: int, ttl: int) -> set:
        """Age this stage's quarantines by one dispatch; names reaching
        ``ttl`` are dropped (eligible again).  Returns the still-banned set.
        Called once per stage dispatch (``resilience.run_stage``)."""
        with self._lock:
            ages = self.quarantined.get(int(stage_id))
            if not ages:
                return set()
            expired = []
            for name in ages:
                ages[name] += 1
                if ages[name] >= ttl:
                    expired.append(name)
            for name in expired:
                del ages[name]
            if not ages:
                del self.quarantined[int(stage_id)]
            alive = set(ages or ())
        if expired:
            _mark_dirty()
        return alive

    # -- pinned executables (in-process, keyed by fingerprint) ---------------
    def exec_table(self) -> dict:
        """The entry's executable table (see ``_exec_tables``), keyed by
        ``(stage position, kind, *key)``, never by per-call node ids, so
        every instantiation of this template resolves to the same driver or
        lowered program."""
        t = _exec_tables.get(self.uid)
        if t is None:
            with _lock:
                t = _exec_tables.setdefault(self.uid, {})
        return t


def _make_templates(stages: list[Stage], pending: list[Node]) -> list[_StageTemplate] | None:
    pos = {n.id: i for i, n in enumerate(pending)}
    templates = []
    for s in stages:
        inputs: list[tuple[tuple, st.SplitType]] = []
        for key, si in s.inputs.items():
            v = si.value
            if isinstance(v, NodeRef) and v.node_id in pos:
                desc: tuple = ("node", pos[v.node_id])
            else:
                # name the value symbolically: "arg <name> of node <position>"
                desc = ()
                for n in s.nodes:
                    for name, bv in n.bound.items():
                        if name not in n.fn.sa.static and _value_key(bv) == key:
                            desc = ("arg", pos[n.id], name)
                            break
                    if desc:
                        break
                if not desc:
                    return None          # value not reachable from bound args
            inputs.append((desc, si.split_type))
        templates.append(_StageTemplate(
            positions=[pos[n.id] for n in s.nodes],
            inputs=inputs,
            out_types={pos[nid]: t for nid, t in s.out_types.items()},
            arg_types={(pos[nid], name): t for (nid, name), t in s.arg_types.items()},
        ))
    return templates


def _instantiate(entry: PlanEntry, pending: list[Node],
                 graph: DataflowGraph) -> list[Stage]:
    consumers = live_consumers(graph.pending())
    stages: list[Stage] = []
    for sid, tm in enumerate(entry.stage_templates):
        nodes = [pending[p] for p in tm.positions]
        node_ids = {n.id for n in nodes}
        inputs: dict[tuple, StageInput] = {}
        for desc, t in tm.inputs:
            if desc[0] == "node":
                val: Any = NodeRef(pending[desc[1]].id)
            else:
                val = pending[desc[1]].bound[desc[2]]
            key = _value_key(val)
            inputs[key] = StageInput(key, val, t)
        out_types = {pending[p].id: t for p, t in tm.out_types.items()}
        # Escaping outputs depend on which Futures are alive *this* call.
        escaping: set[int] = set()
        for n in nodes:
            ext = any(c not in node_ids for c in consumers.get(n.id, []))
            if ext or n.future_alive():
                escaping.add(n.id)
            n.stage_id = sid
        arg_types = {(pending[p].id, name): t
                     for (p, name), t in tm.arg_types.items()}
        stages.append(Stage(sid, nodes, inputs, out_types, escaping, arg_types))
    return stages


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------

_PYNUM = (bool, int, float, complex)


def _rewrite_key(pending: list[Node], graph: DataflowGraph, ctx) -> tuple | None:
    """Everything the rewrite pass decides on: the fingerprint, plus which
    nodes have a live Future (dead-stage elimination, pushdown) and which
    captured numbers are equal (CSE keys them by value; the fingerprint by
    type only).  None = uncacheable."""
    base = fingerprint(pending, graph, ctx)
    if base is None:
        return None
    classes: dict[tuple, int] = {}
    nums = []
    for n in pending:
        for name, v in n.bound.items():
            if name not in n.fn.sa.static and isinstance(v, _PYNUM):
                nums.append(classes.setdefault((type(v), v), len(classes)))
    return base + (tuple(n.future_alive() for n in pending), tuple(nums))


def _rewrite(pending: list[Node], graph: DataflowGraph,
             ctx) -> tuple["rewrite_mod.RewriteResult", tuple | None]:
    """Run the rewrite pass on the first capture of a graph and replay its
    script on every later one.  Returns the result and, on a replay, the
    rewritten graph's fingerprint (None: compute it)."""
    if not (getattr(ctx, "rewrite", True) and getattr(ctx, "plan_cache", True)
            and pending):
        return rewrite_mod.apply(pending, graph, ctx), None
    key0 = _rewrite_key(pending, graph, ctx)
    if key0 is None:
        return rewrite_mod.apply(pending, graph, ctx), None
    with _lock:
        memo = _rewrite_scripts.get(key0)
        if memo is not None:
            _rewrite_scripts.move_to_end(key0)
    if memo is not None:
        script, fns, key = memo
        if len(fns) == len(pending) and all(n.fn is f for n, f in zip(pending, fns)):
            return rewrite_mod.replay(pending, graph, ctx, script), key
    script = rewrite_mod.Script()
    fns = tuple(n.fn for n in pending)
    rw = rewrite_mod.apply(pending, graph, ctx, script=script)
    key = fingerprint(rw.pending, graph, ctx) if rw.pending else None
    with _lock:
        _rewrite_scripts[key0] = (script, fns, key)
        while len(_rewrite_scripts) > _MAX_ENTRIES:
            _rewrite_scripts.popitem(last=False)
    return rw, key


def lookup_or_plan(pending: list[Node], graph: DataflowGraph,
                   ctx) -> tuple[list[Stage], PlanEntry | None]:
    """Return (stages, cache entry or None).  Counts live in ``ctx.stats``:
    ``planner_calls`` increments only when the planner actually runs.

    The static rewrite pass (``core/rewrite.py``) runs FIRST, so the
    fingerprint, the planner, the handoff analysis and the templates see the
    rewritten graph.  It runs once per distinct unrewritten graph: warm
    calls replay its script (``_rewrite``) and land on the rewritten graph's
    key without fingerprinting it again."""
    rw, key = _rewrite(pending, graph, ctx)
    pending = rw.pending
    ctx._last_rewrites = rw.records
    max_nodes = None if ctx.pipeline else 1
    if not pending:                      # the pass eliminated every node
        return [], None
    if not getattr(ctx, "plan_cache", True):
        ctx.stats["planner_calls"] += 1
        return plan(pending, graph, max_stage_nodes=max_nodes), None

    if key is None:
        key = fingerprint(pending, graph, ctx)
    if key is None:
        with _lock:
            stats["uncacheable"] += 1
        ctx.stats["plan_cache_uncacheable"] += 1
        ctx.stats["planner_calls"] += 1
        return plan(pending, graph, max_stage_nodes=max_nodes), None

    with _lock:
        entry = _entries.get(key)
        hit = entry is not None and entry.matches(pending)
        if hit:
            _entries.move_to_end(key)
            entry.hits += 1
            stats["hits"] += 1
            if entry.loaded:
                stats["warm_hits"] += 1
        else:
            stats["misses"] += 1
    if hit:
        if entry.fns is None:
            entry.bind_fns(pending)      # rehydrated entry: bind live identities
        ctx.stats["plan_cache_hits"] += 1
        _note_entry_key(ctx, key)        # configure() rekeys only owned entries
        _maybe_reanalyze(ctx, entry, rw.records)
        # O(graph) template instantiation happens outside the global lock so
        # concurrent sessions on different pipelines don't serialize here.
        return _instantiate(entry, pending, graph), entry
    ctx.stats["plan_cache_misses"] += 1
    ctx.stats["planner_calls"] += 1
    stages = plan(pending, graph, max_stage_nodes=max_nodes)
    templates = _make_templates(stages, pending)
    if templates is None:
        with _lock:
            stats["uncacheable"] += 1
        return stages, None
    # Handoff analysis is structural: run it once at plan time and record the
    # decisions on the entry so warm calls replay them with zero analysis.
    ho = None
    if getattr(ctx, "handoff", True):
        from repro_torch.core import handoff as _ho
        ho = _ho.analyze(stages, getattr(ctx, "executor", None))
    with _lock:
        existing = _entries.get(key)
        if existing is not None and existing.matches(pending):
            entry = existing        # concurrent miss: keep the winner's tuner state
        else:
            if existing is not None:     # same key, other bodies: replace
                _exec_tables.pop(existing.uid, None)
            entry = PlanEntry(key=key, stage_templates=templates,
                              fns=tuple(n.fn for n in pending),
                              fn_names=tuple(n.fn.name for n in pending),
                              handoff=ho,
                              rewrites=[r.to_json() for r in rw.records])
            _entries[key] = entry
            _mark_dirty()
            while len(_entries) > _MAX_ENTRIES:
                _, evicted = _entries.popitem(last=False)
                _exec_tables.pop(evicted.uid, None)
    _note_entry_key(ctx, key)
    return stages, entry


def peek(pending: list[Node], graph: DataflowGraph, ctx) -> PlanEntry | None:
    """Read-only lookup of the entry an UNREWRITTEN pending graph maps to:
    no rewrite pass, no hit counters, no LRU reshuffle, no planning.  It
    hits only when the pass left this graph alone."""
    if not getattr(ctx, "plan_cache", True):
        return None
    key = fingerprint(pending, graph, ctx)
    if key is None:
        return None
    with _lock:
        entry = _entries.get(key)
    if entry is not None and entry.matches(pending):
        return entry
    return None


def _maybe_reanalyze(ctx, entry: PlanEntry, records: list) -> None:
    """Periodic re-analysis tick (``MOZART_REANALYZE_EVERY``, 0/unset = off).

    Every N warm hits this drops the entry's recorded handoff decisions
    (``resolve_decisions`` re-analyzes on next use, so vetoed donations get
    reconsidered), flags every stage for a pinned-executor drift re-check
    (``cost_model.AutoExecutor``) and refreshes the rewrite records from
    this capture's (a formerly declined rewrite that now applies replaces
    its MZ505 record).  A replayed script's records are the pass's own: its
    decisions are a function of ``_rewrite_key``."""
    try:
        every = int(os.environ.get("MOZART_REANALYZE_EVERY", "0") or 0)
    except ValueError:
        every = 0
    if every <= 0:
        return
    with entry._lock:
        entry.evals_since_reanalysis += 1
        if entry.evals_since_reanalysis < every:
            return
        entry.evals_since_reanalysis = 0
        entry.handoff = None             # resolve_decisions re-analyzes
        entry.ho_age = 0
        entry.rewrites = [r.to_json() for r in records]
        entry.recheck_stages = set(range(len(entry.stage_templates)))
    with _lock:
        stats["reanalysis_ticks"] += 1
    ctx.stats["reanalysis_ticks"] += 1
    _mark_dirty()


def _note_entry_key(ctx, key: tuple) -> None:
    """Record that ``ctx`` used the entry at ``key`` (scopes ``configure()``
    re-keying).  Bounded: when the set outgrows the cache capacity, drop the
    keys whose entries the LRU has already evicted."""
    ctx._entry_keys.add(key)
    if len(ctx._entry_keys) > _MAX_ENTRIES:
        with _lock:
            ctx._entry_keys &= set(_entries)


# ---------------------------------------------------------------------------
# Persistence (save / load)
# ---------------------------------------------------------------------------
#
# Fingerprint keys are nested tuples of JSON scalars; tuples are encoded as
# ``{"t": [...]}``, bytes/complex get their own markers.  Split types are
# encoded as (class name, params) and rebuilt via ``cls(*params)``; a
# save-time round-trip self-test skips any entry whose types do not
# reconstruct equal (e.g. ``UnknownSplit``, whose identity is a
# process-local uid).


def _enc(o: Any) -> Any:
    if isinstance(o, tuple):
        return {"t": [_enc(x) for x in o]}
    if isinstance(o, bytes):
        return {"b": o.hex()}
    if isinstance(o, complex):
        return {"c": [o.real, o.imag]}
    if o is None or isinstance(o, (str, int, float, bool)):
        return o
    raise TypeError(f"unpersistable fingerprint element {type(o).__name__}")


def _dec(o: Any) -> Any:
    if isinstance(o, dict):
        if "t" in o:
            return tuple(_dec(x) for x in o["t"])
        if "b" in o:
            return bytes.fromhex(o["b"])
        if "c" in o:
            return complex(o["c"][0], o["c"][1])
        raise ValueError(f"unknown marker {sorted(o)}")
    if isinstance(o, list):
        return tuple(_dec(x) for x in o)
    return o


def _split_type_classes() -> dict[str, type]:
    out: dict[str, type] = {}
    work = [st.SplitType]
    while work:
        cls = work.pop()
        out[cls.__name__] = cls
        work.extend(cls.__subclasses__())
    return out


def _type_enc(t: st.SplitType) -> dict:
    if isinstance(t, st.UnknownSplit):
        # unique per instantiation: persisted by axis, with its uid only to
        # tell apart the unknowns of one entry (the fingerprint erases it).
        # The reference skips such entries, so an Unknown-returning pipeline
        # (a serving step) would never persist.  A library's own unknown (a
        # Table's, whose merge concatenates columns) keeps its class.
        return {"cls": type(t).__name__, "params": _enc(t.params), "axis": t.axis}
    rebuilt = type(t)(*t.params)       # raises / differs => entry is skipped
    if rebuilt != t:
        raise TypeError(f"{type(t).__name__} does not round-trip from params")
    return {"cls": type(t).__name__, "params": _enc(t.params)}


def _type_dec(d: dict, classes: dict[str, type],
              unknowns: dict | None = None) -> st.SplitType:
    cls = classes[d["cls"]]
    if issubclass(cls, st.UnknownSplit):
        # one fresh unknown per persisted uid of the entry being decoded
        key = _dec(d["params"])
        memo = {} if unknowns is None else unknowns
        if key not in memo:
            memo[key] = cls(int(d["axis"]))
        return memo[key]
    return cls(*_dec(d["params"]))


def _entry_enc(e: PlanEntry) -> dict:
    with e._lock:                      # consistent snapshot vs concurrent pins
        tuned = dict(e.tuned_batch)
        chosen = dict(e.chosen_exec)
        timings = {k: dict(v) for k, v in e.exec_timings.items()}
        meta = {k: dict(v) for k, v in e.exec_meta.items()}
        blocks = dict(e.block_shape)
        quarantined = {k: dict(v) for k, v in e.quarantined.items()}
        rewrites = [dict(r) for r in e.rewrites]
    return {
        "key": _enc(e.key),
        "fn_names": list(e.fn_names),
        "rewrites": rewrites,
        "bucket": None if e.bucket is None else _enc(tuple(e.bucket)),
        "quarantined": {str(k): v for k, v in quarantined.items()},
        "tuned_batch": {str(k): v for k, v in tuned.items()},
        "chosen_exec": {str(k): v for k, v in chosen.items()},
        "exec_timings": {str(k): v for k, v in timings.items()},
        "exec_meta": {str(k): v for k, v in meta.items()},
        "block_shape": {str(k): list(v) for k, v in blocks.items()},
        "handoff": None if e.handoff is None else {
            str(sid): ho.to_json() for sid, ho in e.handoff.items()},
        "templates": [
            {
                "positions": tm.positions,
                "inputs": [[_enc(desc), _type_enc(t)] for desc, t in tm.inputs],
                "out_types": {str(p): _type_enc(t) for p, t in tm.out_types.items()},
                "arg_types": [[p, name, _type_enc(t)]
                              for (p, name), t in tm.arg_types.items()],
            }
            for tm in e.stage_templates
        ],
    }


def _entry_dec(d: dict, classes: dict[str, type]) -> PlanEntry:
    unknowns: dict = {}
    templates = [
        _StageTemplate(
            positions=[int(p) for p in tm["positions"]],
            inputs=[(_dec(desc), _type_dec(t, classes, unknowns))
                    for desc, t in tm["inputs"]],
            out_types={int(p): _type_dec(t, classes, unknowns)
                       for p, t in tm["out_types"].items()},
            arg_types={(int(p), name): _type_dec(t, classes, unknowns)
                       for p, name, t in tm["arg_types"]},
        )
        for tm in d["templates"]
    ]
    from repro_torch.core.handoff import StageHandoff
    raw_ho = d.get("handoff")
    return PlanEntry(
        key=_dec(d["key"]),
        stage_templates=templates,
        fns=None,
        fn_names=tuple(d["fn_names"]),
        tuned_batch={int(k): int(v) for k, v in d["tuned_batch"].items()},
        chosen_exec={int(k): str(v) for k, v in d["chosen_exec"].items()},
        exec_timings={int(k): {str(n): float(s) for n, s in v.items()}
                      for k, v in d["exec_timings"].items()},
        exec_meta={int(k): {str(n): int(s) for n, s in v.items()}
                   for k, v in d.get("exec_meta", {}).items()},
        block_shape={int(k): tuple(int(x) for x in v)
                     for k, v in d.get("block_shape", {}).items()},
        handoff=None if raw_ho is None else {
            int(sid): StageHandoff.from_json(ho) for sid, ho in raw_ho.items()},
        bucket=None if d.get("bucket") is None else tuple(_dec(d["bucket"])),
        quarantined={int(k): {str(n): int(a) for n, a in v.items()}
                     for k, v in d.get("quarantined", {}).items()},
        rewrites=[dict(r) for r in d.get("rewrites", [])],
        loaded=True,
    )


@contextlib.contextmanager
def _file_lock(path: str):
    """Advisory exclusive lock on a ``<path>.lock`` sidecar, so processes
    sharing one ``MOZART_PLAN_CACHE`` serialize their read-merge-write
    saves.  Platforms without ``fcntl`` fall through unlocked: the write is
    still atomic, only the cross-process merge can then race."""
    try:
        import fcntl
        lf = open(f"{path}.lock", "a+")
    except (ImportError, OSError):
        yield
        return
    try:
        fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
        yield
    finally:
        try:
            fcntl.flock(lf.fileno(), fcntl.LOCK_UN)
        finally:
            lf.close()


def save(path: str, force: bool = False) -> int:
    """Serialize every persistable cached plan to ``path``; returns the entry
    count written (0 when the file is already current).

    The payload is fsynced before the atomic rename (a host crash can lose
    the save, never corrupt the file), and the whole save runs
    read-merge-write under an advisory ``<path>.lock``: the current file is
    merged into the live cache first (live entries win), so two processes
    sharing ``MOZART_PLAN_CACHE`` cannot lose each other's entries."""
    ap = os.path.abspath(path)
    with _lock:
        if (not force and _saved_versions.get(ap) == _mutations
                and os.path.exists(path)):
            stats["persist_save_noop"] += 1
            return 0
    with _file_lock(path):
        if os.path.exists(path):
            _load(path)                  # merge concurrent sessions' entries
        with _lock:
            version = _mutations         # taken BEFORE the snapshot
            snapshot = list(_entries.values())
        encoded = []
        for e in snapshot:
            try:
                encoded.append(_entry_enc(e))
            except (TypeError, ValueError):
                stats["persist_skipped"] += 1
        payload = {
            "schema": SCHEMA_VERSION,
            "chip": _chip_name(),
            "entries": encoded,
        }
        resilience.maybe_fail("persist", where=ap)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    with _lock:
        _saved_versions[ap] = version
    stats["persist_saved"] += len(encoded)
    return len(encoded)


def load(path: str) -> int:
    """Merge persisted plans into the live cache; returns entries loaded.

    Rejects (returns 0, never raises) on: missing/corrupt file, schema
    version mismatch, cross-chip file.  Live entries win over loaded ones.
    Split-type classes unknown to this process skip only the entries that
    need them."""
    return _load(path)[0]


def _load(path: str) -> tuple[int, int]:
    """(entries loaded, entries left unresolved by missing split-type classes)."""
    try:
        with open(path) as f:
            payload = json.load(f)
        schema = payload["schema"]
        chip = payload["chip"]
        raw_entries = payload["entries"]
    except FileNotFoundError:
        stats["persist_missing"] += 1    # normal cold start, not an error
        return 0, 0
    except (OSError, ValueError, KeyError, TypeError):
        stats["persist_corrupt"] += 1
        return 0, 0
    if not isinstance(raw_entries, list):
        stats["persist_corrupt"] += 1
        return 0, 0
    if schema != SCHEMA_VERSION:
        if schema in _MIGRATABLE_SCHEMAS:
            stats[f"persist_migrated_v{schema}"] += 1
        else:
            stats["persist_rejected_schema"] += 1
            return 0, 0
    if chip != _chip_name():
        stats["persist_rejected_chip"] += 1
        return 0, 0
    classes = _split_type_classes()
    loaded = 0
    unresolved = 0
    for d in raw_entries:
        try:
            names = {tm_t["cls"] for tm in d["templates"]
                     for tm_t in _template_types(tm)}
            if not names <= classes.keys():
                # A split-type class this process has not imported yet: not
                # a corrupt entry, ``load_once`` retries it later.
                unresolved += 1
                stats["persist_unresolved"] += 1
                continue
            e = _entry_dec(d, classes)
        except (KeyError, ValueError, TypeError):
            stats["persist_skipped"] += 1
            continue
        with _lock:
            if e.key not in _entries:
                _entries[e.key] = e
                loaded += 1
                while len(_entries) > _MAX_ENTRIES:
                    _, evicted = _entries.popitem(last=False)
                    _exec_tables.pop(evicted.uid, None)
    stats["persist_loaded"] += loaded
    if loaded:
        _mark_dirty()
    return loaded, unresolved


def _template_types(tm: dict):
    yield from (t for _, t in tm["inputs"])
    yield from tm["out_types"].values()
    yield from (t for _, _, t in tm["arg_types"])


def load_once(path: str) -> int:
    """Load ``path`` at most once per process (the context's hook).  While
    entries stay unresolved (their split-type classes are not imported yet)
    the path stays retryable."""
    ap = os.path.abspath(path)
    with _lock:
        if ap in _loaded_paths:
            return 0
        _loaded_paths.add(ap)
    loaded, unresolved = _load(path)
    if unresolved:                      # retry once the classes exist
        with _lock:
            _loaded_paths.discard(ap)
    return loaded
