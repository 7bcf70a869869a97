"""The Mozart verifier: annotation linter + dataflow analyzer (plan time).

The counterpart of ``src/repro/core/analysis.py``.  Split annotations are
*claims*: ``merge(split(v)) == v``, ``F(a) == merge(F(a1..ak))``, "these two
grids may hand off chunks directly".  The paper trusts the annotator (§3.4);
this module checks the claims instead of trusting them:

1. **Contract checker** — every registered split type and AnnotatedFn is
   probed with tiny concrete inputs (``meta`` tensors for avals, real
   tensors on the probe device for the laws themselves) against the
   algebraic laws a correct SA must satisfy (MZ1xx codes).
2. **Dataflow analyzer** — a traced pipeline's stage plan and handoff
   decisions are re-examined for dead stages, donation hazards, and
   handoff fallbacks *with reasons* (MZ2xx codes); the static rewrite pass
   runs dry beside it (MZ5xx info notes).

The MZ3xx codes are raised at run time by the boundary sanitizer in
``core/stage_exec.py`` (``MOZART_SANITIZE=1``); the MZ4xx codes are the
resilience events (``resilience.events()``).  ``launch/lint.py`` runs this
module over the whole repo.

Diagnostics are structured (code, severity, subject, message) so tests pin
codes, not prose.  ``mozart.verify(...)`` is the API.  Laws are *data*
(``CONTRACT_LAWS``): the property tests iterate the same list the linter
runs, so a new law is both linted and unit-tested.

The entry points run on the card unless the caller asks for the CPU:
``builtin_probes``, ``check_annotated_ops`` and ``verify`` take
``device="cuda"`` by default, and with a target ``verify`` gives ``device``
to the throwaway context it traces under.  Comparisons move leaves to the
host (``_tree_allclose``): exact for integer and bool leaves, ``rtol=1e-4,
atol=1e-5`` in float64 for the rest, as the reference compares.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import hardware
from repro_torch.core import handoff as handoff_mod
from repro_torch.core import plan_cache as pc
from repro_torch.core import rewrite as rewrite_mod
from repro_torch.core import runtime
from repro_torch.core import split_types as st
from repro_torch.core import stage_exec
from repro_torch.core.graph import DataflowGraph, NodeRef
from repro_torch.core.planner import Stage, plan

# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

#: Stable diagnostic codes.  MZ1xx = annotation contract, MZ2xx = pipeline
#: dataflow, MZ3xx = runtime boundary sanitizer (MOZART_SANITIZE=1),
#: MZ4xx = resilience events (core/resilience.py: faults, demotion,
#: quarantine, serving failure domains), MZ5xx = static graph rewrites
#: (core/rewrite.py: applied rewrites and justified declines).
CODES: dict[str, str] = {
    "MZ101": "split followed by merge does not reproduce the value",
    "MZ102": "merge is not associative",
    "MZ103": "info() extents are inconsistent with split() slicing",
    "MZ104": "ReduceSplit merge disagrees with its declared combiner",
    "MZ105": "can_handoff granted for a grid the consumer cannot ingest",
    "MZ106": "rechunk exceeded the at-most-one-copy bound or corrupted data",
    "MZ107": "split type does not round-trip through its params",
    "MZ108": "annotated function violates the SA condition F(a) = merge(F(a1..ak))",
    "MZ109": "degenerate merges misbehave (empty / singleton / zero-size pieces)",
    "MZ110": "registered architecture config failed to construct",
    "MZ201": "dead stage: output has no consumer and no live Future",
    "MZ202": "donation hazard: donation point whose producer Future is live",
    "MZ203": "handoff fallback: edge materializes instead of streaming",
    "MZ204": "unsplittable arguments force whole-value execution",
    "MZ205": "plan-cache entry can never replay under its guards",
    "MZ301": "use-after-donate: donated chunk buffers were observed",
    "MZ302": "stream ranges do not tile the value's extent",
    "MZ303": "scoped boundary counters disagree with the global tallies",
    "MZ401": "fault fired at an instrumented boundary (injected or real)",
    "MZ402": "executor demoted down the degradation ladder",
    "MZ403": "chunk batch halved after resource exhaustion and re-pinned",
    "MZ404": "executor quarantined in the plan entry (aging until retry)",
    "MZ405": "serving step failed; affected requests failed, driver survived",
    "MZ406": "transient error swallowed at a probe site (counted, not hidden)",
    "MZ501": "dead stage eliminated by the rewrite pass",
    "MZ502": "common subexpression shared: duplicate call collapsed",
    "MZ503": "selective stage pushed ahead of an elementwise map",
    "MZ504": "stage chain reassociated into fewer stages for splitting",
    "MZ505": "rewrite declined with reason",
}

_SEV_ORDER = {"error": 0, "warning": 1, "info": 2}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One structured finding.  ``code`` is stable; prose is not."""

    code: str
    severity: str                  # "error" | "warning" | "info"
    subject: str                   # what was checked (type, op, stage edge)
    message: str
    where: str = ""                # optional extra location (grid, law name)

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.code} {self.severity}: {self.subject}: {self.message}{loc}"


@dataclasses.dataclass
class Report:
    """A batch of diagnostics plus how many subjects were checked."""

    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)
    checked: int = 0

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def extend(self, more: "Report | Iterable[Diagnostic]") -> "Report":
        if isinstance(more, Report):
            self.diagnostics.extend(more.diagnostics)
            self.checked += more.checked
        else:
            self.diagnostics.extend(more)
        return self

    def render(self, verbose: bool = False) -> str:
        lines = []
        shown = sorted(
            self.diagnostics,
            key=lambda d: (_SEV_ORDER.get(d.severity, 3), d.code, d.subject))
        for d in shown:
            if d.severity == "info" and not verbose:
                continue
            lines.append(str(d))
        hidden = len(self.diagnostics) - len(lines)
        tail = f" ({hidden} info notes hidden; -v shows them)" if hidden else ""
        lines.append(
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s) "
            f"across {self.checked} checked subject(s){tail}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "checked": self.checked,
            "ok": self.ok,
            "diagnostics": [dataclasses.asdict(d) for d in self.diagnostics],
        }


# ---------------------------------------------------------------------------
# Small helpers shared by the laws
# ---------------------------------------------------------------------------


def _grid(n: int, k: int) -> list[tuple[int, int]]:
    """k contiguous ranges tiling [0, n) (last one ragged)."""
    k = max(min(int(k), int(n)), 1)
    b = -(-n // k)
    return [(s, min(s + b, n)) for s in range(0, n, b)]


def _host(x: Any) -> torch.Tensor:
    """A leaf as a CPU tensor (Python and numpy scalars included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.as_tensor(np.asarray(x))


def _tree_allclose(a: Any, b: Any, rtol: float = 1e-4, atol: float = 1e-5) -> bool:
    la, ta = pytree.tree_flatten(a)
    lb, tb = pytree.tree_flatten(b)
    if str(ta) != str(tb) or len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = _host(x), _host(y)
        if x.shape != y.shape:
            return False
        if x.dtype == torch.bool or not (x.is_floating_point() or x.is_complex()):
            if not bool((x == y).all()):
                return False
            continue
        wide = torch.promote_types(torch.promote_types(x.dtype, y.dtype), torch.float64)
        if not torch.allclose(x.to(wide), y.to(wide), rtol=rtol, atol=atol):
            return False
    return True


def _nbytes(value: Any) -> int:
    return sum(st.nbytes_of(l) for l in pytree.tree_leaves(value))


def _callable_name(fn: Any) -> str:
    return getattr(fn, "name", None) or getattr(fn, "__name__", repr(fn))


# ---------------------------------------------------------------------------
# Probes: one concrete exercise of one split type
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Probe:
    """Concrete material for checking one split type against the laws.

    ``value`` + ``extent_of`` drive the split-based laws (MZ101/103/105/
    106); ``pieces`` drive the merge-only laws (MZ102/104/109) for output-
    only types whose values cannot be split.  ``reference`` is the
    independently-known merge of ``pieces`` (for ConcatSplit-family grid
    checks).  ``supports_split`` overrides ``split_type.splittable`` for
    types like ``unknown`` that report splittable but raise from split().
    """

    name: str
    split_type: st.SplitType
    value: Any = None
    pieces: list | None = None
    reference: Any = None
    extent_of: Callable[[Any], int] | None = None
    consumers: tuple = ()
    supports_split: bool | None = None
    expect_unique: bool = False    # identity is unique-per-instance by design

    @property
    def can_split(self) -> bool:
        if self.supports_split is not None:
            return self.supports_split
        return bool(self.split_type.splittable) and self.value is not None

    def extent(self) -> int | None:
        if self.value is None or self.extent_of is None:
            return None
        return int(self.extent_of(self.value))


def builtin_probes(n: int = 12, device: torch.device | str = "cuda") -> list[Probe]:
    """Probes for every split type the repo ships (core + integrations), the
    reference's values on ``device``."""
    from repro_torch.core import annotated_nlp as nlp
    from repro_torch.core import annotated_table as tbl

    dev = runtime.resolve_device(device)
    n = max(int(n), 8)
    f32 = dict(dtype=torch.float32, device=dev)
    probes: list[Probe] = []

    m0 = torch.arange(n * 3, **f32).reshape(n, 3) / (n * 3)
    m1 = torch.arange(3 * n, **f32).reshape(3, n) / (3 * n)
    probes.append(Probe(
        "ArraySplit/axis0", st.ArraySplit((n, 3), 0), value=m0,
        extent_of=lambda v: int(v.shape[0]),
        consumers=(st.ArraySplit((n, 3), 0), st.ArraySplit((n, 3), 1))))
    probes.append(Probe(
        "ArraySplit/axis1", st.ArraySplit((3, n), 1), value=m1,
        extent_of=lambda v: int(v.shape[1]),
        consumers=(st.ArraySplit((3, n), 1),)))

    scalar = torch.tensor(1.5, **f32)
    probes.append(Probe("ScalarSplit", st.BROADCAST,
                        pieces=[scalar, scalar, scalar], reference=scalar))

    r = np.random.RandomState(0)
    partials = [torch.from_numpy(r.uniform(0.5, 2.0, (3,)).astype(np.float32)).to(dev)
                for _ in range(4)]
    for op in ("add", "mul", "max", "min"):
        probes.append(Probe(f"ReduceSplit/{op}", st.ReduceSplit(op),
                            pieces=list(partials)))

    rows = [3, 1, n - 4]
    fresh = []
    s0 = 0
    for k in rows:
        fresh.append(torch.arange(s0, s0 + k * 2, **f32).reshape(k, 2))
        s0 += k * 2
    probes.append(Probe(
        "ConcatSplit", st.ConcatSplit("t", 0), pieces=list(fresh),
        reference=torch.cat(fresh, dim=0),
        consumers=(st.ArraySplit((n, 2), 0), st.ArraySplit((n, 2), 1))))

    probes.append(Probe(
        "UnknownSplit", st.UnknownSplit(), pieces=list(fresh),
        reference=torch.cat(fresh, dim=0),
        supports_split=False, expect_unique=True))

    tree = {"w": m0, "b": torch.linspace(0.0, 1.0, n, **f32)}
    treedef = pytree.tree_structure(tree)
    probes.append(Probe(
        "PytreeSplit", st.PytreeSplit(str(treedef), n, 0), value=tree,
        extent_of=lambda v: int(pytree.tree_leaves(v)[0].shape[0]),
        consumers=(st.PytreeSplit(str(treedef), n, 0),)))

    table = tbl.Table({
        "k": torch.from_numpy((np.arange(n) % 3).astype(np.int32)).to(dev),
        "v": torch.linspace(0.5, 2.0, n, **f32)})
    probes.append(Probe(
        "TableSplit", tbl.TableSplit(n), value=table,
        extent_of=lambda v: v.nrows))
    probes.append(Probe(
        "TableUnknown", tbl.TableUnknown(),
        pieces=[tbl.TableSplit(n).split(table, s, e) for s, e in _grid(n, 3)],
        supports_split=False, expect_unique=True))
    for op in ("sum", "count", "mean", "max", "min"):
        gparts = [tbl._group_reduce_partial(
            tbl.TableSplit(n).split(table, s, e), "k", "v", op)
            for s, e in _grid(n, 3)]
        probes.append(Probe(f"GroupSplit/{op}", tbl.GroupSplit(op, "k", "v"),
                            pieces=gparts))

    corpus = nlp.make_corpus(n, max_len=8, vocab=50, seed=0, device=dev)
    probes.append(Probe(
        "CorpusSplit", nlp.CorpusSplit(n), value=corpus,
        extent_of=lambda v: v.n_docs))
    return probes


# ---------------------------------------------------------------------------
# Contract laws (MZ1xx).  Each law: Probe -> list[Diagnostic].
# ---------------------------------------------------------------------------


def _law_split_merge_identity(p: Probe) -> list[Diagnostic]:
    """MZ101: merge(split(v, grid)) must reproduce v for every grid."""
    ext = p.extent()
    if not p.can_split or ext is None or ext < 2:
        return []
    t = p.split_type
    for k in (2, 3, ext):
        ranges = _grid(ext, k)
        merged = t.merge([t.split(p.value, s, e) for s, e in ranges])
        if not _tree_allclose(merged, p.value):
            return [Diagnostic("MZ101", "error", p.name, CODES["MZ101"],
                               where=f"grid={ranges}")]
    return []


def _law_merge_associative(p: Probe) -> list[Diagnostic]:
    """MZ102: merge(a,b,c) == merge(merge(a,b),c) == merge(a,merge(b,c))."""
    t = p.split_type
    pieces = p.pieces
    if pieces is None:
        ext = p.extent()
        if not p.can_split or ext is None or ext < 3:
            return []
        pieces = [t.split(p.value, s, e) for s, e in _grid(ext, 3)]
    if len(pieces) < 3:
        return []
    flat = t.merge(list(pieces))
    left = t.merge([t.merge(list(pieces[:2]))] + list(pieces[2:]))
    right = t.merge([pieces[0], t.merge(list(pieces[1:]))])
    if not (_tree_allclose(flat, left) and _tree_allclose(flat, right)):
        return [Diagnostic("MZ102", "error", p.name, CODES["MZ102"])]
    return []


def _law_info_consistent(p: Probe) -> list[Diagnostic]:
    """MZ103: info().num_elements matches the value; split ranges slice it."""
    ext = p.extent()
    if p.value is None or ext is None:
        return []
    t = p.split_type
    info = t.info(p.value)
    if info is None:
        return []
    diags = []
    if int(info.num_elements) != ext:
        diags.append(Diagnostic(
            "MZ103", "error", p.name,
            f"info().num_elements = {info.num_elements} but the value has "
            f"{ext} elements"))
    if int(info.elem_bytes) < 1:
        diags.append(Diagnostic(
            "MZ103", "error", p.name,
            f"info().elem_bytes = {info.elem_bytes} (must be >= 1)"))
    if p.can_split and not diags:
        for s, e in _grid(ext, 3):
            got = int(p.extent_of(t.split(p.value, s, e)))
            if got != e - s:
                diags.append(Diagnostic(
                    "MZ103", "error", p.name,
                    f"split(v, {s}, {e}) has {got} elements, expected {e - s}"))
                break
    return diags


#: an independent host-side fold per ReduceSplit op name
_FOLDS = {"add": torch.add, "mul": torch.mul,
          "max": torch.maximum, "min": torch.minimum}


def _law_reduce_combiner(p: Probe) -> list[Diagnostic]:
    """MZ104: a ReduceSplit's merge must equal its declared combiner fold."""
    t = p.split_type
    if not isinstance(t, st.ReduceSplit) or not p.pieces:
        return []
    ref_op = _FOLDS.get(t.op_name)
    if ref_op is None:
        return [Diagnostic("MZ104", "error", p.name,
                           f"op_name {t.op_name!r} has no reference combiner")]
    expect = _host(p.pieces[0])
    for piece in p.pieces[1:]:
        expect = ref_op(expect, _host(piece))
    got = t.merge(list(p.pieces))
    if not _tree_allclose(got, expect):
        return [Diagnostic(
            "MZ104", "error", p.name,
            f"merge disagrees with an independent {t.op_name!r} fold")]
    return []


def _law_handoff_grid(p: Probe) -> list[Diagnostic]:
    """MZ105: a granted handoff must mean producer chunks ARE the
    consumer's split outputs (splittable types), or that concrete fresh
    pieces that tile the extent are re-wrapped correctly (ConcatSplit)."""
    t = p.split_type
    diags: list[Diagnostic] = []
    for ct in p.consumers:
        if not t.can_handoff(ct):
            continue
        ext = p.extent()
        if p.can_split and ext is not None:
            for s, e in _grid(ext, 3):
                if not _tree_allclose(t.split(p.value, s, e),
                                      ct.split(p.value, s, e)):
                    diags.append(Diagnostic(
                        "MZ105", "error", p.name,
                        f"chunk [{s}:{e}) under {t} is not what {ct} "
                        "would have split out", where=f"consumer={ct}"))
                    break
        elif p.pieces is not None and p.reference is not None:
            ranges = [(i, i + 1) for i in range(len(p.pieces))]
            aval = pytree.tree_map(st.aval_of, p.reference)
            stream = stage_exec.ChunkStream(list(p.pieces), ranges, t, aval)
            adapted = stage_exec.adapt_stream(stream, ct)
            if adapted is None:
                if isinstance(ct, st.ArraySplit) and ct.shape and \
                        sum(int(c.shape[ct.axis]) if c.dim() > ct.axis else -1
                            for c in p.pieces) == ct.shape[ct.axis]:
                    diags.append(Diagnostic(
                        "MZ105", "error", p.name,
                        "pieces tile the consumer extent but the granted "
                        "conversion was refused", where=f"consumer={ct}"))
                continue
            for (s, e), chunk in zip(adapted.ranges, adapted.chunks):
                if not _tree_allclose(chunk, ct.split(p.reference, s, e)):
                    diags.append(Diagnostic(
                        "MZ105", "error", p.name,
                        f"adapted chunk [{s}:{e}) differs from "
                        f"{ct}.split of the merged value",
                        where=f"consumer={ct}"))
                    break
    return diags


def _law_rechunk_single_copy(p: Probe) -> list[Diagnostic]:
    """MZ106: rechunk preserves data and copies at most the value once;
    an aligned (identical-grid) rechunk must be zero-copy."""
    ext = p.extent()
    if not p.can_split or ext is None or ext < 4:
        return []
    t = p.split_type
    total = _nbytes(p.value)
    src = _grid(ext, 4)
    chunks = [t.split(p.value, s, e) for s, e in src]
    diags: list[Diagnostic] = []
    for k in (2, 8, ext):
        dst = _grid(ext, k)
        new_chunks, copied = t.rechunk(chunks, src, dst)
        if copied > total:
            diags.append(Diagnostic(
                "MZ106", "error", p.name,
                f"rechunk {len(src)}->{len(dst)} copied {copied} bytes "
                f"(> one copy of the {total}-byte value)"))
        if not _tree_allclose(t.merge(new_chunks), p.value):
            diags.append(Diagnostic(
                "MZ106", "error", p.name,
                f"rechunk {len(src)}->{len(dst)} corrupted the data"))
        for (s, e), c in zip(dst, new_chunks):
            if int(p.extent_of(c)) != e - s:
                diags.append(Diagnostic(
                    "MZ106", "error", p.name,
                    f"rechunked chunk [{s}:{e}) has "
                    f"{int(p.extent_of(c))} elements"))
                break
        if diags:
            return diags
    _, copied = t.rechunk(chunks, src, src)
    if copied != 0:
        diags.append(Diagnostic(
            "MZ106", "error", p.name,
            f"aligned rechunk copied {copied} bytes (must pass through)"))
    return diags


def _law_params_round_trip(p: Probe) -> list[Diagnostic]:
    """MZ107: type(t)(*t.params) must rebuild an equal type — the plan
    cache persists types this way.  unknown-family types are unique per
    instance BY DESIGN, so their non-round-trip is an info note (the cache
    skips them via the same check)."""
    t = p.split_type
    sev = "info" if p.expect_unique else "error"
    try:
        rebuilt = type(t)(*t.params)
    except Exception as e:  # noqa: BLE001 - any ctor failure is the finding
        return [Diagnostic("MZ107", sev, p.name,
                           f"reconstructing from params raised "
                           f"{type(e).__name__}: {e}")]
    if rebuilt != t:
        msg = ("unique-per-instance identity does not persist (expected for "
               "unknown-family types; the plan cache skips these entries)"
               if p.expect_unique else
               f"type(t)(*t.params) rebuilt {rebuilt}, not {t}")
        return [Diagnostic("MZ107", sev, p.name, msg)]
    return []


def _law_degenerate_merge(p: Probe) -> list[Diagnostic]:
    """MZ109: merge([]) raises a clear ValueError; merge([x]) is identity;
    zero-size pieces are merge-neutral."""
    t = p.split_type
    diags: list[Diagnostic] = []
    try:
        t.merge([])
    except ValueError:
        pass
    except Exception as e:  # noqa: BLE001 - the obscure raise IS the finding
        diags.append(Diagnostic(
            "MZ109", "error", p.name,
            f"merge([]) raised {type(e).__name__} instead of a clear "
            "ValueError"))
    else:
        diags.append(Diagnostic(
            "MZ109", "warning", p.name,
            "merge([]) silently returned a value; an empty chunk list has "
            "no identity element for this type"))
    base = None
    if p.pieces:
        base = p.pieces[0]
    elif p.can_split and p.extent():
        base = t.split(p.value, 0, p.extent())
    if base is not None and not _tree_allclose(t.merge([base]), base):
        diags.append(Diagnostic(
            "MZ109", "error", p.name, "merge([x]) is not the identity"))
    ext = p.extent()
    if p.can_split and ext is not None and ext >= 2:
        k = ext // 2
        pieces = [t.split(p.value, 0, k), t.split(p.value, k, k),
                  t.split(p.value, k, ext)]
        if not _tree_allclose(t.merge(pieces), p.value):
            diags.append(Diagnostic(
                "MZ109", "error", p.name,
                "a zero-size piece in the chunk list changed the merge"))
    return diags


@dataclasses.dataclass(frozen=True)
class ContractLaw:
    code: str
    name: str
    check: Callable[[Probe], list[Diagnostic]]


#: The single source of truth for the MZ1xx laws.  The linter sweeps these
#: over every probe; the tests parameterize over the same list.
CONTRACT_LAWS: tuple[ContractLaw, ...] = (
    ContractLaw("MZ101", "split_merge_identity", _law_split_merge_identity),
    ContractLaw("MZ102", "merge_associative", _law_merge_associative),
    ContractLaw("MZ103", "info_consistent", _law_info_consistent),
    ContractLaw("MZ104", "reduce_combiner", _law_reduce_combiner),
    ContractLaw("MZ105", "handoff_grid", _law_handoff_grid),
    ContractLaw("MZ106", "rechunk_single_copy", _law_rechunk_single_copy),
    ContractLaw("MZ107", "params_round_trip", _law_params_round_trip),
    ContractLaw("MZ109", "degenerate_merge", _law_degenerate_merge),
)


def check_split_type(probe: Probe,
                     laws: Sequence[ContractLaw] = CONTRACT_LAWS
                     ) -> list[Diagnostic]:
    """Run every contract law against one probe."""
    diags: list[Diagnostic] = []
    for law in laws:
        try:
            diags.extend(law.check(probe))
        except Exception as e:  # noqa: BLE001 - a crashing law is a finding
            diags.append(Diagnostic(
                law.code, "error", probe.name,
                f"law {law.name!r} crashed: {type(e).__name__}: {e}"))
    return diags


def check_split_types(probes: Sequence[Probe] | None = None, n: int = 12,
                      device: torch.device | str = "cuda") -> Report:
    rep = Report()
    for probe in (probes if probes is not None else builtin_probes(n, device)):
        rep.diagnostics.extend(check_split_type(probe))
        rep.checked += 1
    return rep


# ---------------------------------------------------------------------------
# The SA condition itself (MZ108): F(a) == merge(F(a1..ak))
# ---------------------------------------------------------------------------


def _resolve_call_types(fn, bound: dict[str, Any]):
    """Concrete (arg_types, out_type) for one call, generics resolved the
    way the planner would: each generic binds to the default split type of
    the first value it sees (paper §5.1 inference, collapsed to one call)."""
    dynamic = bool(getattr(fn.sa, "dynamic", False))
    out_aval = None if dynamic else fn.abstract_eval(bound)
    arg_types, out_type = fn.construct_types(bound, bound, out_aval)
    env = st.TypeEnv()
    resolved: dict[str, Any] = {}
    for name, v in bound.items():
        t = arg_types[name]
        if isinstance(t, st.GenericVar):
            c = env.resolve(t)
            if isinstance(c, st.GenericVar):
                env.unify(t, st.default_split_type(v))
            t = env.resolve(t)
        resolved[name] = t
    if isinstance(out_type, st.GenericVar):
        out_type = env.resolve(out_type)
        if isinstance(out_type, st.GenericVar):
            out_type = (st.default_split_type(out_aval)
                        if out_aval is not None else st.UnknownSplit())
    return resolved, out_type, out_aval


def check_annotated_fn(fn, kwargs: dict[str, Any], chunks: int = 3,
                       subject: str | None = None) -> list[Diagnostic]:
    """MZ108: run the function whole and chunked; the merged chunked
    outputs must equal the whole-value output (the SA condition, §3.4).
    The function runs bare (``call_raw``): the check is of the function,
    not of the boundary's narrowing."""
    subject = subject or _callable_name(fn)
    b = fn.signature.bind(**kwargs)
    b.apply_defaults()
    bound = dict(b.arguments)
    try:
        resolved, out_type, _ = _resolve_call_types(fn, bound)
    except Exception as e:  # noqa: BLE001 - ctor crashes are findings too
        return [Diagnostic("MZ108", "error", subject,
                           f"split-type construction crashed: "
                           f"{type(e).__name__}: {e}")]
    counts: dict[str, int] = {}
    for name, v in bound.items():
        t = resolved[name]
        if not (isinstance(t, st.SplitType) and t.splittable):
            continue
        info = t.info(v)
        if info is None:
            continue
        counts[name] = int(info.num_elements)
    if not counts:
        return []                      # nothing splittable: whole-value SA
    if len(set(counts.values())) != 1:
        return [Diagnostic(
            "MZ103", "error", subject,
            f"splittable arguments disagree on element count: {counts}")]
    n = next(iter(counts.values()))
    if n < 2:
        return []
    full = fn.call_raw(bound)
    pieces_out = []
    for s, e in _grid(n, min(chunks, n)):
        piece_bound = {
            name: (resolved[name].split(v, s, e) if name in counts else v)
            for name, v in bound.items()}
        pieces_out.append(fn.call_raw(piece_bound))
    try:
        merged = out_type.merge(pieces_out)
    except Exception as e:  # noqa: BLE001 - merge crash = broken annotation
        return [Diagnostic(
            "MZ108", "error", subject,
            f"merging per-chunk outputs under {out_type} raised "
            f"{type(e).__name__}: {e}")]
    if not _tree_allclose(full, merged):
        return [Diagnostic(
            "MZ108", "error", subject,
            f"F(a) != {out_type}.merge(F(a1..a{len(pieces_out)})) — the "
            "annotation claims a split this function does not satisfy")]
    return []


_INTEGRATION_MODULES = (
    "repro_torch.core.annotated_numpy",
    "repro_torch.core.annotated_image",
    "repro_torch.core.annotated_nlp",
    "repro_torch.core.annotated_table",
)


def check_annotated_ops(n: int = 12, device: torch.device | str = "cuda") -> Report:
    """Sweep the SA condition over every integration's annotated ops,
    using each module's ``__probe_examples__`` inputs on ``device``."""
    import importlib

    dev = runtime.resolve_device(device)
    rep = Report()
    for modname in _INTEGRATION_MODULES:
        mod = importlib.import_module(modname)
        examples = getattr(mod, "__probe_examples__",
                           lambda n=12, device=None: {})(n, device=dev)
        short = modname.rsplit(".", 1)[-1].replace("annotated_", "")
        for opname in sorted(getattr(mod, "__all_ops__", {})):
            fn = mod.__all_ops__[opname]
            ex = examples.get(opname)
            if ex is None:
                rep.diagnostics.append(Diagnostic(
                    "MZ108", "warning", f"{short}.{opname}",
                    "no probe example; the SA condition is unchecked"))
                continue
            for kwargs in (ex if isinstance(ex, list) else [ex]):
                rep.diagnostics.extend(check_annotated_fn(
                    fn, kwargs, subject=f"{short}.{opname}"))
                rep.checked += 1
    return rep


# ---------------------------------------------------------------------------
# Dataflow analyzer (MZ2xx)
# ---------------------------------------------------------------------------


def _executor_stream_capable(executor: str | None) -> bool | None:
    if not executor or executor == "auto":
        return True
    try:
        return bool(stage_exec.get_executor(executor).stream_capable)
    except Exception:  # noqa: BLE001 - unknown executor: no judgement
        return None


def analyze_dataflow(stages: Sequence[Stage], graph: DataflowGraph,
                     ho_map: dict[int, Any] | None,
                     executor: str | None = None) -> Report:
    """Re-examine a planned pipeline: dead stages (MZ201), donation hazards
    (MZ202), handoff fallbacks with reasons (MZ203), whole-value stages
    (MZ204)."""
    rep = Report()
    ho_map = ho_map or {}
    cons = graph.consumers()
    producer: dict[int, Stage] = {}
    for s in stages:
        for node in s.nodes:
            producer[node.id] = s
    stream_cap = _executor_stream_capable(executor)
    if stream_cap is False:
        rep.diagnostics.append(Diagnostic(
            "MZ203", "info", f"executor {executor!r}",
            "executor cannot ingest chunk streams; every cross-stage edge "
            "materializes"))
    for s in stages:
        rep.checked += 1
        for node in s.nodes:
            if not cons.get(node.id) and not node.future_alive():
                rep.diagnostics.append(Diagnostic(
                    "MZ201", "warning",
                    f"stage {s.id} node {node.fn.name}#{node.id}",
                    CODES["MZ201"]))
        ho = ho_map.get(s.id)
        stream_in = ho.stream_in if ho else frozenset()
        last_use = ho.last_use if ho else frozenset()
        vetoed = getattr(ho, "vetoed", frozenset()) if ho else frozenset()
        inputs = list(s.inputs.items())

        chunkable = any(
            getattr(si.split_type, "splittable", False)
            and not isinstance(si.split_type, st.ScalarSplit)
            for _, si in inputs)
        if not chunkable and inputs:
            types = sorted({type(si.split_type).__name__ for _, si in inputs})
            rep.diagnostics.append(Diagnostic(
                "MZ204", "info", f"stage {s.id}",
                f"no splittable input ({', '.join(types)}); the stage runs "
                "whole-value"))

        for i, (key, si) in enumerate(inputs):
            v = si.value
            if not isinstance(v, NodeRef):
                continue
            ps = producer.get(v.node_id)
            if ps is None or ps.id == s.id:
                continue
            edge = f"stage {ps.id}->stage {s.id} input {s.ckey(key)}"
            if i in stream_in and stream_cap is not False:
                pass                   # streams: nothing to report
            else:
                pt = ps.out_types.get(v.node_id)
                reason = None
                if pt is not None:
                    reason = handoff_mod.edge_fallback_reason(
                        pt, si.split_type, handoff_mod._stage_count(ps))
                if i in stream_in:     # plan said stream; executor cannot
                    reason = f"stream-incapable executor ({executor})"
                elif reason is None:
                    reason = ("a sibling consumer of the same value rejected "
                              "the grid, forcing one merge for all consumers")
                sev = "warning" if "axis mismatch" in reason else "info"
                rep.diagnostics.append(Diagnostic(
                    "MZ203", sev, edge, f"handoff fallback: {reason}"))
            if i in last_use:
                node = graph.nodes.get(v.node_id)
                if node is not None and node.future_alive():
                    rep.diagnostics.append(Diagnostic(
                        "MZ202", "error", edge,
                        "donation point but the producer's Future is live — "
                        "use-after-donate is reachable (handoff.analyze "
                        "should have vetoed this edge)"))
            if i in vetoed:
                node = graph.nodes.get(v.node_id)
                if node is not None and not node.future_alive():
                    rep.diagnostics.append(Diagnostic(
                        "MZ202", "info", edge,
                        "stale donation veto: the producer's Future is gone; "
                        "the edge pays defensive copies until re-analysis"))
    return rep


def _trace(fn: Callable, args: tuple, config: dict):
    """``fn(*args)`` registered under a throwaway lazy context; returns the
    context and the outputs (whose Futures must outlive the analysis)."""
    ctx = runtime.MozartContext(**config)
    stack = runtime._stack()
    stack.append(ctx)
    try:
        out = fn(*args)
    finally:
        stack.pop()
    return ctx, out


def verify_pipeline(fn: Callable, *args, **config) -> Report:
    """Trace ``fn`` under a throwaway lazy context, plan it, and run the
    dataflow analyzer over the resulting stages.  Never executes the
    pipeline, lowers no kernel program and never mutates the plan cache (a
    read-only ``peek`` reuses recorded handoff decisions when the entry
    already carries fresh ones).  The MZ2xx analysis always runs over the
    UNREWRITTEN plan — the verifier reports on the program as written (a
    dead stage must still surface as MZ201) — and the static rewrite pass
    then runs dry on the throwaway graph to report what it *would* do as
    MZ5xx info diagnostics.  ``config`` is the context's (``device`` among
    it: the card unless ``device="cpu"``)."""
    config.setdefault("executor", "auto")
    ctx, out = _trace(fn, args, config)
    pending = ctx.graph.pending()
    if not pending:
        rep = Report(checked=1)
        rep.diagnostics.append(Diagnostic(
            "MZ201", "warning", _callable_name(fn),
            "pipeline registered no annotated calls; nothing to analyze"))
        return rep
    stages = plan(pending, ctx.graph,
                  max_stage_nodes=None if ctx.pipeline else 1)
    ho = None
    if getattr(ctx, "handoff", True):
        entry = pc.peek(pending, ctx.graph, ctx)
        if (entry is not None and entry.handoff is not None
                and handoff_mod.decisions_fresh(entry.handoff, stages)):
            ho = entry.handoff
            with pc._lock:
                pc.stats["verify_handoff_reused"] += 1
        else:
            ho = handoff_mod.analyze(stages, ctx.executor)
    rep = analyze_dataflow(stages, ctx.graph, ho, executor=ctx.executor)
    if getattr(ctx, "rewrite", True):
        rw = rewrite_mod.apply(pending, ctx.graph, ctx)
        rep.extend(rewrite_mod.records_to_diagnostics(rw.records))
    del out                            # keep Futures alive through analysis
    return rep


def rewrite_report(fn: Callable, *args, **config) -> Report:
    """Dry-run the static rewrite pass (``core/rewrite.py``) over one traced
    pipeline and report every MZ5xx rewrite it would apply (or decline),
    with cost-model deltas, without executing anything or mutating any plan
    cache."""
    config.setdefault("executor", "auto")
    config.setdefault("plan_cache", False)
    ctx, out = _trace(fn, args, config)
    pending = ctx.graph.pending()
    rep = Report(checked=1)
    if not pending:
        return rep
    rw = rewrite_mod.apply(pending, ctx.graph, ctx)
    rep.extend(rewrite_mod.records_to_diagnostics(rw.records))
    del out                            # keep Futures alive through the pass
    return rep


# ---------------------------------------------------------------------------
# Plan-cache guard analysis (MZ205)
# ---------------------------------------------------------------------------


def check_plan_cache(path: str | None = None) -> Report:
    """Flag live or persisted plan-cache entries whose key guards can never
    match on this host (wrong executor / chip / schema): they occupy cache
    slots but never replay.  A live key's chip guard is held against the
    chip its device type has here (the card's name for ``cuda``, where
    there is a card; the host's for any other); a file's against
    ``plan_cache._chip_name()``, as ``load`` holds it."""
    rep = Report()
    avail = set(stage_exec.available_executors())
    chip = pc._chip_name()
    with pc._lock:
        keys = list(pc._entries.keys())
    for key in keys:
        rep.checked += 1
        if len(key) <= max(pc._P_EXEC, pc._P_CHIP, pc._P_DEV):
            continue                   # not a key of the fields read here
        subject = f"plan entry executor={key[pc._P_EXEC]!r}"
        if key[pc._P_EXEC] not in avail:
            rep.diagnostics.append(Diagnostic(
                "MZ205", "error", subject,
                f"executor {key[pc._P_EXEC]!r} is not registered on this "
                f"host (available: {sorted(avail)}); the entry never replays"))
        want = chip if key[pc._P_DEV] == "cuda" else hardware.CPU_HOST.name
        if key[pc._P_CHIP] != want:
            rep.diagnostics.append(Diagnostic(
                "MZ205", "warning", subject,
                f"chip guard {key[pc._P_CHIP]!r} != current target {want!r}; "
                "the entry never replays here"))
    if path is None:
        path = os.environ.get("MOZART_PLAN_CACHE") or None
    if path and os.path.exists(path):
        rep.checked += 1
        try:
            with open(path, encoding="utf-8") as f:
                blob = json.load(f)
        except (OSError, ValueError) as e:
            rep.diagnostics.append(Diagnostic(
                "MZ205", "warning", path,
                f"persisted plan cache unreadable ({type(e).__name__}); "
                "load() rejects it (stats['persist_corrupt']) and replans"))
            return rep
        schema = blob.get("schema")
        if schema != pc.SCHEMA_VERSION and schema not in pc._MIGRATABLE_SCHEMAS:
            rep.diagnostics.append(Diagnostic(
                "MZ205", "error", path,
                f"schema {schema!r} is neither current ({pc.SCHEMA_VERSION}) "
                f"nor migratable {pc._MIGRATABLE_SCHEMAS}; the file never "
                "loads"))
        if blob.get("chip") != chip:
            rep.diagnostics.append(Diagnostic(
                "MZ205", "warning", path,
                f"file chip {blob.get('chip')!r} != current target {chip!r}; "
                "the file never loads here"))
    return rep


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def verify(target: Callable | None = None, *args, n: int = 12,
           plan_cache_path: str | None = None,
           device: torch.device | str = "cuda", **config) -> Report:
    """``mozart.verify()``: lint every registered annotation on ``device``
    (no target), or trace + analyze one pipeline under a throwaway context
    on ``device`` (``mozart.verify(fn, *args)``)."""
    if target is None:
        rep = Report()
        rep.extend(check_split_types(n=n, device=device))
        rep.extend(check_annotated_ops(n=n, device=device))
        rep.extend(check_plan_cache(plan_cache_path))
        return rep
    if not callable(target):
        raise TypeError(
            f"verify() target must be a callable pipeline, got {target!r}")
    return verify_pipeline(target, *args, device=device, **config)
