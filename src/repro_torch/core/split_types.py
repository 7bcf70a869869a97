"""Split types and the splitting API (paper §3), over torch tensors.

A *split type* is a parameterized type ``N<V0..Vn>``: two split types are
equal iff their names and parameters are equal.  Equal split types mean two
values are split the same way and corresponding pieces may be passed to a
function together (pipelined).  Annotators bridge the abstraction to code by
implementing the splitting API: ``constructor`` (function args -> params),
``split`` (value, [start,end) -> piece), ``merge`` (pieces -> value,
associative) and ``info`` (element count / element byte width).

* ``ArraySplit``    — split a tensor along one axis (NumPy/MKL analogue).
* ``ScalarSplit``   — the paper's missing type "_": broadcast, never split.
* ``ReduceSplit``   — partial results merged by an associative reduction.
* ``ConcatSplit``   — alias family for merge-by-concatenation of new outputs.
* ``UnknownSplit``  — the unique ``unknown`` type (filters etc.).
* ``GenericVar``    — an SA-local generic (``S``), resolved by unification.

``can_handoff``/``rechunk`` carry cross-stage chunk handoff
(``core/handoff.py``): which producer grids a consumer may ingest without a
merge, and how a chunk list moves onto another grid.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree


def _require_pieces(pieces: Sequence[Any], type_name: str) -> None:
    """Degenerate-merge guard: ``merge([])`` has no identity element for
    concat/fold merges, so every split type fails it with one clear error."""
    if not len(pieces):
        raise ValueError(
            f"{type_name}.merge requires at least one piece (merge of an "
            "empty chunk list has no identity element)")


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    """Relayed to Mozart by ``info`` (paper Table 1) to size batches."""

    num_elements: int      # how many splittable elements the value contains
    elem_bytes: int        # bytes occupied by ONE element (a slice)


class SplitType:
    """Base class. Identity = (name, params); paper §3.2."""

    #: human-readable type name; parameters complete the identity.
    name: str = "SplitType"

    def __init__(self, *params: Any):
        self.params = tuple(params)

    # -- type identity ----------------------------------------------------
    def key(self) -> tuple:
        return (self.name, self.params)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, SplitType) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        ps = ", ".join(repr(p) for p in self.params)
        return f"{self.name}<{ps}>"

    # -- splitting API (paper Table 1) ------------------------------------
    @property
    def splittable(self) -> bool:
        """False for broadcast-like types that are copied, not split."""
        return True

    def info(self, value: Any) -> RuntimeInfo | None:
        raise NotImplementedError

    def split(self, value: Any, start: int, end: int) -> Any:
        raise NotImplementedError

    def merge(self, pieces: Sequence[Any]) -> Any:
        raise NotImplementedError

    # -- cross-stage chunk handoff (core/handoff.py) -----------------------
    def can_handoff(self, consumer: "SplitType") -> bool:
        """True when pieces of a value split by ``self`` may be ingested
        directly by a consumer whose input split type is ``consumer``:
        corresponding chunks of the producer's grid ARE what the consumer's
        ``split`` would have produced, so the merge -> re-split round trip
        at the stage boundary can be skipped."""
        return False

    def rechunk(self, chunks: Sequence[Any],
                src_ranges: Sequence[tuple[int, int]],
                dst_ranges: Sequence[tuple[int, int]]) -> tuple[list[Any], int]:
        """Regroup a chunk list from one grid onto another.

        Converts pieces laid out on ``src_ranges`` to pieces on
        ``dst_ranges`` (both sorted, covering the same [0, n) extent) with
        ``split``/``merge`` in chunk-local coordinates: a destination chunk
        aligned with one source chunk passes through by reference, one
        inside a source chunk is a view of it (``split``), and one spanning
        several pays a copy.  Returns ``(new_chunks, bytes_copied)``: at
        most one copy of the data, where a merge + re-split pays two.
        """
        out: list[Any] = []
        copied = 0
        si = 0
        for ds, de in dst_ranges:
            parts: list[Any] = []
            while si < len(src_ranges) and src_ranges[si][1] <= ds:
                si += 1
            j = si
            aligned = j < len(src_ranges) and tuple(src_ranges[j]) == (ds, de)
            while j < len(src_ranges) and src_ranges[j][0] < de:
                ss, se = src_ranges[j]
                lo, hi = max(ds, ss), min(de, se)
                c = chunks[j]
                if lo == ss and hi == se:
                    parts.append(c)
                else:                      # partial overlap: chunk-local slice
                    parts.append(self.split(c, lo - ss, hi - ss))
                j += 1
            if aligned:
                piece = parts[0]           # exact alignment: pass through
            elif not parts:
                # Zero-element destination range (empty grids, zero-size
                # fresh pieces): an empty slice of any source chunk.
                if not chunks:
                    raise ValueError(
                        "rechunk: no source chunks to carve an empty piece "
                        "from (zero-chunk stream reached rechunk)")
                piece = self.split(chunks[0], 0, 0)
            else:
                piece = parts[0]           # inside one chunk: a view
                if len(parts) > 1:
                    piece = self.merge(parts)
                    copied += sum(nbytes_of(l) for l in pytree.tree_leaves(piece))
            out.append(piece)
        return out, copied


class ScalarSplit(SplitType):
    """The paper's "_" type: the value is copied to every pipeline."""

    name = "_"

    @property
    def splittable(self) -> bool:
        return False

    def info(self, value: Any) -> None:
        return None                      # does not constrain batch counts

    def split(self, value: Any, start: int, end: int) -> Any:
        return value                     # pointer copy in the paper

    def merge(self, pieces: Sequence[Any]) -> Any:
        _require_pieces(pieces, self.name)
        return pieces[-1]


#: canonical broadcast instance — all ScalarSplit() compare equal anyway.
BROADCAST = ScalarSplit()


def _elem_bytes_along(aval_like: Any, axis: int) -> int:
    shape = tuple(aval_like.shape)
    itemsize = aval_like.dtype.itemsize
    total = math.prod(shape) * itemsize if shape else itemsize
    n = shape[axis] if shape else 1
    return max(total // max(n, 1), 1)


class ArraySplit(SplitType):
    """Split an N-d tensor along one axis into regularly sized pieces.

    Parameters are ``(shape, axis)`` — mirroring the paper's
    ``MatrixSplit<rows, cols, axis>``; equality requires both the same
    dimensions AND the same iteration axis.
    """

    name = "ArraySplit"

    def __init__(self, shape: Sequence[int], axis: int = 0):
        shape = tuple(int(s) for s in shape)
        axis = int(axis)
        if not -len(shape) <= axis < len(shape) if shape else axis != 0:
            raise ValueError(f"axis {axis} out of bounds for shape {shape}")
        if shape:
            axis %= len(shape)
        super().__init__(shape, axis)
        self.shape = shape
        self.axis = axis

    def info(self, value: Any) -> RuntimeInfo:
        return RuntimeInfo(
            num_elements=self.shape[self.axis] if self.shape else 1,
            elem_bytes=(_elem_bytes_along(value, self.axis) if self.shape
                        else value.dtype.itemsize),
        )

    def split(self, value: Any, start: int, end: int) -> Any:
        return value.narrow(self.axis, start, end - start)

    def merge(self, pieces: Sequence[Any]) -> Any:
        _require_pieces(pieces, self.name)
        if len(pieces) == 1:
            return pieces[0]
        return torch.cat(list(pieces), dim=self.axis)

    def can_handoff(self, consumer: "SplitType") -> bool:
        # Identical geometry AND iteration axis: chunk i of the producer's
        # grid is exactly what the consumer's split(v, s, e) would yield.
        return isinstance(consumer, ArraySplit) and consumer.key() == self.key()


#: the unsigned dtypes whose order ops (``amax``/``amin``, ``maximum``/
#: ``minimum``, comparisons) and ``where`` torch has no kernel for (ROADMAP
#: C13): none on the CPU (torch 2.13) nor with CUDA (torch 2.11, CUDA 12.8,
#: on an H100), but torch 2.13's CPU ``where``
UNSIGNED_WITHOUT_ORDER = frozenset({torch.uint16, torch.uint32})


def _unordered(v: Any) -> bool:
    # a meta tensor (the cuda executor's trace) computes no values: the op
    # itself is traced, and the kernel compares unsigned words
    return (isinstance(v, torch.Tensor) and v.dtype in UNSIGNED_WITHOUT_ORDER
            and v.device.type != "meta")


def widened(op: Callable, *, where_missing: bool = False) -> Callable:
    """``op`` on uint16/uint32 tensors with values: computed on int64, which
    holds every value, and a result other than bool cast back to their
    dtype (the two operands' promoted one), which wraps modulo 2**16 or
    2**32 as jnp's unsigned arithmetic does (ROADMAP C14).  Elsewhere ``op``
    itself.  ``where_missing``: widen only where torch has no kernel for
    ``op`` at these dtypes on this device (``lacks_kernel``); the order ops
    (C13) widen always."""
    def run(*args, **kw):
        dtype = next((a.dtype for a in args if _unordered(a)), None)
        if dtype is None or (where_missing and not lacks_kernel(op, args, kw)):
            return op(*args, **kw)
        if len(args) == 2 and all(isinstance(a, torch.Tensor) for a in args):
            dtype = torch.result_type(*args)
        out = op(*[a.to(torch.int64) if _unordered(a) else a for a in args], **kw)
        return out if out.dtype == torch.bool else out.to(dtype)
    return run


#: (op, argument dtypes and devices) -> whether torch lacks the kernel
_LACKS: dict[tuple, bool] = {}


def lacks_kernel(op: Callable, args: tuple, kw: dict) -> bool:
    """Whether ``op`` raises ``NotImplementedError`` on these arguments'
    dtypes and devices (torch 2.13's CPU has no uint16/uint32 ``add``,
    ``remainder``, ``pow``, ``abs``, ``sign`` or ``neg``; torch 2.11's CUDA
    lacks ``mul`` as well): one call on one-element tensors, cached per
    signature."""
    key = (op, tuple((a.dtype, a.device.type) if isinstance(a, torch.Tensor) else type(a)
                     for a in args), tuple(sorted(kw)))
    hit = _LACKS.get(key)
    if hit is None:
        tiny = [torch.ones(1, dtype=a.dtype, device=a.device) if isinstance(a, torch.Tensor)
                else a for a in args]
        try:
            op(*tiny, **kw)
            hit = False
        except NotImplementedError:
            hit = True
        _LACKS[key] = hit
    return hit


def _wrapping(op: Callable, a: Any, b: Any) -> Any:
    """``op`` on partials; uint32 ones (unsigned sums and products) go
    through int64, as torch has few uint32 kernels, and wrap on the cast."""
    if getattr(a, "dtype", None) is torch.uint32:
        return op(a.to(torch.int64), b.to(torch.int64)).to(torch.uint32)
    return op(a, b)


class ReduceSplit(SplitType):
    """Output-only split type for reductions (paper Ex. 5).

    Pieces are partial results; ``merge`` combines them with an associative
    operator.  The ``op_name`` participates in type identity so that, e.g.,
    partial sums are never pipelined into a consumer expecting partial maxes.
    """

    name = "ReduceSplit"

    _OPS: dict[str, Callable[[Any, Any], Any]] = {
        "add": lambda a, b: _wrapping(torch.add, a, b),
        "mul": lambda a, b: _wrapping(torch.mul, a, b),
        "max": widened(torch.maximum),
        "min": widened(torch.minimum),
    }

    def __init__(self, op_name: str, extra: tuple = ()):  # extra e.g. axis
        if op_name not in self._OPS:
            raise ValueError(f"unknown reduce op {op_name!r}")
        super().__init__(op_name, tuple(extra))
        self.op_name = op_name

    @property
    def splittable(self) -> bool:
        return False                     # you cannot re-split a partial

    def info(self, value: Any) -> None:
        return None

    def split(self, value: Any, start: int, end: int) -> Any:
        raise TypeError("ReduceSplit values are partial results; merge first")

    def merge(self, pieces: Sequence[Any]) -> Any:
        _require_pieces(pieces, self.name)
        op = self._OPS[self.op_name]
        out = pieces[0]
        for p in pieces[1:]:
            out = op(out, p)
        return out


class ConcatSplit(SplitType):
    """Output-only split type whose merge is concatenation (paper Ex. 4).

    For functions that *produce* fresh data per piece: pieces are new values
    whose total element count is unknowable before the merge, so the value
    cannot be re-split — but unlike ``unknown`` the type is *shared* by
    every producer with the same ``tag``.  Identity: ``(tag, axis)``.
    """

    name = "ConcatSplit"

    def __init__(self, tag: str = "", axis: int = 0):
        super().__init__(str(tag), int(axis))
        self.tag = str(tag)
        self.axis = int(axis)

    @property
    def splittable(self) -> bool:
        return False                     # piece boundaries vanish at merge

    def info(self, value: Any) -> None:
        return None

    def split(self, value: Any, start: int, end: int) -> Any:
        raise TypeError("ConcatSplit values are fresh outputs; merge first")

    def merge(self, pieces: Sequence[Any]) -> Any:
        _require_pieces(pieces, self.name)
        if len(pieces) == 1:
            return pieces[0]
        return pytree.tree_map(
            lambda *ls: torch.cat(ls, dim=self.axis), pieces[0], *pieces[1:])

    def can_handoff(self, consumer: "SplitType") -> bool:
        # Fresh pieces merge by concatenation along ``axis``: a consumer
        # iterating the SAME axis of a concrete array grid (or, per leaf, of
        # a pytree grid) can ingest them directly.  Piece sizes are unknown
        # before execution, so this is only permission: the runtime derives
        # the grid from the buffers (``stage_exec.adapt_stream``) and merges
        # when they do not tile the consumer's geometry.
        return ((isinstance(consumer, ArraySplit) and bool(consumer.shape)
                 and consumer.axis == self.axis)
                or (isinstance(consumer, PytreeSplit)
                    and consumer.axis == self.axis))


_unknown_uid = itertools.count()


class UnknownSplit(SplitType):
    """The paper's ``unknown``: a *unique* split type per instantiation.

    Uniqueness prevents pipelining two independently-filtered values
    together, while generics may still bind to an unknown value.  Merging
    concatenates along ``axis`` (the producer's iteration axis).
    """

    name = "unknown"

    def __init__(self, axis: int = 0, _uid: int | None = None):
        uid = next(_unknown_uid) if _uid is None else _uid
        super().__init__(uid)
        self.axis = axis
        self.uid = uid

    def info(self, value: Any) -> None:
        return None                      # element count is unknowable

    def split(self, value: Any, start: int, end: int) -> Any:
        raise TypeError("unknown-typed values cannot be re-split without a merge")

    def merge(self, pieces: Sequence[Any]) -> Any:
        _require_pieces(pieces, self.name)
        if len(pieces) == 1:
            return pieces[0]
        return torch.cat(list(pieces), dim=self.axis)


class PytreeSplit(SplitType):
    """Split every tensor leaf of a pytree along ``axis`` in lockstep.

    Identity params: (treedef repr, leading size, axis).
    """

    name = "PytreeSplit"

    def __init__(self, treedef_repr: str, length: int, axis: int = 0):
        super().__init__(treedef_repr, int(length), int(axis))
        self.length = int(length)
        self.axis = int(axis)

    def info(self, value: Any) -> RuntimeInfo:
        leaves = pytree.tree_leaves(value)
        per_elem = sum(_elem_bytes_along(l, self.axis) for l in leaves)
        return RuntimeInfo(num_elements=self.length, elem_bytes=per_elem)

    def split(self, value: Any, start: int, end: int) -> Any:
        return pytree.tree_map(
            lambda l: l.narrow(self.axis, start, end - start), value)

    def merge(self, pieces: Sequence[Any]) -> Any:
        _require_pieces(pieces, self.name)
        if len(pieces) == 1:
            return pieces[0]
        return pytree.tree_map(
            lambda *ls: torch.cat(ls, dim=self.axis), pieces[0], *pieces[1:])

    def can_handoff(self, consumer: "SplitType") -> bool:
        return isinstance(consumer, PytreeSplit) and consumer.key() == self.key()


# ---------------------------------------------------------------------------
# Type variables & unification (generics + inference, paper §3.2/§5.1)
# ---------------------------------------------------------------------------


class GenericVar:
    """An SA-local generic (``S``).  Fresh per function *call*."""

    __slots__ = ("label", "uid")
    _uids = itertools.count()

    def __init__(self, label: str):
        self.label = label
        self.uid = next(GenericVar._uids)

    def __repr__(self) -> str:
        return f"?{self.label}{self.uid}"


class UnificationError(Exception):
    pass


class TypeEnv:
    """Union-find over GenericVars with concrete SplitType bindings.

    Implements the paper's "push known types along the edges of the graph"
    inference (§5.1).  Unknown split types are concrete-but-unique, so a var
    may bind to one, while two distinct unknowns never unify.
    """

    def __init__(self) -> None:
        self._parent: dict[int, GenericVar] = {}
        self._binding: dict[int, SplitType] = {}

    def _find(self, v: GenericVar) -> GenericVar:
        p = self._parent.get(v.uid)
        if p is None or p.uid == v.uid:
            return v
        root = self._find(p)
        self._parent[v.uid] = root
        return root

    def resolve(self, t: "SplitType | GenericVar") -> "SplitType | GenericVar":
        if isinstance(t, GenericVar):
            root = self._find(t)
            return self._binding.get(root.uid, root)
        return t

    def unify(self, a: "SplitType | GenericVar", b: "SplitType | GenericVar") -> None:
        a, b = self.resolve(a), self.resolve(b)
        if isinstance(a, GenericVar) and isinstance(b, GenericVar):
            if a.uid != b.uid:
                self._parent[a.uid] = b
            return
        if isinstance(a, GenericVar):
            self._binding[a.uid] = b
            return
        if isinstance(b, GenericVar):
            self._binding[b.uid] = a
            return
        if a != b:
            raise UnificationError(f"split types differ: {a} vs {b}")

    def snapshot(self) -> tuple:
        return (dict(self._parent), dict(self._binding))

    def restore(self, snap: tuple) -> None:
        self._parent, self._binding = dict(snap[0]), dict(snap[1])


# ---------------------------------------------------------------------------
# Split SPECS — what annotators write inside an SA.  A spec is the split-type
# *constructor* (paper §3.2): at call time it maps the bound function
# arguments to a concrete split type (or a generic var / broadcast).
# ---------------------------------------------------------------------------


class SplitSpec:
    def construct(self, value: Any, bound: dict[str, Any], generics: dict[str, GenericVar]):
        raise NotImplementedError


class Along(SplitSpec):
    """ArraySplit along ``axis``; the constructor reads the value's shape.

    ``axis`` may also be the *name* of a function argument (runtime value),
    mirroring the paper's ``MatrixSplit(m, axis)`` constructor.
    """

    def __init__(self, axis: int | str = 0):
        self.axis = axis

    def construct(self, value, bound, generics):
        if value is None:            # downstream of a dynamic-shape op
            return UnknownSplit()
        axis = bound[self.axis] if isinstance(self.axis, str) else self.axis
        shape = tuple(value.shape)
        if not shape:
            return BROADCAST
        return ArraySplit(shape, int(axis))


class Broadcast(SplitSpec):
    def construct(self, value, bound, generics):
        return BROADCAST


#: annotators may write ``_`` like the paper.
_ = Broadcast()


class Generic(SplitSpec):
    def __init__(self, label: str = "S"):
        self.label = label

    def construct(self, value, bound, generics):
        if self.label not in generics:
            generics[self.label] = GenericVar(self.label)
        return generics[self.label]


class Unknown(SplitSpec):
    def __init__(self, axis: int = 0):
        self.axis = axis

    def construct(self, value, bound, generics):
        return UnknownSplit(axis=self.axis)


class Reduce(SplitSpec):
    def __init__(self, op_name: str, extra: tuple = ()):
        self.op_name = op_name
        self.extra = extra

    def construct(self, value, bound, generics):
        return ReduceSplit(self.op_name, self.extra)


class Concat(SplitSpec):
    """Spec form of ``ConcatSplit`` for annotators (see class docstring)."""

    def __init__(self, tag: str = "", axis: int = 0):
        self.tag = tag
        self.axis = axis

    def construct(self, value, bound, generics):
        return ConcatSplit(self.tag, self.axis)


class Custom(SplitSpec):
    """Escape hatch: an arbitrary constructor ``(value, bound_args) -> SplitType``."""

    def __init__(self, fn: Callable[[Any, dict[str, Any]], SplitType]):
        self.fn = fn

    def construct(self, value, bound, generics):
        return self.fn(value, bound)


class Pytree(SplitSpec):
    """PytreeSplit along ``axis`` of every leaf, lockstep across leaves.

    Every leaf must carry the SAME extent along ``axis``; a value whose
    leaves disagree falls back to BROADCAST and is seen whole."""

    def __init__(self, axis: int = 0):
        self.axis = axis

    def construct(self, value, bound, generics):
        leaves, treedef = pytree.tree_flatten(value)
        if not leaves:
            return BROADCAST
        extents = set()
        for leaf in leaves:
            shape = tuple(getattr(leaf, "shape", ()))
            if len(shape) <= self.axis:
                return BROADCAST
            extents.add(int(shape[self.axis]))
        if len(extents) != 1:
            return BROADCAST
        return PytreeSplit(str(treedef), extents.pop(), self.axis)


#: per-data-type default split constructors (paper §5.1: "annotators provide
#: a default split type constructor per data type").
_DEFAULT_SPLITS: list[tuple[type, Callable[[Any], "SplitType"]]] = []


def register_default_split(cls: type, ctor: Callable[[Any], "SplitType"]) -> None:
    _DEFAULT_SPLITS.append((cls, ctor))


def default_split_type(value: Any) -> SplitType:
    """Paper §5.1 fallback: per-data-type default when inference fails."""
    for cls, ctor in _DEFAULT_SPLITS:
        if isinstance(value, cls):
            return ctor(value)
    shape = tuple(getattr(value, "shape", ()))
    if not shape:
        return BROADCAST
    return ArraySplit(shape, 0)


def _scalar_dtype(x: Any) -> torch.dtype:
    """JAX's weak-typed dtype of a Python scalar (int32/float32 with x64 off)."""
    if isinstance(x, bool):
        return torch.bool
    if isinstance(x, int):
        return torch.int32
    if isinstance(x, float):
        return torch.float32
    raise TypeError(f"no aval for {type(x).__name__}")


def aval_of(x: Any) -> torch.Tensor:
    """Shape and dtype of ``x`` as a tensor on the ``meta`` device."""
    if isinstance(x, torch.Tensor):
        return x if x.device.type == "meta" else torch.empty(
            tuple(x.shape), dtype=x.dtype, device="meta")
    return torch.empty((), dtype=_scalar_dtype(x), device="meta")


def nbytes_of(x: Any) -> int:
    aval = aval_of(x)
    return math.prod(aval.shape or (1,)) * aval.dtype.itemsize
