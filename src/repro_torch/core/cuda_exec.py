"""Lower a planned Mozart stage onto the split-pipeline CUDA kernel.

The counterpart of ``src/repro/core/pallas_exec.py``.  Eligibility (checked,
with a counted fallback to the fused executor):
  * every node is annotated ``elementwise=True``, or is a whole-array
    reduction whose output type is ``ReduceSplit`` (sum/max/min/prod);
  * every splittable stage input is a 1-D ``ArraySplit`` along axis 0;
  * broadcast inputs are scalars ();
  * reductions are only consumed outside the stage (they produce partials);
  * the lowering below succeeds: every value has one of the kernel's dtypes
    (bool, int8/16/32, uint8/16/32, float16, bfloat16, float32; complex and
    64-bit values stay off the kernel) and every traced operation has an
    opcode.

The Pallas kernel called each library function on a VMEM tile.  A CUDA
kernel cannot call Python, so each elementwise node's raw library function
(``node.fn.fn``, unmodified) is traced and the stage's chain becomes a
straight-line typed ``Program``: opcode, destination slot, source operands,
and the dtype each instruction computes in and gives.

The trace runs the function once on ``meta`` tensors of the stage's
concrete dtypes under a ``TorchFunctionMode`` that records every torch call,
so the library's own dtype branches resolve as they do on real inputs and
every result's dtype is the one torch's eager call gives.  A Python scalar
broadcast input enters as a number that remembers its position (and
refuses Python arithmetic), so the program passes it at run time and never
bakes it in; a Python bool is baked in (the trace is keyed by its value).
Where an operand's dtype is not the one its instruction computes in, the
lowering inserts a ``CAST`` (a scalar is converted on the host instead).  A
source is a split input, a broadcast scalar (passed at run time), an
immediate constant of the function body, or an earlier result: the previous
instruction's result, kept in registers, when nothing else reads it, else a
slot allocated by liveness (``program.assemble``).  A reduction node reduces
its *pre-reduction* operand with its ``ReduceSplit`` op, which comes from
the split type, not from the function body, into the node's own dtype
(int32 for a sum of int16 or bool, uint32 for a sum of uint8).

Traces are cached per function and per signature of dtypes (``_traced``),
and a stage's program is pinned per escaping set and input dtypes, so a
program lowered for float32 inputs never runs on int32 inputs of the same
shape.
"""

from __future__ import annotations

import numbers
import weakref
from typing import Any

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.core import split_types as st
from repro_torch.core.graph import NodeRef
from repro_torch.core.planner import Stage, _value_key
from repro_torch.core.stage_exec import (
    SAMPLE_CHUNKS,
    ChunkStream,
    StageExecutor,
    batch_ranges,
    candidate_batches,
    donatable_input_keys,
    effective_elements,
    get_executor,
    mark_stream_consumed,
    note_trace,
    pinned_exec,
    regrid_stream,
    register_executor,
    stage_num_elements,
    undonatable_stream_keys,
)
from repro_torch.kernels import program as P
from repro_torch.kernels import split_pipeline as sp
from repro_torch.kernels.program import BOOL_RESULT, FLOAT_ONLY, OP, Program, assemble
from repro_torch.kernels.split_pipeline import fits_kernel

#: torch call names -> opcode: functions (``torch.add``), tensor methods
#: (``x.add``) and operators (``x + y`` records ``add`` or ``__add__``).
_OPS: dict[str, str] = {
    "exp": "EXP", "log": "LOG", "log1p": "LOG1P", "sqrt": "SQRT", "erf": "ERF",
    "special_erf": "ERF", "neg": "NEG", "negative": "NEG", "abs": "ABS",
    "absolute": "ABS", "sin": "SIN", "cos": "COS", "tanh": "TANH", "sign": "SIGN",
    "asin": "ASIN", "arcsin": "ASIN", "acos": "ACOS", "arccos": "ACOS",
    "expm1": "EXPM1", "square": "SQUARE", "reciprocal": "RECIP", "floor": "FLOOR",
    "isnan": "ISNAN", "logical_not": "NOT", "add": "ADD", "sub": "SUB",
    "subtract": "SUB", "mul": "MUL", "multiply": "MUL", "div": "DIV",
    "divide": "DIV", "true_divide": "DIV", "truediv": "DIV", "pow": "POW",
    "maximum": "MAX", "minimum": "MIN", "gt": "GT", "greater": "GT", "lt": "LT",
    "less": "LT", "ge": "GE", "greater_equal": "GE", "le": "LE",
    "less_equal": "LE", "eq": "EQ", "ne": "NE", "not_equal": "NE",
    "logical_and": "AND", "logical_or": "OR", "atan2": "ATAN2", "arctan2": "ATAN2",
    "remainder": "MOD", "mod": "MOD", "where": "WHERE", "clone": "COPY",
    "pos": "COPY", "and": "AND", "or": "OR", "invert": "NOT",
}
#: reflected operators and ``rsub``: the operands come swapped.
_SWAPPED = {"rsub": "SUB", "radd": "ADD", "rmul": "MUL", "rtruediv": "DIV",
            "rdiv": "DIV", "rpow": "POW", "rmod": "MOD", "rand": "AND", "ror": "OR"}
#: operators that are logical only on bools (``~x``, ``x & y``, ``x | y``).
_BOOL_ONLY = {"invert", "and", "or", "rand", "ror"}
#: dtype conversions; the target is the result's dtype.
_CASTS = {"to", "type", "float", "half", "bfloat16", "int", "short", "char", "byte",
          "bool", "double", "long"}
#: constructors of a constant tensor from a number (a scalar source).
_CONSTS = {"full", "tensor"}

_KERNEL_DTYPES = P.DTYPES
_NARROW = {torch.int64: torch.int32, torch.uint64: torch.uint32,
           torch.float64: torch.float32}


class LoweringError(Exception):
    """The stage cannot become a kernel program (the reason says why)."""


def _scalar_use(*_args, **_kwargs):
    raise LoweringError("a broadcast scalar is used in Python arithmetic, "
                        "not in a torch call")


class _FloatArg(float):
    """A Python float broadcast input while a function is traced: behaves
    as the number in torch calls and remembers its parameter; Python
    arithmetic on it refuses the lowering (it would bake the value in)."""

    def __new__(cls, value: float, name: str):
        obj = super().__new__(cls, value)
        obj.param = name
        return obj

    __hash__ = float.__hash__


class _IntArg(int):
    """``_FloatArg`` for a Python int broadcast input."""

    def __new__(cls, value: int, name: str):
        obj = super().__new__(cls, value)
        obj.param = name
        return obj

    __hash__ = int.__hash__


for _dunder in ("add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
                "floordiv", "rfloordiv", "mod", "rmod", "pow", "rpow", "neg", "pos",
                "abs", "eq", "ne", "lt", "le", "gt", "ge", "bool", "float", "int",
                "round", "trunc", "floor", "ceil", "and", "rand", "or", "ror", "xor",
                "rxor", "invert", "lshift", "rshift", "divmod", "rdivmod"):
    for _cls in (_FloatArg, _IntArg):
        setattr(_cls, f"__{_dunder}__", _scalar_use)


def _code(dtype: torch.dtype) -> int:
    """The kernel's code of ``dtype``; a 64-bit dtype, which torch gives a
    bool beside a Python int, computes at JAX's 32 bits (x64 off)."""
    code = P.CODE.get(_NARROW.get(dtype, dtype))
    if code is None:
        raise LoweringError(f"dtype {dtype} is not one the kernel takes")
    return code


def _same_word(src: int, dst: int) -> bool:
    """A word of dtype ``src`` already holds the value a cast to ``dst``
    gives (no ``CAST`` needed): widening within a class, bool to a float
    dtype, unsigned to a wider signed integer, and any integer to a 32-bit
    one (the word wraps as the cast does)."""
    if src == dst:
        return True
    cs, cd = P.CLASS[src], P.CLASS[dst]
    if dst == P.BOOL:
        return False
    if cd == P.FLOAT:
        return src == P.BOOL or (cs == P.FLOAT and dst == P.F32)
    if src == P.BOOL or cs == P.FLOAT:
        return False
    if P.BITS[dst] == 32:
        return True
    if cs == cd:
        return P.BITS[src] <= P.BITS[dst]
    return cs == P.UNSIGNED and P.BITS[src] < P.BITS[dst]


# -- tracing -----------------------------------------------------------------
#
# A trace is a *recipe*: steps ``(opcode name, operands, operand dtype,
# result dtype)`` whose operands are ``(ref, required dtype)``.  A ref names
# a parameter ``("p", name)``, a constant ``("k", value)``, an earlier step
# ``("t", j)``, or a scalar ref at another dtype ``("as", ref, code)``.


class _Recorder(TorchFunctionMode):
    def __init__(self, params: dict[str, Any]):
        super().__init__()
        self.steps: list[tuple] = []
        self.refs: dict[int, tuple] = {}        # id(meta tensor) -> (ref, scalar)
        self.keep: list[Any] = []               # keeps recorded tensors alive
        for name, v in params.items():
            if isinstance(v, torch.Tensor):
                self.refs[id(v)] = (("p", name), v.dim() == 0)
                self.keep.append(v)

    def operand(self, a: Any) -> tuple[tuple, torch.dtype | None, bool]:
        """``(ref, dtype, scalar)``: dtype None for a weak Python number."""
        if isinstance(a, torch.Tensor):
            hit = self.refs.get(id(a))
            if hit is None:
                raise LoweringError("a tensor the trace did not make or receive")
            return hit[0], a.dtype, hit[1]
        if isinstance(a, (_FloatArg, _IntArg)):
            return ("p", a.param), None, True
        if isinstance(a, numbers.Number) and not isinstance(a, complex):
            return ("k", a), None, True
        raise LoweringError(f"operand {a!r} is not a tensor or a number")

    def result(self, out: torch.Tensor, ref: tuple, scalar: bool) -> torch.Tensor:
        self.refs[id(out)] = (ref, scalar)
        self.keep.append(out)
        return out

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(out, torch.Tensor):
            return out                   # dtype, device, result_type, ...
        name = getattr(func, "__name__", "")
        if name.startswith("__") and name.endswith("__"):
            name = name[2:-2]
        for a in args:                   # an operation returning its operand
            if out is a:
                return out
        if name in _CONSTS:
            value = kwargs.get("fill_value", args[1] if name == "full" else args[0])
            ref, _dt, _scalar = self.operand(value)
            return self.result(out, ("as", ref, _code(out.dtype)), True)
        if name in _CASTS:
            ref, dt, scalar = self.operand(args[0])
            dst = _code(out.dtype)
            if scalar:
                return self.result(out, ("as", ref, dst), True)
            if _code(dt) == dst:             # a 64-bit value narrowed back
                return self.result(out, ref, False)
            return self.result(out, self.step("CAST", [(ref, _code(dt))], _code(dt), dst),
                               False)
        swapped = name in _SWAPPED
        op = _SWAPPED.get(name) or _OPS.get(name)
        if op is None:
            raise LoweringError(f"no opcode for {name or func!r}")
        if kwargs:
            raise LoweringError(f"{name} called with keyword arguments {sorted(kwargs)}")
        if len(args) != P.ARITY[op]:
            raise LoweringError(f"{name} with {len(args)} arguments (opcode {op} "
                                f"takes {P.ARITY[op]})")
        if name in _BOOL_ONLY and out.dtype != torch.bool:
            raise LoweringError(f"bitwise {name} on {out.dtype}")
        ins = [self.operand(a) for a in (args[::-1] if swapped else args)]
        r = _code(out.dtype)
        if op in ("GT", "LT", "GE", "LE", "EQ", "NE"):
            c = _code(torch.result_type(*args))
        elif op in ("NOT", "AND", "OR"):
            c = P.BOOL
        elif op == "ISNAN":
            c = _code(ins[0][1])
        else:
            c = r
        need = [c] * len(ins)
        if op == "WHERE":
            need[0] = P.BOOL
        if op in FLOAT_ONLY and P.CLASS[c] != P.FLOAT:
            raise LoweringError(f"{op} computing in {P.DTYPES[c]}")
        if op == "ADD" and c == P.BOOL:
            op = "OR"                    # torch: bool + bool is logical or
        return self.result(out, self.step(op, [(ref, n) for (ref, _d, _s), n in zip(ins, need)],
                                          c, r), False)

    def step(self, op: str, operands: list, c: int, r: int) -> tuple:
        self.steps.append((op, tuple(operands), c, r))
        return ("t", len(self.steps) - 1)


# Traced recipes per raw library function and per signature of its
# arguments (dtypes, shapes, Python scalar types, static values), as
# ``AnnotatedFn._aval_cache`` caches avals: a failed trace is cached as its
# LoweringError.
_traced: "weakref.WeakKeyDictionary[Any, dict]" = weakref.WeakKeyDictionary()


def _signature(args: dict[str, Any], static: tuple) -> tuple | None:
    sig = []
    for name, v in args.items():
        if name in static:
            try:
                hash(v)
            except TypeError:
                return None
            sig.append((name, "static", type(v).__name__, v))
        elif isinstance(v, torch.Tensor):
            sig.append((name, "tensor", v.dtype, tuple(v.shape)))
        elif isinstance(v, bool):
            sig.append((name, "bool", v))
        else:
            sig.append((name, type(v).__name__))
    return tuple(sig)


def traced_recipe(fn, args: dict[str, Any], static: tuple = ()) -> tuple[list, tuple]:
    """``(steps, result ref)`` of ``fn`` called with ``args``: meta tensors
    for tensor arguments, numbers for broadcast scalars and statics."""
    sig = _signature(args, static)
    per_fn = _traced.get(fn)
    if per_fn is None:
        per_fn = _traced[fn] = {}
    hit = per_fn.get(sig) if sig is not None else None
    if hit is None:
        note_trace()
        hit = _trace(fn, args, static)
        if sig is not None:
            per_fn[sig] = hit
    if isinstance(hit, LoweringError):
        raise hit
    return hit


def _trace(fn, args: dict[str, Any], static: tuple):
    call = {}
    for name, v in args.items():
        if name in static or isinstance(v, bool):
            call[name] = v
        elif isinstance(v, torch.Tensor):            # one tensor per parameter
            call[name] = torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
        elif isinstance(v, numbers.Integral):
            call[name] = _IntArg(v, name)
        elif isinstance(v, numbers.Real):
            call[name] = _FloatArg(v, name)
        else:
            call[name] = v
    rec = _Recorder({k: v for k, v in call.items() if k not in static})
    try:
        with rec, torch.no_grad():
            out = fn(**call)
        if not isinstance(out, torch.Tensor):
            raise LoweringError(f"returns {type(out).__name__}")
        ref, _dt, _scalar = rec.operand(out)
        return list(rec.steps), (ref, _code(out.dtype))
    except LoweringError as e:
        return LoweringError(f"{getattr(fn, '__name__', fn)}: {e}")
    except Exception as e:  # noqa: BLE001 — any untraceable body is ineligible
        return LoweringError(f"{getattr(fn, '__name__', fn)} does not trace: "
                             f"{type(e).__name__}: {e}")


class _Builder:
    """Typed SSA instructions over virtual registers; sources are ``("in",
    i)``, ``("sc", i)`` (broadcast i, immediate ``n_bcast + j``, or a copy of
    a broadcast at another dtype after the immediates) or ``("v", reg)``.
    Tracks every source's dtype code (a broadcast scalar's is set by its
    first use), whether it is a bool and whether it varies along the split
    axis."""

    def __init__(self, n_bcast: int):
        self.n_bcast = n_bcast
        self.instrs: list[tuple[str, int, tuple, tuple[int, int]]] = []
        self.imms: list[float] = []
        self.copies: list[int] = []
        self._copy_of: dict[tuple[int, int], tuple] = {}
        self.dtype: dict[tuple, int | None] = {}
        self.is_bool: dict[tuple, bool] = {}
        self.is_vec: dict[tuple, bool] = {}

    def imm(self, value: Any, code: int | None = None) -> tuple:
        if not isinstance(value, numbers.Real):
            raise LoweringError(f"constant {value!r} is not a number")
        src = ("sc", self.n_bcast + len(self.imms))
        self.imms.append(value if isinstance(value, (bool, int)) else float(value))
        self.is_bool[src] = isinstance(value, bool)
        self.is_vec[src] = False
        self.dtype[src] = code
        return src

    def at(self, src: tuple, code: int) -> tuple:
        """``src`` as a value of dtype ``code``: a scalar converted on the
        host (the broadcast's first use sets its dtype; a later use at
        another dtype takes a copy slot), any other value through a
        ``CAST`` unless its word already holds the result."""
        cur = self.dtype.get(src)
        if src[0] == "sc":
            if cur is None:
                self.dtype[src] = code
                self.is_bool[src] = code == P.BOOL
                return src
            if cur == code:
                return src
            i = src[1]
            if i >= self.n_bcast:                 # an immediate: another one
                return self.imm(self.imms[i - self.n_bcast], code)
            if i < 0:                             # a copy: back to its broadcast
                i = self.copies[-i - 1]
            key = (i, code)
            if key not in self._copy_of:
                self.copies.append(i)
                dst = ("sc", -len(self.copies))   # renumbered in ``scalars``
                self.dtype[dst], self.is_bool[dst], self.is_vec[dst] = code, code == P.BOOL, False
                self._copy_of[key] = dst
            return self._copy_of[key]
        if cur == code or _same_word(cur, code):
            return src
        return self.emit("CAST", (src,), (cur, code))

    def emit(self, name: str, srcs: tuple, types: tuple[int, int] | None = None) -> tuple:
        if name == "MOD" and any(self.is_bool.get(s) for s in srcs):
            # jnp.mod promotes bool to int32; a float MOD of bools would
            # store NaN (x mod False) as True.
            raise LoweringError("MOD of a bool operand")
        if types is None:
            types = (P.F32, P.BOOL if name in BOOL_RESULT else P.F32)
        dst = ("v", len(self.instrs))
        self.instrs.append((name, dst[1], srcs, types))
        self.is_vec[dst] = any(self.is_vec[s] for s in srcs)
        self.dtype[dst] = types[1]
        self.is_bool[dst] = types[1] == P.BOOL
        return dst

    def scalars(self) -> tuple[list, tuple[int, ...]]:
        """The immediates and, after them, the copy slots, with every
        scalar's dtype (float32 where nothing used it)."""
        slots = [("sc", i) for i in range(self.n_bcast + len(self.imms))]
        slots += [("sc", -(k + 1)) for k in range(len(self.copies))]
        codes = tuple(P.F32 if self.dtype.get(s) is None else self.dtype[s] for s in slots)
        return self.imms, codes

    def renumber(self, src: tuple) -> tuple:
        if src[0] == "sc" and src[1] < 0:
            return ("sc", self.n_bcast + len(self.imms) - src[1] - 1)
        return src


def _meta_of(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
    return v


def _lower_node(b: _Builder, node, env: dict[tuple, tuple], metas: dict[tuple, Any],
                stage: Stage) -> tuple:
    """Append one elementwise node's traced body; returns its result source."""
    static = node.fn.sa.static
    args, keys = {}, {}
    for name, v in node.bound.items():
        if name in static:
            args[name] = v
            continue
        keys[name] = stage.ckey(_value_key(v))
        args[name] = metas[keys[name]]
    steps, (res, res_code) = traced_recipe(node.fn.fn, args, static)
    if res_code != P.CODE.get(node.out_aval.dtype):
        raise LoweringError(f"{node.fn.name} traced to {P.DTYPES[res_code]}, its aval "
                            f"is {node.out_aval.dtype}")
    vals: list[tuple] = []

    def resolve(ref: tuple) -> tuple:
        kind = ref[0]
        if kind == "p":
            if ref[1] in static:
                return b.imm(args[ref[1]])
            return env[keys[ref[1]]]
        if kind == "k":
            return b.imm(ref[1])
        if kind == "t":
            return vals[ref[1]]
        return b.at(resolve(ref[1]), ref[2])

    for op, operands, c, r in steps:
        srcs = tuple(b.at(resolve(ref), need) for ref, need in operands)
        vals.append(b.emit(op, srcs, (c, r)))
    return resolve(res)


def _live_code(b: _Builder, out_srcs: list[tuple]) -> tuple[list, list, list]:
    """Dead-code-eliminate; returns the kept instructions, their dtypes and
    the outputs over SSA sources (``("v", j)`` is kept instruction j), for
    ``program.assemble``."""
    live = {s for s in out_srcs if s[0] == "v"}
    keep = []
    for name, reg, srcs, types in reversed(b.instrs):
        if ("v", reg) in live:
            keep.append((name, reg, srcs, types))
            live.update(s for s in srcs if s[0] == "v")
    keep.reverse()
    pos = {reg: j for j, (_name, reg, _srcs, _t) in enumerate(keep)}

    def src(s: tuple) -> tuple:
        return ("v", pos[s[1]]) if s[0] == "v" else b.renumber(s)

    code = [(OP[name], [src(s) for s in srcs]) for name, _reg, srcs, _t in keep]
    return code, [t for *_x, t in keep], [src(s) for s in out_srcs]


def input_signature(stage: Stage, concrete: dict[tuple, Any]) -> tuple:
    """The stage inputs' dtypes (a Python scalar's type; a bool's value,
    which a program bakes in): what a pinned program is lowered for."""
    sig = []
    for k in stage.inputs:
        v = concrete[k]
        if isinstance(v, (torch.Tensor, ChunkStream)):
            sig.append(v.dtype)
        elif isinstance(v, bool):
            sig.append(("bool", v))
        else:
            sig.append(type(v).__name__)
    return tuple(sig)


def lower_stage(stage: Stage, concrete: dict[tuple, Any], ctx) -> tuple[Program, list]:
    """The stage as a kernel ``Program`` plus its ``out_kinds``; raises
    ``LoweringError``.  The result (or the error) is pinned into the plan
    entry by stage position, the positions of the outputs that escape this
    call and the inputs' dtypes (``pinned_exec``), so a warm call of a
    cached plan runs no trace and no lowering, and a program is never
    replayed on inputs of other dtypes; an uncacheable plan keeps it on the
    Stage."""

    def build():
        note_trace()
        try:
            return _lower(stage, concrete)
        except LoweringError as e:
            return e

    result = pinned_exec(stage, ctx, "cuda", (tuple(stage.escape_positions()),
                                              input_signature(stage, concrete)), build)
    if isinstance(result, LoweringError):
        raise result
    return result


def _lower(stage: Stage, concrete: dict[tuple, Any]) -> tuple[Program, list]:
    split_keys = [k for k, si in stage.inputs.items() if si.split_type.splittable]
    bcast_keys = [k for k, si in stage.inputs.items() if not si.split_type.splittable]
    b = _Builder(len(bcast_keys))
    env: dict[tuple, tuple] = {}
    metas: dict[tuple, Any] = {}
    in_dtypes = []
    for i, k in enumerate(split_keys):
        dtype = concrete[k].dtype
        if dtype not in _KERNEL_DTYPES:
            raise LoweringError(f"split input {i} has dtype {dtype}")
        env[stage.ckey(k)] = src = ("in", i)
        in_dtypes.append(P.CODE[dtype])
        b.dtype[src], b.is_bool[src], b.is_vec[src] = P.CODE[dtype], dtype == torch.bool, True
        # at the stage's shape, as the nodes' avals: a sampled run (the
        # tuner, ``auto``) passes a slice
        metas[stage.ckey(k)] = torch.empty(tuple(stage.inputs[k].split_type.shape),
                                           dtype=dtype, device="meta")
    for i, k in enumerate(bcast_keys):
        v = concrete[k]
        env[stage.ckey(k)] = src = ("sc", i)
        b.dtype[src] = None
        b.is_bool[src] = isinstance(v, bool) or getattr(v, "dtype", None) == torch.bool
        b.is_vec[src] = False
        metas[stage.ckey(k)] = _meta_of(v)

    reduce_src: dict[int, tuple] = {}
    for node in stage.nodes:
        aval = node.out_aval
        if isinstance(stage.out_types[node.id], st.ReduceSplit):
            if aval.dtype not in _KERNEL_DTYPES:
                raise LoweringError(f"{node.fn.name} reduces to {aval.dtype}")
            # The kernel applies the masked reduction itself: it needs the
            # PRE-reduction operand (the first non-static argument), as a
            # value of the reduction's dtype's class.
            first = next(v for name, v in node.bound.items()
                         if name not in node.fn.sa.static)
            src = env[stage.ckey(_value_key(first))]
            acc = P.CODE[aval.dtype]
            if P.CLASS[b.dtype[src]] != P.CLASS[acc] or (b.dtype[src] == P.BOOL) != (acc == P.BOOL):
                src = b.at(src, acc)
            reduce_src[node.id] = src
            continue
        if aval.dtype not in _KERNEL_DTYPES:
            raise LoweringError(f"{node.fn.name} yields {aval.dtype}")
        env[stage.out_key(node)] = _lower_node(b, node, env, metas, stage)
        metas[stage.out_key(node)] = torch.empty(tuple(aval.shape), dtype=aval.dtype,
                                                 device="meta")

    out_kinds, out_srcs, out_bool, out_dtypes = [], [], [], []
    for nid in sorted(stage.escaping):
        node = next(nd for nd in stage.nodes if nd.id == nid)
        if nid in reduce_src:
            t = stage.out_types[nid]
            out_kinds.append(("reduce", t.op_name))
            src = reduce_src[nid]
        else:
            out_kinds.append(("concat", ""))
            src = env[stage.out_key(node)]
            if len(node.out_aval.shape) != 1:
                raise LoweringError(f"{node.fn.name} output of shape "
                                    f"{tuple(node.out_aval.shape)}")
        if not b.is_vec[src]:
            raise LoweringError(f"{node.fn.name}: output does not vary along "
                                "the split axis")
        out_srcs.append(src)
        out_dtypes.append(P.CODE[node.out_aval.dtype])
        out_bool.append(node.out_aval.dtype == torch.bool
                        and out_kinds[-1][0] == "concat")

    code, types, outs = _live_code(b, out_srcs)
    imms, scalar_dtypes = b.scalars()
    program = assemble(code, list(zip(outs, out_bool)), n_split=len(split_keys),
                       n_bcast=len(bcast_keys), imms=imms, types=types,
                       in_dtypes=in_dtypes, scalar_dtypes=scalar_dtypes,
                       bcast_copies=b.copies, out_dtypes=out_dtypes)
    why = fits_kernel(program)
    if why is not None:
        raise LoweringError(why)
    return program, out_kinds


def _eligible(stage: Stage, concrete: dict[tuple, Any]) -> bool:
    for node in stage.nodes:
        t = stage.out_types[node.id]
        if node.fn.sa.elementwise:
            continue
        if isinstance(t, st.ReduceSplit):
            continue
        return False
    for key, si in stage.inputs.items():
        v = concrete[key]
        if si.split_type.splittable:
            if not isinstance(si.split_type, st.ArraySplit):
                return False
            if si.split_type.axis != 0 or len(si.split_type.shape) != 1:
                return False
        else:
            if tuple(getattr(v, "shape", ())) not in ((), (1,)):
                return False
    # reductions must not feed later nodes inside this stage
    for node in stage.nodes:
        if isinstance(stage.out_types[node.id], st.ReduceSplit):
            for other in stage.nodes:
                for v in other.bound.values():
                    if isinstance(v, NodeRef) and v.node_id == node.id:
                        return False
    return True


def _adjacent_views(chunks: list, n: int) -> torch.Tensor | None:
    """The chunks as ONE length-``n`` view when they are 1-D contiguous
    views of one storage laid end to end (the first chunk's base pointer
    spans them all), else None."""
    c0 = chunks[0]
    if not all(isinstance(c, torch.Tensor) and c.dim() == 1 and c.is_contiguous()
               and c.dtype == c0.dtype and c.device == c0.device for c in chunks):
        return None
    storage, ptr, item = c0.untyped_storage().data_ptr(), c0.data_ptr(), c0.element_size()
    for c in chunks:
        if c.untyped_storage().data_ptr() != storage or c.data_ptr() != ptr:
            return None
        ptr += c.numel() * item
    if sum(c.numel() for c in chunks) != n:
        return None
    return c0.as_strided((n,), (1,), c0.storage_offset())


def _launch_buffer(stage: Stage, concrete: dict[tuple, Any], key: tuple, n: int,
                   ctx) -> tuple[torch.Tensor, bool]:
    """Split input ``key`` as a contiguous length-``n`` launch buffer; returns
    ``(buffer, fresh)``, ``fresh`` when the buffer was assembled here.

    A ``ChunkStream`` is never merged (the counterpart of the reference's
    ``pallas_exec._to_launch_layout``); its path is counted in ``ctx.stats``:
    ``cuda_ingest_views`` (adjacent views of one storage: the first chunk's
    base pointer, zero copies), ``cuda_ingest_carry`` (a scan carry with no
    tail, as it is), ``cuda_ingest_carry_tail`` (a carry with a tail,
    concatenated once) and ``cuda_ingest_concat`` (any other chunk list,
    concatenated once; a grid other than this stage's batch grid goes
    through ``SplitType.rechunk`` first, counted in ``handoff_rechunks``)."""
    v = concrete[key]
    if not isinstance(v, ChunkStream):
        buf = v.narrow(0, 0, n)
        return (buf, False) if buf.is_contiguous() else (buf.contiguous(), True)
    if (v.stacked is not None and v._chunks is None
            and isinstance(v.stacked, torch.Tensor) and v.stacked.dim() == 2
            and v.stacked.is_contiguous()):
        main = v.stacked.reshape(-1)
        if v.tail is None:
            ctx.stats["cuda_ingest_carry"] += 1
            return main, False
        ctx.stats["cuda_ingest_carry_tail"] += 1
        return torch.cat([main, v.tail]), True
    chunks = v.chunks
    view = _adjacent_views(chunks, n)
    if view is not None:
        ctx.stats["cuda_ingest_views"] += 1
        return view, False
    grid = batch_ranges(n, get_executor("cuda").chunk_batch(stage, concrete, ctx, n))
    if v.ranges != grid:
        chunks = regrid_stream(stage, ctx, key, v, grid).chunks
    ctx.stats["cuda_ingest_concat"] += 1
    return torch.cat(chunks), True


def _prepare(stage: Stage, concrete: dict[tuple, Any], ctx):
    """``((program, split_inputs, bcast_inputs, out_kinds), fresh)`` for one
    stage, or None when the stage does not go to the kernel; ``fresh[i]``
    says split input i was assembled here."""
    if not _eligible(stage, concrete):
        return None
    split_keys = [k for k, si in stage.inputs.items() if si.split_type.splittable]
    bcast_keys = [k for k, si in stage.inputs.items() if not si.split_type.splittable]
    if not split_keys:
        return None
    n = effective_elements(ctx, stage_num_elements(stage, concrete, ctx.pedantic))
    if n == 0:
        return None                    # empty split: no grid to launch
    try:
        program, out_kinds = lower_stage(stage, concrete, ctx)
    except LoweringError as e:
        if ctx.log:
            print(f"[mozart] stage {stage.id} stays off the kernel: {e}")
        return None
    bufs = [_launch_buffer(stage, concrete, k, n, ctx) for k in split_keys]
    bcasts = [concrete[k] for k in bcast_keys]
    return (program, [b for b, _f in bufs], bcasts, out_kinds), [f for _b, f in bufs]


def prepare_launch(stage: Stage, concrete: dict[tuple, Any], ctx):
    """``(program, split_inputs, bcast_inputs, out_kinds)`` for one stage,
    or None when the stage does not go to the kernel."""
    prepared = _prepare(stage, concrete, ctx)
    return None if prepared is None else prepared[0]


def tiles_up_to(batch: int) -> tuple[int, ...]:
    """The kernel's tiles a chunk of ``batch`` elements may launch with:
    every tile not above it (the smallest tile when every tile is)."""
    return tuple(t for t in sp.TILES if t <= batch) or (min(sp.TILES),)


def _device_index(dev: torch.device) -> int | None:
    """The card's index for its occupancy calculator; None (the estimate)
    for a CPU tensor."""
    return dev.index if dev.type == "cuda" else None


def try_execute_stage_cuda(stage: Stage, concrete: dict[tuple, Any], ctx,
                           executor: "CudaExecutor | None" = None) -> bool:
    prepared = _prepare(stage, concrete, ctx)
    if prepared is None:
        return False
    (program, split_inputs, bcasts, out_kinds), fresh = prepared
    executor = executor or get_executor("cuda")
    geom = executor.launch_geometry(stage, ctx, program, out_kinds, split_inputs[0].device)
    # Donation decisions as the reference's pallas driver takes them: every
    # donation point counts; a dead stream passed through as it is (views,
    # a carry) gives up its buffers after the launch.
    split_keys = [k for k, si in stage.inputs.items() if si.split_type.splittable]
    donate = set(donatable_input_keys(stage, ctx))
    positions = [i for i, k in enumerate(split_keys) if stage.ckey(k) in donate]
    unsafe = undonatable_stream_keys(stage, concrete, ctx, tuple(donate)) if positions else set()
    consumed = {stage.ckey(split_keys[i]) for i in positions
                if not fresh[i] and stage.ckey(split_keys[i]) not in unsafe
                and isinstance(concrete[split_keys[i]], ChunkStream)}
    ctx.stats["donated_chunks"] += len(positions)
    results = sp._launch(program, split_inputs, bcasts, out_kinds, geom=geom)
    mark_stream_consumed(stage, concrete, ctx, consumed)
    for nid, res in zip(sorted(stage.escaping), results):
        node = next(nd for nd in stage.nodes if nd.id == nid)
        node.result = res
    for node in stage.nodes:
        node.done = True
    ctx.stats["cuda_stages"] += 1
    return True


#: least elements one timed sample of a kernel stage covers: a launch
#: covers the whole stage, so its host cost is fixed, and a sample must be
#: large enough for the device time to show through it.
SAMPLE_MIN_ELEMS = 1 << 24


@register_executor("cuda")
class CudaExecutor(StageExecutor):
    """Lower eligible elementwise stages onto the split-pipeline CUDA kernel;
    a stage that ``_eligible`` or the lowering rejects runs on the fused
    driver and is counted in ``ctx.stats["cuda_fallback_stages"]``.  A build
    or launch failure raises.  Stream inputs are ingested without a merge
    (``_launch_buffer``); outputs are whole tensors, as the reference's
    ``pallas`` stage merges its own.

    Tuning (the counterpart of ``pallas``'s block-shape tuning): the
    candidates are the §5.2 bracket rounded to the tiles the kernel
    launches, deduplicated; the winner is pinned as the stage's batch, and
    every launch of a cached plan records the tile it used in
    ``PlanEntry.block_shape[stage.id] = (1, tile)``."""

    tunable = True
    stream_capable = True

    def execute(self, stage: Stage, concrete: dict[tuple, Any], ctx) -> None:
        if not try_execute_stage_cuda(stage, concrete, ctx, self):
            ctx.stats["cuda_fallback_stages"] += 1
            get_executor("fused").execute(stage, concrete, ctx)

    def chunk_batch(self, stage: Stage, concrete: dict[tuple, Any], ctx, n: int) -> int:
        """The chunk grid a stream is regridded onto before it is
        concatenated into a launch buffer: the context's ``batch_elements``
        or the §5.2 estimate, never the pinned tile."""
        return max(1, min(ctx.batch_elements or self.estimate_batch(stage, concrete, ctx, n), n))

    def launch_geometry(self, stage: Stage, ctx, program: Program, out_kinds: list,
                        device: torch.device) -> "sp.Geometry":
        """The tile and ring depth of this launch: the kernel's rule over the
        tiles a chunk of the tuner's candidate (or of the size it pinned) may
        hold, else over every tile.  A launch of a cached plan records its
        tile in ``entry.block_shape``."""
        entry = getattr(ctx, "_plan_entry", None)
        override = getattr(ctx, "_batch_override", None)
        cap = override
        if cap is None and entry is not None:
            cap = entry.tuned_batch.get(stage.id)
        tiles = sp.TILES if cap is None else tiles_up_to(cap)
        geom = sp.program_geometry(program, out_kinds, _device_index(device), tiles)
        if entry is not None and override is None:
            entry.pin_block_shape(stage.id, (1, geom.tile))
        return geom

    def tuning_candidates(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                          est: int, n: int) -> list[int]:
        """The §5.2 bracket rounded to the tile each candidate launches with
        (the rule over the tiles a chunk of that size may hold) and
        deduplicated: two candidates on one tile would time the same launch
        twice.  A stage that stays off the kernel tunes the fused driver's
        bracket."""
        split = [concrete[k] for k, si in stage.inputs.items() if si.split_type.splittable]
        if n <= 0 or not split or not _eligible(stage, concrete):
            return candidate_batches(est, n)
        try:
            program, out_kinds = lower_stage(stage, concrete, ctx)
        except LoweringError:
            return candidate_batches(est, n)
        device = _device_index(ctx.device)         # split inputs may be streams
        return sorted({sp.program_geometry(program, out_kinds, device, tiles_up_to(c)).tile
                       for c in candidate_batches(est, n)})

    def sample_elems(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                     batch: int, n: int) -> int:
        """One launch covers the whole sample, so the sample is at least
        ``SAMPLE_MIN_ELEMS`` elements and ``SAMPLE_CHUNKS`` of the stage's
        §5.2 chunks, however small the tile being timed."""
        chunk = max(batch, self.chunk_batch(stage, concrete, ctx, max(n, 1)))
        return min(n, max(SAMPLE_CHUNKS * chunk, SAMPLE_MIN_ELEMS)) if n > 0 else 0
