"""The "NumPy / Intel MKL" integration (paper §7, Listing 2) over torch ops.

SAs over torch vector math.  Mirrors the paper's MKL integration: the
*library* functions are torch ops (hand-optimized black boxes from Mozart's
point of view), and the annotator supplies only split types.  Like the paper
we generate most SAs from a table because functions with matching
signatures share an annotation shape.

Each op keeps the JAX package's semantics where torch differs: Python
scalars beside a tensor take the tensor's (weak-typed) dtype, ``sign(nan)``
is nan, integer sums accumulate in int32 (unsigned ones in uint32), bool
arithmetic (``square``, ``power``, ``mod``) promotes to int32, ``abs`` and
``floor`` of bool stay bool, ``sign`` of bool raises ``TypeError``, and an
integer ``mod`` by zero gives 0, and uint16/uint32 arithmetic wraps
modulo 2**16 / 2**32 (computed on int64 where torch has no kernel at
those dtypes, ``split_types.widened``).  64-bit arguments arrive narrowed to 32
bits (``annotation.canonicalize``), as JAX with x64 off gives them, and a
result torch widens to 64 bits (a bool beside a Python int) is narrowed
back (``_narrow``): JAX gives int32 there.

The ``cuda`` executor's lowering (``core/cuda_exec.py``) runs these
functions on ``meta`` tensors of the stage's real dtypes, so every dtype
branch below resolves as it does on real inputs and the kernel program
computes what the function computes at that dtype.

Usage:
    from repro_torch.core import annotated_numpy as anp
    with mozart.session(executor="cuda") as ctx:
        d1 = anp.log1p(x); d2 = anp.add(d1, y); ...
        result = d2.value
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import split_types as st
from repro_torch.core.annotation import CANONICAL, AnnotatedFn, annotate
from repro_torch.core.future import register_operator

__all_ops__: dict[str, AnnotatedFn] = {}

_SCALARS = (bool, int, float)


def _reg(name: str, fn: AnnotatedFn) -> AnnotatedFn:
    __all_ops__[name] = fn
    globals()[name] = fn
    return fn


def _tensor_operands(x, y):
    """A Python scalar beside a tensor becomes a 0-d tensor of the weak-typed
    result dtype, for the torch ops that take tensors only (``maximum``,
    ``atan2``, ``logical_and``, a scalar left of a comparison, ...)."""
    if isinstance(y, _SCALARS) and isinstance(x, torch.Tensor):
        y = torch.full((), y, dtype=torch.result_type(x, y), device=x.device)
    elif isinstance(x, _SCALARS) and isinstance(y, torch.Tensor):
        x = torch.full((), x, dtype=torch.result_type(y, x), device=y.device)
    return x, y


def _narrow(t):
    """A result torch computed in 64 bits, at JAX's 32 (x64 off)."""
    to = CANONICAL.get(t.dtype) if isinstance(t, torch.Tensor) else None
    return t if to is None else t.to(to)


def _tensors_only(f: Callable) -> Callable:
    def op(x, y):
        return f(*_tensor_operands(x, y))
    return op


def _is_bool(v) -> bool:
    return v.dtype is torch.bool if isinstance(v, torch.Tensor) else isinstance(v, bool)


def _bools_to_int32(x, y):
    """jnp promotes bool with bool (or with a weak-typed Python int) to
    int32 in arithmetic; torch refuses or picks int64."""
    if (_is_bool(x) and (_is_bool(y) or isinstance(y, int))) or \
            (_is_bool(y) and isinstance(x, int)):
        x, y = (v.to(torch.int32) if isinstance(v, torch.Tensor) and v.dtype is torch.bool
                else v for v in (x, y))
    return x, y


_INTS = (torch.uint8, torch.uint16, torch.uint32, torch.int8, torch.int16,
         torch.int32, torch.int64)


def _sign(x):
    if x.dtype is torch.bool:
        raise TypeError("sign is not defined for bool operands (as jnp.sign)")
    # torch.sign(nan) is 0; the library contract (jnp.sign) keeps nan.
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _abs(x):
    return x if x.dtype is torch.bool else torch.abs(x)


def _floor(x):
    return x if x.dtype is torch.bool else torch.floor(x)


def _square(x):
    return torch.square(x.to(torch.int32) if x.dtype is torch.bool else x)


def _power(x, y):
    return torch.pow(*_bools_to_int32(x, y))


def _mod(x, y):
    x, y = _tensor_operands(*_bools_to_int32(x, y))
    if not any(x.dtype is d for d in _INTS):
        return torch.remainder(x, y)            # a float zero divisor gives nan
    # Integers: jnp.mod gives 0 for a zero divisor; never divide by zero.
    zero = y == 0
    return torch.where(zero, 0, torch.remainder(x, torch.where(zero, 1, y)))


# -- unary elementwise:  (S) -> S  ------------------------------------------
def _unsigned(f: Callable) -> Callable:
    """``f`` on uint16/uint32 through int64 where torch has no kernel for it
    at that dtype and device, wrapping on the cast back (ROADMAP C14)."""
    return st.widened(f, where_missing=True)


_UNARY = {
    "exp": torch.exp, "log": torch.log, "log1p": torch.log1p, "sqrt": torch.sqrt,
    "erf": torch.special.erf, "negative": _unsigned(torch.negative),
    "abs": _unsigned(_abs), "sin": torch.sin, "cos": torch.cos, "tanh": torch.tanh,
    "sign": _unsigned(_sign), "arcsin": torch.arcsin, "arccos": torch.arccos,
    "expm1": torch.expm1, "square": _unsigned(_square), "reciprocal": torch.reciprocal,
    "floor": _floor,
    "isnan": torch.isnan, "logical_not": torch.logical_not,
}

for _name, _fn in _UNARY.items():
    def _mk(f):
        def op(x):
            return f(x)
        return op
    _reg(_name, annotate(_mk(_fn), name=_name, elementwise=True,
                         x=st.Generic("S"), ret=st.Generic("S")))


# -- binary elementwise:  (S, S) -> S  (scalar operands broadcast) ----------
_BINARY = {
    "add": _unsigned(torch.add), "subtract": _unsigned(torch.subtract),
    "multiply": _unsigned(torch.multiply), "divide": torch.divide,
    "power": _unsigned(_power),
    "maximum": _tensors_only(st.widened(torch.maximum)),
    "minimum": _tensors_only(st.widened(torch.minimum)),
    "greater": _tensors_only(st.widened(torch.greater)),
    "less": _tensors_only(st.widened(torch.less)),
    "equal": _tensors_only(torch.eq),
    "logical_and": _tensors_only(torch.logical_and),
    "logical_or": _tensors_only(torch.logical_or),
    "atan2": _tensors_only(torch.atan2), "mod": _unsigned(_mod),
}


class _BinarySpec(st.SplitSpec):
    """Generic S for array operands, broadcast for scalar operands."""

    def construct(self, value, bound, generics):
        # ``value is None`` = upstream dynamic-shape output: still an array.
        if value is not None and not getattr(value, "shape", ()):
            return st.BROADCAST
        if "S" not in generics:
            generics["S"] = st.GenericVar("S")
        return generics["S"]


for _name, _fn in _BINARY.items():
    def _mkb(f):
        def op(x, y):
            return _narrow(f(x, y))
        return op
    _reg(_name, annotate(_mkb(_fn), name=_name, elementwise=True,
                         x=_BinarySpec(), y=_BinarySpec(), ret=st.Generic("S")))


# -- ternary ------------------------------------------------------------------
_where_op = st.widened(torch.where)


def _where(c, x, y):
    cond = c != 0                       # any dtype: nonzero selects x
    if isinstance(cond, bool):          # Python scalar condition
        cond = torch.tensor(cond)
    return _narrow(_where_op(cond, x, y))


_reg("where", annotate(_where, name="where", elementwise=True,
                       c=_BinarySpec(), x=_BinarySpec(), y=_BinarySpec(),
                       ret=st.Generic("S")))


# -- reductions: (ArraySplit over axis) -> ReduceSplit --------------------------
# One split type per reduction merge op, exactly like the paper's NumPy
# integration ("we implemented split types for each reduction operator ...
# these only required merge functions").
_SMALL_INTS = (torch.bool, torch.int8, torch.int16, torch.int32)
_SMALL_UINTS = (torch.uint8, torch.uint16, torch.uint32)


def _int_reduction(red: Callable) -> Callable:
    """jnp's accumulators: int32 for bool and small signed ints, uint32 for
    unsigned ones.  Torch has no uint32 sum or product, so those
    accumulate in int64 and wrap modulo 2**32 on the cast, as JAX's do."""
    def op(x, **kw):
        if x.dtype in _SMALL_UINTS:
            return red(x, dtype=torch.int64, **kw).to(torch.uint32)
        return red(x, dtype=torch.int32 if x.dtype in _SMALL_INTS else None, **kw)
    return op


_sum, _prod = _int_reduction(torch.sum), _int_reduction(torch.prod)


def _make_reduction(name: str, red: Callable, merge_op: str):
    def op(x):
        return red(x)
    return _reg(name, annotate(op, name=name, x=st.Generic("S"),
                               ret=st.Reduce(merge_op)))


_make_reduction("sum", _sum, "add")
_make_reduction("max", st.widened(torch.amax), "max")
_make_reduction("min", st.widened(torch.amin), "min")
_make_reduction("prod", _prod, "mul")


def _sum_axis(x, axis):
    return _sum(x, dim=axis)


class _AxisReduceRet(st.SplitSpec):
    """sum(m, axis): reducing the split axis yields partials (ReduceSplit);
    reducing another axis keeps the row split (ArraySplit over axis 0)."""

    def construct(self, value, bound, generics):
        axis = bound["axis"]
        if axis == 0:
            return st.ReduceSplit("add")
        return st.ArraySplit(tuple(value.shape), 0)


_reg("sum_axis", annotate(_sum_axis, name="sum_axis", static=("axis",),
                          x=st.Along(0), ret=_AxisReduceRet()))


# -- shape-changing ops: unknown split types (paper Ex. 4) --------------------
def _compress(mask, x):
    # Dynamic output shape: Mozart runs it call by call per chunk.
    return x[mask.to(torch.bool)]


_compress_ann = annotate(_compress, name="compress",
                         mask=st.Generic("S"), x=st.Generic("S"), ret=st.Unknown())
_compress_ann.sa.dynamic = True
_compress_ann.sa.selective = "x"     # row subset of x: pushdown-eligible
_reg("compress", _compress_ann)


# -- matrix ops (MKL L2 BLAS analogue) ----------------------------------------
def _matvec(m, v):
    return m @ v


_reg("matvec", annotate(_matvec, name="matvec",
                        m=st.Along(0), v=st._, ret=st.Along(0)))


def _matmul(a, b):
    return a @ b


# A @ B splits by rows of A; B is broadcast (the paper's matrix-panel split).
_reg("matmul", annotate(_matmul, name="matmul",
                        a=st.Along(0), b=st._, ret=st.Along(0)))


# -- axis-parameterized normalize (paper §3.1 example) -------------------------
def _normalize_axis(m, axis):
    mean = torch.mean(m, dim=axis, keepdim=True)
    sd = torch.std(m, dim=axis, keepdim=True, correction=0) + 1e-9
    return (m - mean) / sd


class _MatrixSplitCtor(st.SplitSpec):
    """MatrixSplit(m, axis): split along the axis NOT being normalized."""

    def construct(self, value, bound, generics):
        axis = int(bound["axis"])
        split_axis = 1 - axis           # normalizing rows => split rows apart
        return st.ArraySplit(tuple(value.shape), split_axis)


_reg("normalize_axis", annotate(
    _normalize_axis, name="normalize_axis", static=("axis",),
    m=_MatrixSplitCtor(), ret=_MatrixSplitCtor()))


# -- operator table for Future dunders ---------------------------------------
for _op in ("add", "subtract", "multiply", "divide", "power", "negative"):
    register_operator(_op, __all_ops__[_op])


def __probe_examples__(n: int = 12, device: torch.device | str = "cuda") -> dict[str, Any]:
    """Tiny concrete inputs per op for the annotation contract checker
    (``core/analysis.py``): every value is chosen inside the op's domain
    (arcsin/log need (0,1)) so the MZ108 whole-vs-merged comparison tests
    the SA, not numerical edge cases.  Values may be a kwargs dict or a
    list of them (one check per variant)."""
    def lin(a: float, b: float, k: int) -> torch.Tensor:
        return torch.linspace(a, b, k, dtype=torch.float32, device=device)

    x, y = lin(0.1, 0.9, n), lin(0.2, 1.1, n)
    m = (torch.arange(n * 4, dtype=torch.float32, device=device).reshape(n, 4) + 1.0) / (n * 4)
    ex: dict[str, Any] = {name: {"x": x} for name in _UNARY}
    ex.update({name: {"x": x, "y": y} for name in _BINARY})
    ex["where"] = {"c": x > 0.5, "x": x, "y": y}
    ex.update({name: {"x": x} for name in ("sum", "max", "min", "prod")})
    ex["sum_axis"] = [{"x": m, "axis": 0}, {"x": m, "axis": 1}]
    ex["compress"] = {"mask": x > 0.4, "x": x}
    ex["matvec"] = {"m": m, "v": lin(0.1, 1.0, 4)}
    ex["matmul"] = {"a": m, "b": lin(0.1, 1.2, 12).reshape(4, 3)}
    ex["normalize_axis"] = [{"m": m, "axis": 0}, {"m": m, "axis": 1}]
    return ex
