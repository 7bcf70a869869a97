"""Split annotations over unmodified functions (paper §3, Listing 3).

``@splittable`` attaches an SA to a function *without changing its body*:

    @splittable(x=Along(0), y=Along(0), ret=Along(0))
    def vadd(x, y): return x + y                     # the "library" fn

The decorated function behaves as follows:

* called with ``torch.fx.Proxy`` arguments (someone is symbolically tracing
  the caller, e.g. the ``cuda`` executor's lowering) or with ``meta``
  tensors (someone is abstractly evaluating the caller) — the original
  function runs directly; Mozart stays out of the way;
* called under a lazy Mozart context — the call is *registered* in the
  dataflow graph and a ``Future`` is returned (libmozart ``register()``);
* called with no lazy context — the original runs immediately, which is
  exactly "the library without Mozart" (the baseline).

Every concrete tensor argument is first narrowed as the reference's JAX
(x64 off) narrows it at the library boundary (``canonicalize``): int64 to
int32 and uint64 to uint32, wrapping modulo 2**32, float64 to float32,
complex128 to complex64; a Python int outside int32 raises
``OverflowError``.  Avals, plan fingerprints, the cost model and every
executor see the 32-bit dtypes.  The leaves of a library container (a
``Table``'s columns, a ``Corpus``'s arrays) stay as given at the boundary:
a dynamic function (``sa.dynamic``, which the reference calls raw on them)
receives them so, and every other function receives them narrowed
(``narrow_leaves``, as the reference's trace narrows them): both in
``AnnotatedFn.call_eager``, through which every executor, a call outside
a lazy context and the abstract evaluation run a function.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Sequence

import torch
import torch.fx
from torch.utils import _pytree as pytree

from repro_torch.core import split_types as st
from repro_torch.core.future import Future


class SA:
    """A split annotation: split specs per argument + return + metadata."""

    def __init__(
        self,
        arg_specs: dict[str, st.SplitSpec],
        ret_spec: st.SplitSpec,
        static: Sequence[str] = (),
        elementwise: bool = False,
        mut: Sequence[str] = (),
        cost_hint: float = 1.0,
    ):
        self.arg_specs = arg_specs
        self.ret_spec = ret_spec
        self.static = tuple(static)
        self.elementwise = elementwise      # hint: stage may lower to the kernel
        self.mut = tuple(mut)               # donation hint
        #: per-call cost relative to one elementwise op (``Stage.flops_hint``
        #: feeds it to the cost model behind ``executor="auto"``).
        self.cost_hint = cost_hint
        #: name of the data argument a SELECTIVE op filters (row-subset
        #: semantics: output rows are a subset of that argument's rows, the
        #: other arguments are selectors).  Set ad hoc by integrations, like
        #: ``dynamic``: ``compress`` ("x").  The static rewrite pass
        #: (core/rewrite.py) uses it to prove filter-before-map commutation
        #: for the MZ503 pushdown.
        self.selective: str | None = None


#: what JAX with x64 off makes of a 64-bit dtype.
CANONICAL: dict[torch.dtype, torch.dtype] = {
    torch.int64: torch.int32, torch.uint64: torch.uint32,
    torch.float64: torch.float32, torch.complex128: torch.complex64}
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def _narrow(l: Any, cache=None) -> Any:
    """A 64-bit tensor's 32-bit copy (integers wrap modulo 2**32); ``cache``
    (a ``WeakIdKeyDictionary``, or a dict that outlives none of its
    tensors) keeps one copy per tensor and version."""
    to = CANONICAL.get(l.dtype) if isinstance(l, torch.Tensor) else None
    if to is None:
        return l
    if cache is None:
        return l.to(to)
    hit = cache.get(l)
    if hit is None or hit[0] != l._version:
        hit = cache[l] = (l._version, l.to(to))
    return hit[1]


def narrow_leaves(v: Any, cache=None) -> Any:
    """``v`` with every 64-bit tensor leaf of every pytree narrowed
    (``CANONICAL``), a registered library container's leaves included:
    what a non-dynamic library function receives; ``v`` itself when no
    leaf is 64-bit."""
    if isinstance(v, torch.Tensor):
        return _narrow(v, cache)
    if v is None or isinstance(v, (bool, int, float, complex, str)):
        return v
    if not any(isinstance(l, torch.Tensor) and l.dtype in CANONICAL
               for l in pytree.tree_leaves(v)):
        return v
    return pytree.tree_map(lambda l: _narrow(l, cache), v)


def canonicalize_tensors(v: Any, cache=None) -> Any:
    """``v`` narrowed (``narrow_leaves``) if it is a tensor, list, tuple or
    dict; any other container (a ``Table``) stays as given."""
    return narrow_leaves(v, cache) if isinstance(v, (torch.Tensor, list, tuple, dict)) else v


def canonicalize(v: Any, cache=None) -> Any:
    """One argument of a library call as the reference receives it:
    64-bit tensors narrowed (``canonicalize_tensors``), and a Python int
    outside int32 refused with ``OverflowError``, as JAX's argument parsing
    refuses it (whatever its operands: x64 is off)."""
    if isinstance(v, int) and not isinstance(v, bool):
        if not _INT32_MIN <= v <= _INT32_MAX:
            raise OverflowError(f"Python int {v} does not fit int32 (the reference "
                                "runs with x64 off)")
        return v
    return canonicalize_tensors(v, cache)


def _meta_leaf(l: Any) -> Any:
    if isinstance(l, torch.Tensor):
        return st.aval_of(l)
    twin = getattr(l, "mozart_meta", None)    # containers of weights (ParamTree)
    return twin() if callable(twin) else l


def _meta(v: Any) -> Any:
    """Every tensor leaf of ``v`` as a tensor on the ``meta`` device, and
    every container with a ``mozart_meta()`` hook as its meta twin."""
    return pytree.tree_map(_meta_leaf, v)


class AnnotatedFn:
    """A library function wrapped (not modified) by its SA."""

    def __init__(self, fn: Callable, sa: SA, name: str | None = None):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.sa = sa
        self.name = name or getattr(fn, "__name__", "fn")
        self.signature = inspect.signature(fn)
        self._aval_cache: dict[tuple, Any] = {}

    # -- plain execution ----------------------------------------------------
    def call_eager(self, bound: dict[str, Any], cache=None) -> Any:
        """One black-box library call (PyTorch runs eagerly: no jit).  A
        dynamic function receives its arguments as given, as the reference
        calls it raw; any other receives them narrowed (``narrow_leaves``,
        one copy per tensor in ``cache``), as the reference's trace does."""
        if not getattr(self.sa, "dynamic", False):
            static = self.sa.static
            bound = {k: (v if k in static else narrow_leaves(v, cache))
                     for k, v in bound.items()}
        return self.fn(**bound)

    def call_raw(self, bound: dict[str, Any]) -> Any:
        """The bare library function on ``bound`` as given: no narrowing
        (the contract checker's MZ108 tests the function, not the boundary)."""
        return self.fn(**bound)

    # -- laziness -----------------------------------------------------------
    def __call__(self, *args, **kwargs):
        from repro_torch.core.runtime import current_context

        b = self.signature.bind(*args, **kwargs)
        b.apply_defaults()
        bound = dict(b.arguments)

        # Inside someone else's trace or abstract evaluation: step aside.
        if any(isinstance(v, torch.fx.Proxy)
               or (isinstance(v, torch.Tensor) and v.device.type == "meta")
               for v in bound.values()):
            return self.fn(**bound)
        ctx = current_context()
        lazy = ctx is not None and ctx.lazy
        cache = ctx._narrowed if lazy else None
        static = self.sa.static
        bound = {k: (v if k in static else canonicalize(v, cache)) for k, v in bound.items()}
        if not lazy:
            return self.call_eager(self._force_all(bound))
        return ctx.register_call(self, bound)

    @staticmethod
    def _force_all(bound: dict[str, Any]) -> dict[str, Any]:
        return {
            k: (v.value if isinstance(v, Future) else v) for k, v in bound.items()
        }

    def __repr__(self) -> str:
        return f"AnnotatedFn({self.name})"

    # -- SA machinery ---------------------------------------------------------
    def _aval_key(self, bound_avals: dict[str, Any]) -> tuple | None:
        """Hashable identity of one abstract call, or None (uncacheable).

        Statics are keyed by value; everything else by pytree structure +
        leaf shapes/dtypes only (Python scalars by type), so two calls with
        equal keys have equal output avals."""
        parts = []
        for name, v in bound_avals.items():
            if name in self.sa.static:
                try:
                    hash(v)
                except TypeError:
                    return None
                parts.append((name, "static", v))
                continue
            leaves, treedef = pytree.tree_flatten(v)
            leaf_ids = []
            for l in leaves:
                shape = getattr(l, "shape", None)
                dtype = getattr(l, "dtype", None)
                hook = getattr(l, "mozart_fingerprint", None)
                if callable(hook):
                    leaf_ids.append(("fp", hook()))
                elif shape is None or dtype is None:
                    leaf_ids.append(("py", type(l).__name__))
                else:
                    leaf_ids.append((tuple(shape), str(dtype)))
            parts.append((name, str(treedef), tuple(leaf_ids)))
        return tuple(parts)

    def abstract_eval(self, bound_avals: dict[str, Any]) -> Any:
        """Output aval: the function run (``call_eager``) on ``meta``
        tensors, statics as-is.

        Cached per aval structure: re-registering the same call shape must
        not re-pay a whole-function abstract run."""
        key = self._aval_key(bound_avals)
        if key is not None:
            hit = self._aval_cache.get(key)
            if hit is not None:
                return hit

        kw = {k: (v if k in self.sa.static else _meta(v))
              for k, v in bound_avals.items()}
        with torch.no_grad():
            out = _meta(self.call_eager(kw))
        if key is not None:
            if len(self._aval_cache) > 128:      # runaway-shape backstop
                self._aval_cache.clear()
            self._aval_cache[key] = out
        return out

    def construct_types(self, bound: dict[str, Any], avals: dict[str, Any], out_aval):
        """Run every split-type constructor for one call (paper §3.2)."""
        generics: dict[str, st.GenericVar] = {}
        ctor_args = dict(bound)          # constructors may read runtime args
        arg_types: dict[str, Any] = {}
        for name in bound:
            spec = self.sa.arg_specs.get(name, st._)
            arg_types[name] = spec.construct(avals[name], ctor_args, generics)
        out_type = self.sa.ret_spec.construct(out_aval, ctor_args, generics)
        return arg_types, out_type


def splittable(
    ret: st.SplitSpec | None = None,
    static: Sequence[str] = (),
    elementwise: bool = False,
    mut: Sequence[str] = (),
    name: str | None = None,
    **arg_specs: st.SplitSpec,
) -> Callable[[Callable], AnnotatedFn]:
    """Attach a split annotation to an unmodified function.

    ``ret`` defaults to ``Unknown()``, which is always safe (it merely
    prevents pipelining downstream).
    """
    if ret is None:
        ret = st.Unknown()

    def deco(fn: Callable) -> AnnotatedFn:
        sa = SA(dict(arg_specs), ret, static=static, elementwise=elementwise, mut=mut)
        return AnnotatedFn(fn, sa, name=name)

    return deco


def annotate(fn: Callable, *, ret: st.SplitSpec | None = None,
             static: Sequence[str] = (), elementwise: bool = False,
             name: str | None = None, **arg_specs: st.SplitSpec) -> AnnotatedFn:
    """Annotate a function you do not own (third-party annotator workflow)."""
    return splittable(ret=ret, static=static, elementwise=elementwise,
                      name=name or getattr(fn, "__name__", "fn"), **arg_specs)(fn)
