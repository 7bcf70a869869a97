"""Lazy value handles (paper §4: ``Future<T>``).

Accessing a ``Future`` — converting to numpy or a Python number, printing,
indexing, or using it with un-annotated code — forces evaluation of the
pending dataflow graph (the Python-client design of §4.2: interception via
dunder methods).

Arithmetic dunders are routed through the *annotated* torch ops registered
by ``repro_torch.core.annotated_numpy`` so that ``a + b`` on futures extends
the dataflow graph instead of forcing it.
"""

from __future__ import annotations

import operator
from typing import Any, Callable

import numpy as np
import torch

#: populated by repro_torch.core.annotated_numpy at import time:
#:   name ("add", "multiply", ...) -> annotated binary/unary callable.
_OPERATOR_TABLE: dict[str, Callable] = {}

#: plain-value fallbacks when the annotated ops are not imported.
_PLAIN = {
    "add": operator.add, "subtract": operator.sub, "multiply": operator.mul,
    "divide": operator.truediv, "power": operator.pow,
}


def register_operator(name: str, fn: Callable) -> None:
    _OPERATOR_TABLE[name] = fn


class Future:
    """Placeholder for the output of a not-yet-executed annotated call."""

    __slots__ = ("_ctx", "_node", "__weakref__")

    def __init__(self, ctx, node):
        object.__setattr__(self, "_ctx", ctx)
        object.__setattr__(self, "_node", node)

    # -- metadata available without forcing --------------------------------
    @property
    def aval(self):
        return self._node.out_aval

    @property
    def shape(self):
        return self._node.out_aval.shape

    @property
    def dtype(self):
        return self._node.out_aval.dtype

    @property
    def ndim(self):
        return len(self._node.out_aval.shape)

    @property
    def done(self) -> bool:
        return self._node.done

    @property
    def split_type(self):
        """Split type the producing call constructed for this value (may be a
        generic var until the planner resolves it)."""
        return self._node.out_type

    # -- forcing ------------------------------------------------------------
    @property
    def value(self) -> Any:
        """Evaluate the pending graph (if needed) and return the result.

        A result left unmerged by cross-stage chunk handoff (a
        ``ChunkStream``) merges here, lazily, exactly once: observation is
        the only point a handed-off output materializes."""
        if not self._node.done:
            self._ctx.evaluate()
        res = self._node.result
        from repro_torch.core.stage_exec import ChunkStream, counter_scope
        if isinstance(res, ChunkStream):
            # Observation of a pipeline output: TERMINAL bytes, attributed
            # to the owning context's counters.
            with counter_scope(getattr(self._ctx, "counters", None)):
                res = res.materialize(terminal=True)
            self._node.result = res
        return res

    def block(self) -> Any:
        return self.value

    def __array__(self, dtype=None, copy=None):
        v = self.value
        arr = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self) -> str:
        if self._node.done:
            return f"Future(done, {self._node.result!r})"
        return f"Future(pending {self._node}, aval={self._node.out_aval})"

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx):
        return self.value[idx]

    def __iter__(self):
        return iter(self.value)

    def __float__(self):
        return float(self.value)

    def __int__(self):
        return int(self.value)

    def __bool__(self):
        return bool(self.value)

    # -- lazy arithmetic ------------------------------------------------------
    def _binop(self, name: str, other, reverse=False):
        fn = _OPERATOR_TABLE.get(name)
        if fn is None:                       # annotated ops not imported
            a = self.value
            b = other.value if isinstance(other, Future) else other
            return _PLAIN[name](b, a) if reverse else _PLAIN[name](a, b)
        return fn(other, self) if reverse else fn(self, other)

    def __add__(self, o):
        return self._binop("add", o)

    def __radd__(self, o):
        return self._binop("add", o, reverse=True)

    def __sub__(self, o):
        return self._binop("subtract", o)

    def __rsub__(self, o):
        return self._binop("subtract", o, reverse=True)

    def __mul__(self, o):
        return self._binop("multiply", o)

    def __rmul__(self, o):
        return self._binop("multiply", o, reverse=True)

    def __truediv__(self, o):
        return self._binop("divide", o)

    def __rtruediv__(self, o):
        return self._binop("divide", o, reverse=True)

    def __pow__(self, o):
        return self._binop("power", o)

    def __neg__(self):
        fn = _OPERATOR_TABLE.get("negative")
        return fn(self) if fn is not None else -self.value
