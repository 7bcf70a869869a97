"""The "Pandas" integration (paper §7): a columnar Table + SAs, over torch.

The counterpart of ``src/repro/core/annotated_table.py``.  The Table
library itself is deliberately plain (a dict of equal-length columns, torch
kernels on the columns' device); it stands in for Pandas' C internals.  The
annotator's contribution is ONLY the split types and SAs:

* ``TableSplit``  — split a Table by rows (the paper's DataFrame/Series
  row split).  Column extraction yields ordinary tensors, whose ArraySplit
  pipelines with the NumPy integration inside one stage.
* ``GroupSplit``  — groupBy partials: chunks aggregate locally, the merge
  re-groups and re-aggregates (commutative aggregations only, like the
  paper).
* filters and joins return ``unknown``; joins split one side and broadcast
  the other.

Dtypes follow the reference's.  ``filter_rows``, ``groupby_agg`` and
``join_inner`` are dynamic: they receive a Table's columns as given, so a
float64/int64 table keeps its widths through them, and ``groupby_agg``
gives int64 counts and float64 sums, means and extrema beside keys of the
key column's dtype.  Every other op receives the columns narrowed to 32
bits, as the reference's trace narrows them (``annotation.narrow_leaves``,
applied where the executors call a non-dynamic function).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import split_types as st
from repro_torch.core.annotation import annotate, canonicalize_tensors


# ---------------------------------------------------------------------------
# The "library": a minimal columnar table
# ---------------------------------------------------------------------------


class Table:
    """Dict of equal-length columns.  Registered as a torch pytree."""

    def __init__(self, cols: dict[str, Any]):
        self.cols = dict(cols)

    @property
    def nrows(self) -> int:
        for v in self.cols.values():
            return int(v.shape[0])
        return 0

    def column(self, name: str):
        return self.cols[name]

    def __repr__(self) -> str:
        return f"Table({list(self.cols)}, nrows={self.nrows})"

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.cols.items()}

    def mozart_fingerprint(self) -> tuple:
        """Plan-cache identity: column names + shapes/dtypes, never values."""
        return ("table", tuple(
            (k, tuple(v.shape), str(v.dtype)) for k, v in sorted(self.cols.items())
        ))


def _table_flatten(t: Table):
    keys = sorted(t.cols)
    return [t.cols[k] for k in keys], tuple(keys)


def _table_unflatten(vals, keys):
    return Table(dict(zip(keys, vals)))


pytree.register_pytree_node(Table, _table_flatten, _table_unflatten,
                            serialized_type_name=f"{__name__}.Table")


# ---------------------------------------------------------------------------
# Split types
# ---------------------------------------------------------------------------


class TableSplit(st.SplitType):
    """Split a Table by rows.  Params: (nrows,)."""

    name = "TableSplit"

    def __init__(self, nrows: int):
        super().__init__(int(nrows))
        self.nrows = int(nrows)

    def info(self, value: Table) -> st.RuntimeInfo:
        eb = sum(v.dtype.itemsize for v in value.cols.values())
        return st.RuntimeInfo(num_elements=self.nrows, elem_bytes=max(eb, 1))

    def split(self, value: Table, start: int, end: int) -> Table:
        return Table({k: v[start:end] for k, v in value.cols.items()})

    def merge(self, pieces: Sequence[Table]) -> Table:
        """Rows concatenated, at 32 bits (the reference's
        ``jnp.concatenate``)."""
        st._require_pieces(pieces, self.name)
        if len(pieces) == 1:
            return pieces[0]
        keys = pieces[0].cols.keys()
        return Table({k: canonicalize_tensors(torch.cat([p.cols[k] for p in pieces]))
                      for k in keys})


#: flips the 63 low bits of a negative float64's bit pattern, so that the
#: patterns, read as int64, sort as the floats do (``_unique_keys``).
_LOW_BITS = 0x7FFFFFFFFFFFFFFF


def _unique_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted unique keys and each row's group index, every NaN key in one
    group sorted last, as the reference's ``np.unique`` (``equal_nan``)
    groups them: ``torch.unique`` gives each NaN a group of its own.  A
    floating key is grouped by its float64 bit pattern in the integer order
    of the floats, after -0.0 is made 0.0 and every NaN the one positive
    quiet NaN, which sorts after +inf."""
    if not keys.is_floating_point():
        return torch.unique(keys, sorted=True, return_inverse=True)
    k = keys.double()
    k = torch.where(k == 0, 0.0, k).masked_fill(torch.isnan(k), math.nan)
    bits = k.view(torch.int64)
    order, inv = torch.unique(bits ^ ((bits >> 63) & _LOW_BITS), sorted=True,
                              return_inverse=True)
    bits = order ^ ((order >> 63) & _LOW_BITS)
    return bits.view(torch.float64).to(keys.dtype), inv


def _resum(col: torch.Tensor, inv: torch.Tensor, n: int) -> torch.Tensor:
    """Float64 sums of ``col`` per group index ``inv``."""
    out = torch.zeros(n, dtype=torch.float64, device=col.device)
    return out.index_add_(0, inv, col.to(torch.float64))


def _extremum(col: torch.Tensor, inv: torch.Tensor, n: int, op: str) -> torch.Tensor:
    """Float64 ``max``/``min`` of ``col`` per group index, from ∓inf."""
    out = torch.full((n,), -np.inf if op == "max" else np.inf, dtype=torch.float64,
                     device=col.device)
    return out.scatter_reduce_(0, inv, col.to(torch.float64),
                               reduce="amax" if op == "max" else "amin")


class GroupSplit(st.SplitType):
    """Partial group-aggregations; merge re-groups and re-aggregates.

    Params: (op, key column, value column) — partial sums from different
    aggregations never pipeline into each other.
    """

    name = "GroupSplit"

    def __init__(self, op: str, key: str, val: str):
        super().__init__(op, key, val)
        # NOT ``self.key``/``self.val``: those would shadow SplitType.key().
        self.op, self.key_col, self.val_col = op, key, val

    @property
    def splittable(self) -> bool:
        return False

    def info(self, value: Any) -> None:
        return None

    def split(self, value, start, end):
        raise TypeError("GroupSplit values are partials; merge first")

    def merge(self, pieces: Sequence[Table]) -> Table:
        st._require_pieces(pieces, self.name)
        cat = {k: torch.cat([p.cols[k] for p in pieces]) for k in pieces[0].cols}
        # Re-aggregate the partials.  Partial columns already hold partial
        # sums/counts/extrema, so the second-level reduction is sum for
        # sum/count/mean and the op itself for max/min (associativity).
        uniq, inv = _unique_keys(cat[self.key_col])
        n = uniq.numel()
        if self.op == "sum":
            return Table({self.key_col: uniq, "sum": _resum(cat["sum"], inv, n)})
        if self.op == "count":
            return Table({self.key_col: uniq,
                          "count": _resum(cat["count"], inv, n).to(torch.int64)})
        if self.op == "mean":
            return Table({self.key_col: uniq, "mean": _resum(cat["mean"], inv, n),
                          "_cnt": _resum(cat["_cnt"], inv, n)})
        return Table({self.key_col: uniq,
                      self.op: _extremum(cat[self.op], inv, n, self.op)})


class TableUnknown(st.UnknownSplit):
    """unknown for Tables: merge concatenates rows of every column."""

    name = "unknown"

    def merge(self, pieces: Sequence[Table]) -> Table:
        st._require_pieces(pieces, self.name)
        if len(pieces) == 1:
            return pieces[0]
        keys = pieces[0].cols.keys()
        return Table({k: torch.cat([p.cols[k] for p in pieces]) for k in keys})


st.register_default_split(Table, lambda t: TableSplit(t.nrows))


class TableRows(st.SplitSpec):
    def construct(self, value, bound, generics):
        if value is None:
            # downstream of a dynamic op: fresh unknown
            return TableUnknown()
        nrows = value.nrows if isinstance(value, Table) else _tree_nrows(value)
        return TableSplit(nrows)


class TableUnknownSpec(st.SplitSpec):
    def construct(self, value, bound, generics):
        return TableUnknown()


def _tree_nrows(aval_tree) -> int:
    return int(pytree.tree_leaves(aval_tree)[0].shape[0])


# ---------------------------------------------------------------------------
# Aggregation kernels (torch on the columns' device; the "C internals")
# ---------------------------------------------------------------------------


def _group_reduce(t: Table, key: str, valcol: str, op: str) -> Table:
    """Group ``valcol`` by ``key``: keys sorted and unique (the key
    column's dtype, every NaN key one group, last), float64
    sums/means/extrema, int64 counts; ``mean`` carries (sum in ``mean``,
    float64 count in ``_cnt``), resolved by ``finalize_mean``."""
    uniq, inv = _unique_keys(t.cols[key])
    n = uniq.numel()
    if op in ("sum", "mean", "count"):
        cnts = torch.zeros(n, dtype=torch.int64, device=inv.device)
        cnts.index_add_(0, inv, torch.ones_like(inv))
        if op == "count":
            return Table({key: uniq, "count": cnts})
        sums = _resum(t.cols[valcol], inv, n)
        if op == "sum":
            return Table({key: uniq, "sum": sums})
        return Table({key: uniq, "mean": sums, "_cnt": cnts.to(torch.float64)})
    return Table({key: uniq, op: _extremum(t.cols[valcol], inv, n, op)})


# ---------------------------------------------------------------------------
# Annotated operators (the SAs)
# ---------------------------------------------------------------------------

__all_ops__: dict[str, Any] = {}


def _reg(name, fn):
    __all_ops__[name] = fn
    globals()[name] = fn
    return fn


def _col(t: Table, name: str):
    return t.column(name)


_reg("col", annotate(_col, name="col", static=("name",),
                     t=st.Generic("S"), ret=st.Along(0)))


def _sorted(cols: dict) -> Table:
    """A non-dynamic op's Table, columns in name order: the reference's
    trace returns its Table through the pytree, whose leaves are sorted."""
    return Table(dict(sorted(cols.items())))


def _with_column(t: Table, name: str, values):
    cols = dict(t.cols)
    cols[name] = values
    return _sorted(cols)


class _SameTableSplit(st.SplitSpec):
    """with_column keeps the row split of its input table."""

    def construct(self, value, bound, generics):
        if "S" not in generics:
            generics["S"] = st.GenericVar("S")
        return generics["S"]


_reg("with_column", annotate(
    _with_column, name="with_column", static=("name",),
    t=_SameTableSplit(), values=st.Along(0), ret=_SameTableSplit()))


def _select(t: Table, names: tuple):
    return _sorted({n: t.cols[n] for n in names})


_reg("select", annotate(_select, name="select", static=("names",),
                        t=st.Generic("S"), ret=st.Generic("S")))


def _filter_rows(t: Table, mask):
    rows = torch.nonzero(mask.to(torch.bool)).squeeze(1)   # one sync for every column
    return Table({k: v[rows] for k, v in t.cols.items()})


# NOTE: mask uses its own generic M — a Series mask and a Table split by rows
# advance in lockstep (same element counts) but carry different split types.
_filter = annotate(_filter_rows, name="filter_rows",
                   t=st.Generic("S"), mask=st.Generic("M"), ret=TableUnknownSpec())
_filter.sa.dynamic = True
_filter.sa.selective = "t"           # row-subset of t: pushdown-eligible
_reg("filter_rows", _filter)


def _group_reduce_partial(t: Table, key: str, val: str, op: str) -> Table:
    """Per-chunk partial.  mean -> (sum in 'mean', count in '_cnt')."""
    return _group_reduce(t, key, val, op)


class _GroupRet(st.SplitSpec):
    def construct(self, value, bound, generics):
        return GroupSplit(bound["op"], bound["key"], bound["val"])


_gb = annotate(_group_reduce_partial, name="groupby_agg", static=("key", "val", "op"),
               t=st.Generic("S"), ret=_GroupRet())
_gb.sa.dynamic = True
_reg("groupby_agg", _gb)


def finalize_mean(t: Table, key: str) -> Table:
    """Resolve mean partials (sum, count) into the final mean column."""
    return Table({key: t.cols[key],
                  "mean": t.cols["mean"] / torch.clamp(t.cols["_cnt"], min=1)})


def _join_inner(left: Table, right: Table, on: str):
    """Inner join; splits LEFT, broadcasts RIGHT (right keys unique)."""
    lk, rk = left.cols[on], right.cols[on]
    dt = torch.promote_types(lk.dtype, rk.dtype)
    order = torch.argsort(rk, stable=True)
    rk_sorted = rk[order].to(dt)
    lk = lk.to(dt)
    pos = torch.clamp(torch.searchsorted(rk_sorted, lk), 0, rk_sorted.numel() - 1)
    hit = rk_sorted[pos] == lk
    rows = torch.nonzero(hit).squeeze(1)
    ridx = order[pos[rows]]
    out = {k: v[rows] for k, v in left.cols.items()}
    for k, v in right.cols.items():
        if k != on:
            out[f"{k}_r" if k in out else k] = v[ridx]
    return Table(out)


_join = annotate(_join_inner, name="join_inner", static=("on",),
                 left=st.Generic("S"), right=st._, ret=TableUnknownSpec())
_join.sa.dynamic = True
_reg("join_inner", _join)


def __probe_examples__(n: int = 12, device: torch.device | str = "cuda") -> dict[str, Any]:
    """Tiny concrete inputs per op for the annotation contract checker."""
    t = Table({"k": torch.arange(n, dtype=torch.int32, device=device) % 3,
               "v": torch.linspace(0.5, 2.0, n, dtype=torch.float32, device=device)})
    right = Table({"k": torch.tensor([0, 1, 2], dtype=torch.int32, device=device),
                   "w": torch.tensor([1.0, 2.0, 3.0], dtype=torch.float32, device=device)})
    return {
        "col": {"t": t, "name": "v"},
        "with_column": {"t": t, "name": "v2",
                        "values": torch.linspace(1.0, 3.0, n, dtype=torch.float32,
                                                 device=device)},
        "select": {"t": t, "names": ("k",)},
        "filter_rows": {"t": t, "mask": torch.arange(n, device=device) % 2 == 0},
        "groupby_agg": [{"t": t, "key": "k", "val": "v", "op": op}
                        for op in ("sum", "count", "mean", "max", "min")],
        "join_inner": {"left": t, "right": right, "on": "k"},
    }
