"""The Table integration (``repro_torch.core.annotated_table``) against the
JAX package's, on the CPU.

Every case runs the same numpy-seeded tables through the reference's
annotated Table library and the port's, on every port executor (``eager``,
``pipelined``, ``fused``, ``scan``, and ``cuda`` on CPU tensors, where a
stage the split-pipeline kernel cannot take runs on ``fused``) against the
reference's executor of the same name (``pallas`` for ``cuda``) and its
``eager``.  Held exactly: the plan (the op names of every stage), the
``ctx.stats`` counters ``stages``, ``chunks``, ``calls``,
``rewrites_applied`` and ``rewrites_declined``, the rewrite records (code,
kind, subject), result dtypes (float32 ``col``; int64 keys with float64
sums, means and extrema from ``groupby_agg`` over fig4's int64/float64
columns) and every integer value.  ``cuda_fallback_stages`` equals the
stage count: the reference's ``pallas`` lowering refuses every stage that
holds a Table op, and so does the port's ``cuda`` executor.  Float values:
float32 rtol 2e-5 with atol 1e-6 * max|reference| (sums in another order),
float64 rtol 1e-9.

Also ported: ``tests/test_integrations.py::TestTable`` (Hypothesis cases as
the reference draws them), the table surface of
``tests/test_differential.py``, fig4's DataFrame workloads and the plan
file's deferred ``TableSplit`` entry (``tests/test_plan_persist.py``'s
unresolved-class case, across processes).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.testing import given, hst, settings  # hypothesis-optional

from benchmarks import workloads as jw
from repro.core import annotated_numpy as janp
from repro.core import annotated_table as jtb
from repro.core import mozart as jm
from repro_torch import workloads as tw
from repro_torch.core import annotated_numpy as tanp
from repro_torch.core import annotated_table as ttb
from repro_torch.core import mozart as tm
from repro_torch.core import plan_cache as tplan_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: port executor -> the reference's executor it is held against.
PAIRS = {"eager": "eager", "pipelined": "pipelined", "fused": "fused",
         "scan": "scan", "cuda": "pallas"}
EXECUTORS = list(PAIRS)
JAX_CFG = dict(plan_cache=False, autotune=False)
PORT_CFG = dict(plan_cache=False, autotune=False, device="cpu")
STATS = ("stages", "chunks", "calls", "rewrites_applied", "rewrites_declined")


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    tplan_cache.clear()
    yield


# ---------------------------------------------------------------------------
# the differential harness (the image and nlp tests use it too)
# ---------------------------------------------------------------------------


def to_np(v):
    """A result as numpy: a Table or Corpus as a dict of its arrays."""
    if isinstance(v, (ttb.Table, jtb.Table)):
        return {k: to_np(c) for k, c in v.cols.items()}
    if hasattr(v, "tokens") and hasattr(v, "lengths"):
        return {"tokens": to_np(v.tokens), "lengths": to_np(v.lengths)}
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


def _run(mozart, fn, args, executor, batch, **cfg):
    with mozart.session(executor=executor, batch_elements=batch, **cfg) as ctx:
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        plan = [[n.fn.name for n in s.nodes] for s in ctx.last_plan()]
        vals = [to_np(o.value) for o in outs]
    return vals, plan, ctx


def same_values(got, want, what=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (what, list(got), list(want))
        for k in want:
            same_values(got[k], want[k], f"{what}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype.kind == "f":
        rtol = 1e-9 if want.dtype == np.float64 else 2e-5
        scale = float(np.nanmax(np.abs(want))) if want.size and not np.isnan(want).all() else 0.0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _records(ctx):
    return [(r.code, r.kind, r.subject) for r in ctx._last_rewrites]


def check_pair(tfn, targs, jfn, jargs, executor, batch):
    """The port's ``executor`` against the reference's counterpart and its
    ``eager``: plan, counters, rewrite records, values and dtypes; returns
    the port's values and context."""
    jv, jplan, jctx = _run(jm, jfn, jargs, PAIRS[executor], batch, **JAX_CFG)
    tv, tplan, tctx = _run(tm, tfn, targs, executor, batch, **PORT_CFG)
    assert tplan == jplan
    assert {k: tctx.stats.get(k, 0) for k in STATS} == \
        {k: jctx.stats.get(k, 0) for k in STATS}
    assert _records(tctx) == _records(jctx)
    if executor == "cuda":
        assert jctx.stats.get("pallas_stages", 0) == 0
        assert tctx.stats.get("cuda_fallback_stages", 0) == tctx.stats["stages"]
        assert tctx.stats.get("cuda_stages", 0) == 0
    for i, (g, w) in enumerate(zip(tv, jv)):
        same_values(g, w, f"{executor} output {i}")
    if PAIRS[executor] != "eager":
        je, _, _ = _run(jm, jfn, jargs, "eager", batch, **JAX_CFG)
        for i, (g, w) in enumerate(zip(tv, je)):
            same_values(g, w, f"{executor} output {i} vs eager")
    return tv, tctx


def _tables(cols: dict):
    """The same numpy columns as a port Table (CPU) and a reference Table."""
    return (ttb.Table({k: torch.from_numpy(np.array(v)) for k, v in cols.items()}),
            jtb.Table(dict(cols)))


def make_cols(n=100, seed=0):
    """``tests/test_integrations.py``'s table: fig4-style int64/float64."""
    r = np.random.RandomState(seed)
    return {"city": r.randint(0, 7, n).astype(np.int64),
            "pop": r.randint(1, 1000, n).astype(np.float64),
            "crime": r.rand(n).astype(np.float64) * 10}


# ---------------------------------------------------------------------------
# tests/test_integrations.py::TestTable
# ---------------------------------------------------------------------------


def _index_sum(tb, anp):
    def pipe(t):
        idx = anp.divide(anp.multiply(tb.col(t, "crime"), 100.0), tb.col(t, "pop"))
        return anp.sum(idx)
    return pipe


@pytest.mark.parametrize("executor", EXECUTORS)
def test_col_then_vector_math_pipelines(executor):
    t, jt = _tables(make_cols())
    (got,), ctx = check_pair(_index_sum(ttb, tanp), (t,), _index_sum(jtb, janp), (jt,),
                             executor, 17)
    assert ctx.stats["stages"] == 1                   # all in one stage
    assert got.dtype == np.float32                    # col narrows the float64 columns
    want = float((make_cols()["crime"] * 100 / make_cols()["pop"]).sum())
    assert np.isclose(float(got), want, rtol=1e-6)


def _filter(tb, anp):
    def pipe(t):
        return tb.filter_rows(t, anp.greater(tb.col(t, "pop"), 500.0))
    return pipe


@pytest.mark.parametrize("executor", EXECUTORS)
def test_filter_pipeline(executor):
    cols = make_cols()
    t, jt = _tables(cols)
    (out,), ctx = check_pair(_filter(ttb, tanp), (t,), _filter(jtb, janp), (jt,), executor, 13)
    assert ctx.stats["stages"] == 1
    m = cols["pop"] > 500
    assert len(out["crime"]) == int(m.sum())
    # a dynamic op receives the columns as given: float64 and int64 stay
    assert out["crime"].dtype == np.float64 and out["city"].dtype == np.int64
    np.testing.assert_array_equal(out["crime"], cols["crime"][m])


def _groupby(tb, op, val="pop"):
    def pipe(t):
        return tb.groupby_agg(t, key="city", val=val, op=op)
    return pipe


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("op", ["sum", "count", "mean", "max", "min"])
def test_groupby_partials_reaggregate(op, executor):
    cols = make_cols(n=173)
    t, jt = _tables(cols)
    (res,), ctx = check_pair(_groupby(ttb, op), (t,), _groupby(jtb, op), (jt,), executor, 10)
    if executor != "eager":
        assert ctx.stats["chunks"] > 10               # really chunked
    if op == "mean":
        res = to_np(ttb.finalize_mean(ttb.Table({k: torch.from_numpy(v) for k, v in res.items()}),
                                      "city"))
        jres = jtb.finalize_mean(jtb.Table(_run(jm, _groupby(jtb, op), (jt,), "eager", 10,
                                                **JAX_CFG)[0][0]), "city")
        same_values(res, to_np(jres), "finalize_mean")
    assert res["city"].dtype == np.int64
    assert res[op].dtype == (np.int64 if op == "count" else np.float64)
    for k, v in zip(res["city"], res[op]):
        rows = cols["pop"][cols["city"] == k]
        want = dict(sum=rows.sum(), count=len(rows), mean=rows.mean(),
                    max=rows.max(), min=rows.min())[op]
        assert np.isclose(v, want), (op, k, v, want)


def _join(tb):
    def pipe(left, right):
        return tb.join_inner(left, right, on="city")
    return pipe


@pytest.mark.parametrize("executor", EXECUTORS)
def test_join_splits_left_broadcasts_right(executor):
    cols = make_cols(n=64)
    left, jleft = _tables(cols)
    right, jright = _tables({"city": np.arange(7, dtype=np.int64),
                             "name_len": np.arange(7, dtype=np.float64) + 3})
    (out,), _ = check_pair(_join(ttb), (left, right), _join(jtb), (jleft, jright),
                           executor, 9)
    assert len(out["city"]) == 64                     # every key matches
    np.testing.assert_allclose(out["name_len"], cols["city"].astype(np.float64) + 3)


def test_join_keeps_only_matching_keys_and_suffixes_clashes():
    """Keys absent on the right drop; a right column named like a left one
    gets ``_r``; int32 left keys meet int64 right keys."""
    left, jleft = _tables({"city": np.array([4, 0, 9, 2, 4], np.int32),
                           "v": np.arange(5, dtype=np.float32)})
    right, jright = _tables({"city": np.array([2, 4, 0], np.int64),
                             "v": np.array([20.0, 40.0, 0.0])})
    check_pair(_join(ttb), (left, right), _join(jtb), (jleft, jright), "pipelined", 2)
    out = to_np(ttb._join_inner(left, right, "city"))
    assert list(out) == ["city", "v", "v_r"]
    np.testing.assert_array_equal(out["city"], [4, 0, 2, 4])
    np.testing.assert_array_equal(out["v_r"], [40.0, 0.0, 20.0, 40.0])


@given(n=hst.integers(2, 300), batch=hst.integers(1, 64), seed=hst.integers(0, 5))
@settings(max_examples=10, deadline=None)
def test_groupby_chunking_invariant(n, batch, seed):
    """Property: partial aggregation + re-aggregation == one-shot (and ==
    the reference's one-shot)."""
    cols = make_cols(n=n, seed=seed)
    t, jt = _tables(cols)
    with tm.session(executor="pipelined", batch_elements=batch, **PORT_CFG):
        g = ttb.groupby_agg(t, key="city", val="crime", op="sum").value
    whole = ttb._group_reduce(t, "city", "crime", "sum")
    np.testing.assert_allclose(g.cols["sum"].numpy(), whole.cols["sum"].numpy(), rtol=1e-9)
    same_values(to_np(whole), to_np(jtb._group_reduce(jt, "city", "crime", "sum")))


# ---------------------------------------------------------------------------
# NaN group keys (ROADMAP C11): one group, sorted last, as np.unique
# ---------------------------------------------------------------------------

OPS = ["sum", "count", "mean", "max", "min"]


def nan_key_cols(n=160, seed=0):
    """Float64 keys 0-4 (-0.0 beside 0.0), 10% of them NaN, and float64
    values, from a seeded ``RandomState``."""
    r = np.random.RandomState(seed)
    key = r.randint(0, 5, n).astype(np.float64)
    key[(key == 0) & (r.rand(n) < 0.5)] = -0.0
    key[r.rand(n) < 0.1] = np.nan
    return {"key": key, "val": r.rand(n) * 10}


def _nan_oracle(cols, op):
    """numpy per group, the NaN rows one group last: (keys, values, counts)."""
    key, val = cols["key"], cols["val"]
    nan = np.isnan(key)
    keys = np.unique(key[~nan])
    rows = [val[key == k] for k in keys] + [val[nan]]
    fold = dict(sum=np.sum, count=len, mean=np.sum, max=np.max, min=np.min)[op]
    return (np.append(keys, np.nan), np.array([fold(r) for r in rows], np.float64),
            np.array([len(r) for r in rows]))


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("op", OPS)
def test_nan_keys_form_one_group_sorted_last(op, executor):
    cols = nan_key_cols()
    assert np.isnan(cols["key"]).sum() > 5 and (np.signbit(cols["key"]) & (cols["key"] == 0)).any()
    t, jt = _tables(cols)
    pipe = lambda tb: (lambda t: tb.groupby_agg(t, key="key", val="val", op=op))
    (res,), ctx = check_pair(pipe(ttb), (t,), pipe(jtb), (jt,), executor, 16)
    if executor != "eager":
        assert ctx.stats["chunks"] > 5                # partials merged by GroupSplit
    keys, vals, counts = _nan_oracle(cols, op)
    assert np.isnan(res["key"][-1]) and not np.isnan(res["key"][:-1]).any()
    np.testing.assert_array_equal(res["key"], keys)
    np.testing.assert_allclose(res[op], vals, rtol=1e-9)
    if op == "mean":
        np.testing.assert_array_equal(res["_cnt"], counts)
    same_values(to_np(ttb._group_reduce(t, "key", "val", op)),
                to_np(jtb._group_reduce(jt, "key", "val", op)), "whole")


@pytest.mark.parametrize("op", OPS)
def test_group_split_merges_nan_keyed_partials_as_the_reference(op):
    cols = nan_key_cols(n=97, seed=3)
    t, jt = _tables(cols)
    ranges = [(s, min(s + 20, 97)) for s in range(0, 97, 20)]
    parts = [ttb._group_reduce_partial(ttb.TableSplit(97).split(t, s, e), "key", "val", op)
             for s, e in ranges]
    jparts = [jtb._group_reduce_partial(jtb.TableSplit(97).split(jt, s, e), "key", "val", op)
              for s, e in ranges]
    assert all(np.isnan(p.cols["key"].numpy()).sum() <= 1 for p in parts)
    got = to_np(ttb.GroupSplit(op, "key", "val").merge(parts))
    same_values(got, to_np(jtb.GroupSplit(op, "key", "val").merge(jparts)), "merge")
    keys, vals, _ = _nan_oracle(cols, op)
    np.testing.assert_array_equal(got["key"], keys)
    np.testing.assert_allclose(got[op], vals, rtol=1e-9)


def test_integer_and_signed_zero_keys_keep_their_groups():
    """Integer keys take ``torch.unique`` as before; float keys -0.0 and
    0.0 stay one group, as in the reference."""
    keys = np.array([3, -1, 3, 0, 7, -1], np.int64)
    t, jt = _tables({"k": keys, "v": np.arange(6.0)})
    same_values(to_np(ttb._group_reduce(t, "k", "v", "sum")),
                to_np(jtb._group_reduce(jt, "k", "v", "sum")))
    t, jt = _tables({"k": np.array([0.0, -0.0, 1.5, -0.0]), "v": np.arange(4.0)})
    got = to_np(ttb._group_reduce(t, "k", "v", "count"))
    same_values(got, to_np(jtb._group_reduce(jt, "k", "v", "count")))
    np.testing.assert_array_equal(got["count"], [3, 1])


# ---------------------------------------------------------------------------
# tests/test_differential.py's table surface
# ---------------------------------------------------------------------------

SIZES = [0, 1, 7, 257]


def _surface(tb, anp):
    def pipe(t):
        idx = anp.divide(anp.multiply(tb.col(t, "crime"), 100.0), tb.col(t, "pop"))
        return idx, anp.sum(idx), anp.sum(anp.add(idx, 1.0))
    return pipe


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("nrows", SIZES)
def test_table_surface(executor, nrows):
    r = np.random.RandomState(nrows + 3)
    t, jt = _tables({"pop": (r.rand(nrows) * 1000 + 1.0).astype(np.float32),
                     "crime": (r.rand(nrows) * 10).astype(np.float32)})
    check_pair(_surface(ttb, tanp), (t,), _surface(jtb, janp), (jt,), executor, 32)


# ---------------------------------------------------------------------------
# fig4's DataFrame workloads (float64/int64 columns)
# ---------------------------------------------------------------------------


def _workload(name, n):
    """(port fn, port args, reference fn, reference args)."""
    if name == "movielens":
        ratings, movies = tw.movielens_tables(n, n_movies=40, device="cpu")
        return (tw.movielens, (ratings, movies), jw.movielens,
                (jtb.Table(ratings.to_numpy()), jtb.Table(movies.to_numpy())))
    t = {"crime_index": tw.crime_table, "data_cleaning": tw.cleaning_table,
         "birth_analysis": tw.birth_table}[name](n, device="cpu")
    return getattr(tw, name), (t,), getattr(jw, name), (jtb.Table(t.to_numpy()),)


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("name", ["crime_index", "data_cleaning", "birth_analysis",
                                  "movielens"])
def test_fig4_workloads_match_jax(name, executor):
    """300 rows in chunks of 64; crime_index's records are the reference's
    (MZ501 on the unused ``col``, MZ505 declining the reduction past the
    map); the numpy oracles hold too."""
    tfn, targs, jfn, jargs = _workload(name, 300)
    vals, ctx = check_pair(tfn, targs, jfn, jargs, executor, 64)
    if name == "crime_index":
        assert np.isclose(float(vals[0]), tw.crime_index_np(targs[0]), rtol=1e-5)
        assert vals[0].dtype == np.float32
        assert [r.code for r in ctx._last_rewrites] == ["MZ501", "MZ505"]
    if name == "data_cleaning":
        want = tw.data_cleaning_np(targs[0])
        assert float(vals[0]) == want[0]
        assert np.isclose(float(vals[1]), want[1], rtol=1e-5)
    if name in ("birth_analysis", "movielens"):
        key, col = ("year", "sum") if name == "birth_analysis" else ("movie", "mean")
        assert vals[0][key].dtype == np.int64 and vals[0][col].dtype == np.float64


@pytest.mark.parametrize("executor", EXECUTORS)
def test_filter_of_a_table_map_declines_pushdown_as_jax(executor):
    """``filter_rows`` is selective over ``t``; its data argument here is
    ``with_column``'s table, not an elementwise map, so the pushdown is
    declined with the reference's MZ505 record."""
    def pipe(tb, anp):
        def f(t):
            wide = tb.with_column(t, "idx", anp.multiply(tb.col(t, "crime"), 2.0))
            kept = tb.filter_rows(wide, anp.greater(tb.col(t, "pop"), 500.0))
            return kept, tb.select(wide, ("idx",))
        return f
    t, jt = _tables(make_cols(n=90, seed=4))
    (kept, sel), ctx = check_pair(pipe(ttb, tanp), (t,), pipe(jtb, janp), (jt,), executor, 16)
    assert any(r.code == "MZ505" and r.subject.startswith("with_column")
               for r in ctx._last_rewrites)
    assert sel["idx"].dtype == np.float32 and kept["pop"].dtype == np.float32


@pytest.mark.parametrize("executor", ["pipelined", "fused", "scan", "cuda"])
def test_reference_quirk_reduction_of_broadcast_inputs_counts_per_chunk(executor):
    """ROADMAP C10: a filtered table's columns reach the next stage as
    broadcast inputs; when that stage is split by another input (the whole
    table, for a ``groupby_agg``), the reference's chunking executors sum
    the whole filtered extent in every chunk and add the copies (6 chunks
    of 17 of 100 rows give 6x).  The port plans the same stages and chunks
    and takes the reduction once: its value is the oracle's and the
    reference's ``eager`` one."""
    def pipe(tb, anp):
        def f(t):
            kept = tb.filter_rows(t, anp.greater(tb.col(t, "pop"), 500.0))
            idx = anp.divide(anp.multiply(tb.col(kept, "crime"), 100.0), tb.col(kept, "pop"))
            return anp.sum(idx), tb.groupby_agg(t, key="city", val="pop", op="sum"), idx
        return f
    cols = make_cols()
    t, jt = _tables(cols)
    jv, jplan, jctx = _run(jm, pipe(jtb, janp), (jt,), PAIRS[executor], 17, **JAX_CFG)
    tv, tplan, tctx = _run(tm, pipe(ttb, tanp), (t,), executor, 17, **PORT_CFG)
    je, _, _ = _run(jm, pipe(jtb, janp), (jt,), "eager", 17, **JAX_CFG)
    assert tplan == jplan and tplan[1] == ["divide", "sum", "groupby_agg"]
    assert tctx.stats["chunks"] == jctx.stats["chunks"] == 12
    m = cols["pop"] > 500
    oracle = (cols["crime"][m] * 100 / cols["pop"][m]).sum()
    np.testing.assert_allclose(float(jv[0]), 6 * oracle, rtol=1e-5)   # the reference's fault
    np.testing.assert_allclose(float(tv[0]), oracle, rtol=1e-5)
    for i, (g, w) in enumerate(zip(tv, je)):
        same_values(g, w, f"{executor} output {i}")
    for i in (1, 2):
        same_values(tv[i], jv[i], f"{executor} output {i}")


@pytest.mark.parametrize("executor", ["eager", "pipelined"])
def test_col_narrows_and_dynamic_ops_keep_widths(executor):
    """One table read by a non-dynamic op (narrowed: int32, float32) and by
    dynamic ops (as given: int64, float64) in one session."""
    t, jt = _tables(make_cols(n=40, seed=5))

    def pipe(tb):
        def f(t):
            return (tb.col(t, "city"), tb.col(t, "pop"),
                    tb.groupby_agg(t, key="city", val="pop", op="max"),
                    tb.select(t, ("city", "crime")))
        return f
    (city, pop, g, sel), _ = check_pair(pipe(ttb), (t,), pipe(jtb), (jt,), executor, 8)
    assert (city.dtype, pop.dtype) == (np.int32, np.float32)
    assert (g["city"].dtype, g["max"].dtype) == (np.int64, np.float64)
    assert (sel["city"].dtype, sel["crime"].dtype) == (np.int32, np.float32)


def test_calls_outside_a_session_narrow_all_but_dynamic_ops():
    t, _ = _tables(make_cols(n=10))
    assert ttb.col(t, "pop").dtype == torch.float32
    assert ttb.filter_rows(t, torch.ones(10, dtype=torch.bool)).cols["pop"].dtype \
        == torch.float64


# ---------------------------------------------------------------------------
# split types and probe examples
# ---------------------------------------------------------------------------


def test_split_types_and_names_match_the_reference():
    t, jt = _tables(make_cols(n=20))
    assert ttb.TableSplit.name == jtb.TableSplit.name == "TableSplit"
    assert ttb.GroupSplit.name == jtb.GroupSplit.name == "GroupSplit"
    assert ttb.TableUnknown.name == jtb.TableUnknown.name == "unknown"
    assert not ttb.GroupSplit("sum", "city", "pop").splittable
    ts, jts = ttb.TableSplit(20), jtb.TableSplit(20)
    assert ts.info(t).elem_bytes == jts.info(jt).elem_bytes == 24
    pieces = [ts.split(t, s, min(s + 6, 20)) for s in range(0, 20, 6)]
    same_values(to_np(ts.merge(pieces)), {k: np.asarray(v, {np.int64: np.int32,
                                                           np.float64: np.float32}[v.dtype.type])
                                          for k, v in jt.cols.items()})
    assert set(ttb.__all_ops__) == set(jtb.__all_ops__)
    for name, fn in ttb.__all_ops__.items():
        jfn = jtb.__all_ops__[name]
        assert fn.name == jfn.name and fn.sa.static == jfn.sa.static
        assert getattr(fn.sa, "dynamic", False) == getattr(jfn.sa, "dynamic", False)
        assert fn.sa.selective == jfn.sa.selective


def test_probe_examples_match_the_reference():
    """Every op on its ``__probe_examples__`` inputs, in an ``eager``
    session of each package: the same values and dtypes."""
    texs, jexs = ttb.__probe_examples__(device="cpu"), jtb.__probe_examples__()
    assert set(texs) == set(jexs)
    for name in jexs:
        cases = [(texs[name], jexs[name])] if isinstance(jexs[name], dict) else \
            list(zip(texs[name], jexs[name]))
        for tkw, jkw in cases:
            with jm.session(executor="eager", **JAX_CFG):
                want = to_np(jtb.__all_ops__[name](**jkw).value)
            with tm.session(executor="eager", **PORT_CFG):
                got = to_np(ttb.__all_ops__[name](**tkw).value)
            same_values(got, want, name)


# ---------------------------------------------------------------------------
# plan persistence: a TableSplit entry before and after the import
# ---------------------------------------------------------------------------

_SAVE = """
import sys, torch
from repro_torch.core import mozart, annotated_numpy as anp, annotated_table as tb
t = tb.Table({"pop": torch.linspace(1.0, 2.0, 500, dtype=torch.float64),
              "crime": torch.linspace(0.0, 1.0, 500, dtype=torch.float64)})
with mozart.session(executor="fused", device="cpu", plan_cache_path=sys.argv[1]) as ctx:
    v = float(anp.sum(anp.divide(tb.col(t, "crime"), tb.col(t, "pop"))).value)
print(v)
"""

_LOAD = """
import json, sys
from repro_torch.core import plan_cache
path = sys.argv[1]
first = plan_cache.load_once(path)
unresolved = plan_cache.stats["persist_unresolved"]
from repro_torch.core import annotated_table   # the TableSplit class now exists
second = plan_cache.load_once(path)
entry = plan_cache.entries()[0]
types = sorted({type(t).__name__ for tm in entry.stage_templates for _, t in tm.inputs})
print(json.dumps({"first": first, "unresolved": unresolved, "second": second,
                  "types": types, "loaded": plan_cache.stats["persist_loaded"]}))
"""


def _subprocess(code, path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("MOZART_PLAN_CACHE", None)
    out = subprocess.run([sys.executable, "-c", code, path], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_table_split_entry_waits_for_the_import(tmp_path):
    """A plan file holding a ``TableSplit`` entry, loaded in a fresh process
    before ``annotated_table`` is imported: the entry counts
    ``persist_unresolved`` and the path stays retryable; after the import it
    loads, with its ``TableSplit`` input."""
    path = str(tmp_path / "plans.json")
    _subprocess(_SAVE, path)
    got = json.loads(_subprocess(_LOAD, path))
    assert (got["first"], got["unresolved"], got["second"], got["loaded"]) == (0, 1, 1, 1)
    assert "TableSplit" in got["types"]


def test_table_unknown_keeps_its_class_through_a_plan_file(tmp_path):
    """A filtered Table's split type (``TableUnknown``, whose merge
    concatenates columns) persists as itself, not as a plain
    ``UnknownSplit``, and a process that loads the file merges a filter's
    chunks into a Table again (the reference skips such entries)."""
    path = str(tmp_path / "plans.json")
    cols = make_cols(n=60, seed=2)
    t, _ = _tables(cols)

    def once():
        with tm.session(executor="pipelined", device="cpu", batch_elements=16) as ctx:
            out = _filter(ttb, tanp)(t).value
        return out, ctx
    once()
    tplan_cache.save(path)
    tplan_cache.clear()
    assert tplan_cache.load(path) == 1
    (entry,) = tplan_cache.entries()
    types = {type(ty).__name__ for tmpl in entry.stage_templates
             for ty in tmpl.out_types.values()}
    assert "TableUnknown" in types
    out, ctx = once()
    assert ctx.stats.get("planner_calls", 0) == 0 and ctx.stats["chunks"] == 4
    m = cols["pop"] > 500
    np.testing.assert_array_equal(out.cols["crime"].numpy(), cols["crime"][m])
