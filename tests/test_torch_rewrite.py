"""The port's static rewrite pass (``repro_torch/core/rewrite.py``) held
against the JAX package's (``src/repro/core/rewrite.py``) on the same numpy
inputs.

Against JAX, exactly: each record's ``code``/``kind``/``subject``, the plan
entry's stage templates and persisted records, and the counters
(``rewrites_applied``/``_declined``, ``planner_calls``, and the chunk, call
and stage counts on every executor but ``auto``), on the three-rewrite
chain, Black-Scholes, Haversine, quickstart and the reference's
``smoke/rewrite`` chain; the JAX side runs ``pallas`` where the port runs
``cuda``, and the port side runs on the CPU (``cuda`` takes the kernel's
plain version).  Outputs within ``TOL`` (float32 2e-5; sums 1e-4; Haversine
also atol 1e-2, as ``tests/test_torch_executors.py``).

The port-only counterparts of ``tests/test_rewrite.py``: rewritten ==
unrewritten on every port executor (empty, odd and aliased inputs), every
MZ5xx record fires and declines for the documented reason, CSE never merges
calls that could differ (a property test), warm calls replay the rewritten
graph from the schema-v7 plan cache with zero planner calls and zero traces,
v6 files migrate forward, and the ``MOZART_REANALYZE_EVERY`` tick refreshes
the records.  ``test_verify_*`` have their counterparts in
``tests/test_torch_analysis.py``; ``test_lint_*`` wait for the port of
``launch/lint.py`` (ROADMAP A10.2).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import annotated_numpy as janp
from repro.core import mozart as jmozart
from repro.core import plan_cache as jpc
from repro.testing import given, hst, settings
from repro_torch.core import annotated_numpy as tanp
from repro_torch.core import mozart as tmozart
from repro_torch.core import plan_cache as tpc
from repro_torch.core import rewrite
from repro_torch.core.stage_exec import available_executors, trace_count

from test_torch_executors import CASES, _data, _tol, assert_counts_as_named, close

TOL = 2e-5
PORT_EXECUTORS = sorted(available_executors())
JAX_OF = {"cuda": "pallas"}
COUNTERS = ("rewrites_applied", "rewrites_declined", "planner_calls",
            "plan_cache_hits", "plan_cache_misses")
RUN_COUNTERS = ("chunks", "calls", "stages")


@pytest.fixture(autouse=True)
def _fresh_port_cache():
    tpc.clear()
    yield
    tpc.clear()


def _records(rs):
    return [(r.code, r.kind, r.subject) for r in rs]


def _persisted(entry):
    return [(r["code"], r["kind"], r["subject"]) for r in entry.rewrites]


def _counts(ctx, keys):
    return {k: ctx.stats.get(k, 0) for k in keys}


def _sig(t):
    """A split type as (class name, params), ``unknown`` uids erased (each
    package numbers its own, process-wide), as the fingerprint erases them."""
    name = type(t).__name__
    return (name, t.axis) if name == "UnknownSplit" else (name, t.params)


def _templates(entry):
    return [(list(tm.positions),
             [(desc, _sig(t)) for desc, t in tm.inputs],
             sorted((p, _sig(t)) for p, t in tm.out_types.items()),
             sorted((k, _sig(t)) for k, t in tm.arg_types.items()))
            for tm in entry.stage_templates]


def _chain(anp):
    def f(x, mask):
        """One dead call, one CSE pair, one pushdown opportunity."""
        anp.exp(x)                       # dead: its Future dies at once
        b1 = anp.exp(x)
        b2 = anp.exp(x)                  # CSE duplicate of b1
        s = anp.add(b1, b2)
        m = anp.multiply(x, 3.0)
        fl = anp.compress(mask, m)       # pushdown: m itself is unobserved
        return s, fl
    return f


def _chain_inputs(n):
    r = np.random.RandomState(n + 3)
    return (r.rand(n) + 0.5).astype(np.float32), np.arange(n) % 2 == 0


def _jax_chain(executor, x, mask, **kw):
    with jmozart.session(executor=JAX_OF.get(executor, executor), **kw) as ctx:
        s, f = _chain(janp)(jnp.asarray(x), jnp.asarray(mask))
        out = (np.asarray(s.value), np.asarray(f.value))
    return out, ctx


def _port_chain(executor, x, mask, **kw):
    with tmozart.session(executor=executor, device="cpu", **kw) as ctx:
        s, f = _chain(tanp)(torch.from_numpy(x), torch.from_numpy(mask))
        out = (s.value.numpy(), f.value.numpy())
    return out, ctx


def _kw(**extra):
    return {"batch_elements": 32, "autotune": False, **extra}


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("executor", PORT_EXECUTORS)
@pytest.mark.parametrize("n", [0, 7, 257])
def test_chain_records_templates_counters_equal_jax(executor, n):
    x, mask = _chain_inputs(n)
    jpc.clear()
    jout, jctx = _jax_chain(executor, x, mask, **_kw())
    tout, tctx = _port_chain(executor, x, mask, **_kw())
    assert _records(tctx._last_rewrites) == _records(jctx._last_rewrites)
    assert {r.code for r in tctx._last_rewrites} >= {"MZ501", "MZ502", "MZ503"}
    keys = COUNTERS + (() if executor == "auto" else RUN_COUNTERS)
    assert _counts(tctx, keys) == _counts(jctx, keys)
    (je,), (te,) = jpc.entries(), tpc.entries()
    assert _templates(te) == _templates(je)
    assert te.fn_names == je.fn_names
    assert _persisted(te) == _persisted(je)
    for g, w in zip(tout, jout):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("executor", ["eager", "pipelined", "fused", "scan", "cuda"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_workload_records_templates_counters_equal_jax(name, executor):
    """Black-Scholes (one MZ502 on the repeated ``multiply(e_rt, strike)``
    and one MZ505), Haversine (one MZ505), quickstart and the two-stage case,
    rewrite on as by default, plan cache on: a miss, then two hits."""
    jfn, tfn, batch = CASES[name]
    data = _data(name)
    jpc.clear()
    for call in range(3):
        with jmozart.session(executor=JAX_OF.get(executor, executor),
                             batch_elements=batch) as jctx:
            jouts = jfn(**{k: jnp.asarray(v) for k, v in data.items()})
            jvals = [np.asarray(o) for o in (jouts if isinstance(jouts, tuple) else (jouts,))]
        with tmozart.session(executor=executor, device="cpu", batch_elements=batch) as tctx:
            touts = tfn(**{k: torch.from_numpy(v.copy()) for k, v in data.items()})
            tvals = [o.value.numpy() for o in (touts if isinstance(touts, tuple) else (touts,))]
        assert _records(tctx._last_rewrites) == _records(jctx._last_rewrites), call
        assert _counts(tctx, COUNTERS + RUN_COUNTERS) == \
            _counts(jctx, COUNTERS + RUN_COUNTERS), call
        for i, (g, w) in enumerate(zip(tvals, jvals)):
            close(g, w, **_tol(name, i))
    if name == "black_scholes":
        assert _records(tctx._last_rewrites) == [
            ("MZ502", "cse", "multiply#26"), ("MZ505", "declined", "31-node graph")]
    if name == "haversine":
        assert _records(tctx._last_rewrites) == [("MZ505", "declined", "16-node graph")]
    (je,), (te,) = jpc.entries(), tpc.entries()
    assert _templates(te) == _templates(je)
    assert _persisted(te) == _persisted(je)


def _plan_shape(stages):
    """Stages as (fn name, escaping) per node, node ids erased."""
    return [[(n.fn.name, n.id in s.escaping) for n in s.nodes] for s in stages]


@pytest.mark.parametrize("executor", ["fused", "cuda"])
def test_pass_runs_once_per_graph_then_replays_like_jax(executor, monkeypatch):
    """The first capture of Black-Scholes runs the pass (and MZ504's two
    planner simulations); later captures replay its script with none of
    that analysis.  A replay under other node ids (an unrelated call
    evaluated first) renames the records as the reference's fresh pass
    names them, and every capture gets the plan a fresh pass gives,
    escaping outputs included."""
    from repro_torch.core import runtime as truntime
    jfn, tfn, batch = CASES["black_scholes"]
    data = _data("black_scholes")
    plans = []
    real = truntime.lookup_or_plan

    def recording(pending, graph, ctx):
        stages, entry = real(pending, graph, ctx)
        plans.append(_plan_shape(stages))
        return stages, entry
    monkeypatch.setattr(truntime, "lookup_or_plan", recording)
    jpc.clear()
    want = []
    for call in range(3):
        shift = call > 0
        with jmozart.session(executor=JAX_OF.get(executor, executor),
                             batch_elements=batch) as jctx:
            if shift:
                janp.add(jnp.ones(3, jnp.float32), 1.0).value
            jvals = [np.asarray(o) for o in jfn(**{k: jnp.asarray(v) for k, v in data.items()})]
        with tmozart.session(executor=executor, device="cpu", batch_elements=batch) as tctx:
            if shift:
                tanp.add(torch.ones(3), 1.0).value
            tvals = [o.value.numpy() for o in
                     tfn(**{k: torch.from_numpy(v.copy()) for k, v in data.items()})]
        assert _records(tctx._last_rewrites) == _records(jctx._last_rewrites), call
        assert _counts(tctx, COUNTERS) == _counts(jctx, COUNTERS), call
        want.append(_counts(tctx, ("rewrite_passes", "rewrite_replays",
                                   "rewrite_simulations")))
        for i, (g, w) in enumerate(zip(tvals, jvals)):
            close(g, w, **_tol("black_scholes", i))
    assert _records(tctx._last_rewrites)[0] == ("MZ502", "cse", "multiply#27")
    assert want == [
        {"rewrite_passes": 1, "rewrite_replays": 0, "rewrite_simulations": 2},
        {"rewrite_passes": 1, "rewrite_replays": 1, "rewrite_simulations": 0},
        {"rewrite_passes": 0, "rewrite_replays": 2, "rewrite_simulations": 0}]
    bs_plans = [p for p in plans if len(p[0]) > 1]
    with tmozart.session(executor=executor, device="cpu", batch_elements=batch,
                         plan_cache=False):
        [o.value for o in tfn(**{k: torch.from_numpy(v.copy()) for k, v in data.items()})]
    assert len(bs_plans) == 3 and all(p == plans[-1] for p in bs_plans)


def test_replay_key_holds_what_the_pass_decides_on():
    """Two captures with one fingerprint that the pass must treat apart:
    equal against unequal captured scalars (CSE) and a dropped against a
    held Future (dead-stage elimination).  Neither replays the other's
    script."""
    x = torch.linspace(0.1, 1.0, 64)
    xn = x.numpy()

    def scaled(a, b):
        with tmozart.session(executor="fused", device="cpu") as ctx:
            got = tanp.add(tanp.multiply(x, a), tanp.multiply(x, b)).value.numpy()
        return got, ctx

    # ``float("2")``: an equal scalar that is another object (the
    # fingerprint's alias slots tell objects apart, not values)
    for a, b in ((2.0, float("2")), (2.0, 3.0), (2.0, float("2"))):
        got, ctx = scaled(a, b)
        np.testing.assert_allclose(got, xn * a + xn * b, rtol=TOL)
        assert any(r.code == "MZ502" for r in ctx._last_rewrites) == (a == b)

    def side(keep):
        with tmozart.session(executor="fused", device="cpu") as ctx:
            e = tanp.exp(x)
            s = tanp.add(x, 1.0)
            if not keep:
                del e
            s.value
            kept = e.value.numpy() if keep else None
        return kept, ctx

    for keep in (False, True, False):
        kept, ctx = side(keep)
        assert any(r.code == "MZ501" for r in ctx._last_rewrites) == (not keep)
        if keep:
            np.testing.assert_allclose(kept, np.exp(xn), rtol=TOL)
    assert tpc.stats["misses"] >= 2


def _smoke_rewrite_chain(anp, arr, n, rows):
    """The reference's ``smoke/rewrite`` chain (``benchmarks/run.py``)."""
    x = arr(np.linspace(0.1, 1.0, n, dtype=np.float32))
    dead_mat = arr(np.ones((rows, n), np.float32))
    mask = arr(np.arange(n) % 2 == 0)

    def f():
        a = anp.exp(x)
        anp.matvec(dead_mat, a)          # dead branch with its own stage
        b1 = anp.exp(x)
        b2 = anp.exp(x)                  # CSE duplicate of b1
        s = anp.add(b1, b2)
        m = anp.multiply(x, 3.0)
        return s, anp.compress(mask, m)  # pushdown: m itself is unobserved
    return f


@pytest.mark.parametrize("executor", ["fused", "scan", "pipelined", "cuda"])
def test_smoke_rewrite_chain_equal_jax(executor):
    """Rewrite on vs off, handoff off, fixed chunking (as the reference's
    gate): MZ501/502/503 in the entry, calls strictly lower with the pass on
    and interior bytes strictly lower on the chunk-loop drivers (the
    reference gates ``fused``; on ``scan`` and ``cuda`` the off run merges no
    more than the on run, as on JAX's ``scan`` and ``pallas``), outputs
    bit-equal, the warm third call plans and traces nothing; every count
    equal to JAX's."""
    n, rows = 2048, 16
    jf = _smoke_rewrite_chain(janp, jnp.asarray, n, rows)
    tf = _smoke_rewrite_chain(tanp, torch.from_numpy, n, rows)
    cfg = dict(handoff=False, autotune=False, batch_elements=n // 4)
    jpc.clear()
    got = {}
    for on in (True, False):
        with jmozart.session(executor=JAX_OF.get(executor, executor), rewrite=on,
                             **cfg) as jctx:
            js, jfl = jf()
            jout = (np.asarray(js.value), np.asarray(jfl.value))
        with tmozart.session(executor=executor, device="cpu", rewrite=on, **cfg) as tctx:
            ts, tfl = tf()
            tout = (ts.value.numpy(), tfl.value.numpy())
        got[on] = tout, tctx.counters.bytes_interior(), tctx.stats["calls"]
        assert tctx.counters.bytes_interior() == jctx.counters.bytes_interior(), on
        assert _counts(tctx, COUNTERS + RUN_COUNTERS) == \
            _counts(jctx, COUNTERS + RUN_COUNTERS), on
        for g, w in zip(tout, jout):
            close(g, w, rtol=TOL, atol=TOL)
    codes = {r["code"] for e in tpc.entries() for r in e.rewrites}
    assert {"MZ501", "MZ502", "MZ503"} <= codes
    assert codes == {r["code"] for e in jpc.entries() for r in e.rewrites}
    (on_out, on_int, on_calls), (off_out, off_int, off_calls) = got[True], got[False]
    assert on_int <= off_int and on_calls < off_calls
    if executor in ("fused", "pipelined"):
        assert on_int < off_int
    for g, w in zip(on_out, off_out):
        assert np.array_equal(g, w)
    with tmozart.session(executor=executor, device="cpu", **cfg):
        tf()[0].value
    t0 = trace_count()
    with tmozart.session(executor=executor, device="cpu", **cfg) as warm:
        s, fl = tf()
        assert np.array_equal(s.value.numpy(), on_out[0])
    assert warm.stats["planner_calls"] == 0 and trace_count() == t0
    assert warm.stats.get("exec_builds", 0) == 0


@pytest.mark.parametrize("executor", ["cuda", "fused"])
def test_warm_pipeline_and_fast_path_plan_and_lower_nothing(executor):
    """With the pass on, a compiled pipeline's warm calls (and the
    ``arg_transparent`` replay's) make 0 planner calls, 0 traces and 0
    lowerings or builds, on the rewritten Black-Scholes graph."""
    _jfn, tfn, batch = CASES["black_scholes"]
    data = {k: torch.from_numpy(v.copy()) for k, v in _data("black_scholes").items()}
    want = [o.numpy() for o in tmozart.pipeline(
        lambda **d: tfn(**d), executor="eager", device="cpu")(**data)]
    for fast in (False, True):
        tpc.clear()
        p = tmozart.pipeline(lambda **d: tfn(**d), executor=executor, device="cpu",
                             batch_elements=batch, arg_transparent=fast)
        p.lower(**data).compile()
        for _ in range(3):
            outs = p(**data)
            assert p.warm(), p.last_call_stats
            assert p.last_call_stats.get("exec_builds", 0) == 0
            for i, (g, w) in enumerate(zip(outs, want)):
                close(g.numpy(), w, **_tol("black_scholes", i))
        if fast:
            assert p.stats["fast_path_calls"] == 2   # the first call builds the replay
        (entry,) = tpc.entries()
        assert [r["code"] for r in entry.rewrites] == ["MZ502", "MZ505"]
        assert sum(len(t.positions) for t in entry.stage_templates) == 31


def test_pass_is_idempotent_and_deterministic():
    """Re-applying the pass to its own output changes nothing and records
    no applied rewrite; two captures give the same records."""
    x, mask = _chain_inputs(64)
    recs = []
    for _ in range(2):
        with tmozart.session(executor="fused", device="cpu") as ctx:
            s, f = _chain(tanp)(torch.from_numpy(x), torch.from_numpy(mask))
            first = rewrite.apply(ctx.graph.pending(), ctx.graph, ctx)
            order = [n.id for n in first.pending]
            again = rewrite.apply(ctx.graph.pending(), ctx.graph, ctx)
            assert [n.id for n in again.pending] == order
            assert again.applied == []
            recs.append(_records(first.records))
            s.value, f.value
    assert recs[0] == recs[1]
    assert rewrite.RewriteRecord.from_json(first.records[0].to_json()) == first.records[0]


# ---------------------------------------------------------------------------
# Counterparts of tests/test_rewrite.py on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("executor", PORT_EXECUTORS)
@pytest.mark.parametrize("n", [0, 7, 257])
def test_rewrite_parity_all_executors(executor, n):
    x, mask = _chain_inputs(n)
    outs = {}
    for on in (True, False):
        tpc.clear()
        out, ctx = _port_chain(executor, x, mask, rewrite=on, **_kw())
        outs[on] = out
        if on:
            assert ctx.stats.get("rewrites_applied", 0) >= 1
    for i, (g, w) in enumerate(zip(outs[True], outs[False])):
        assert g.shape == w.shape and g.dtype == w.dtype, (executor, n, i)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=1e-6,
                                   err_msg=f"{executor} n={n} output {i}")


@pytest.mark.parametrize("executor", PORT_EXECUTORS)
def test_rewrite_parity_aliased_inputs(executor):
    """The same Future feeding several arguments of several ops survives
    CSE (the merged node inherits every alias's liveness)."""
    x = torch.linspace(0.2, 1.4, 33)

    def aliased(x):
        a = tanp.exp(x)
        b = tanp.add(a, a)
        c = tanp.add(a, a)               # CSE duplicate of b
        return tanp.multiply(b, c), a

    outs = {}
    for on in (True, False):
        tpc.clear()
        with tmozart.session(executor=executor, device="cpu", rewrite=on, **_kw()):
            p, a = aliased(x)
            outs[on] = (p.value.numpy(), a.value.numpy())
    for g, w in zip(outs[True], outs[False]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=1e-6, err_msg=executor)


def test_dead_elimination_cascades():
    """Retiring a dead consumer also retires producers only it needed, and
    the eliminated work never executes."""
    x = torch.linspace(0.1, 1.0, 64)
    dm = torch.ones((8, 64))

    def f(x):
        a = tanp.exp(x)
        tanp.matvec(dm, a)               # dead; sole consumer of ``a``
        return tanp.multiply(x, 2.0)

    with tmozart.session(executor="fused", device="cpu", autotune=False) as ctx:
        got = f(x).value.numpy()
    codes = [r.code for r in ctx._last_rewrites]
    assert codes.count("MZ501") == 2     # matvec AND the cascaded exp
    assert ctx.stats["calls"] == 1       # only the multiply ran
    np.testing.assert_allclose(got, x.numpy() * 2.0, rtol=1e-6)
    (entry,) = tpc.entries()
    assert [r["code"] for r in entry.rewrites].count("MZ501") == 2


def test_every_node_eliminated_plans_nothing():
    """A graph the pass empties plans nothing and makes no entry."""
    x = torch.linspace(0.1, 1.0, 16)
    with tmozart.session(executor="fused", device="cpu") as ctx:
        tanp.exp(x)
        tmozart.evaluate()
    assert [r.code for r in ctx._last_rewrites] == ["MZ501"]
    assert ctx.stats.get("planner_calls", 0) == 0 and ctx.stats.get("stages", 0) == 0
    assert tpc.entries() == [] and ctx.graph.nodes == {}


def test_live_future_is_never_dead():
    x = torch.linspace(0.1, 1.0, 16)
    with tmozart.session(executor="fused", device="cpu") as ctx:
        a = tanp.exp(x)
        s = tanp.add(a, 1.0)
        _ = s.value
        assert not any(r.code == "MZ501" for r in ctx._last_rewrites)
        np.testing.assert_allclose(a.value.numpy(), np.exp(x.numpy()), rtol=1e-6)


def _cse_merged(scalar_a, scalar_b) -> bool:
    """True iff multiply(x, a) and multiply(x, b) collapsed into one call."""
    tpc.clear()
    x = torch.linspace(0.1, 1.0, 16)
    with tmozart.session(executor="fused", device="cpu") as ctx:
        a = tanp.multiply(x, scalar_a)
        b = tanp.multiply(x, scalar_b)
        s = tanp.add(a, b)
        want = x.numpy() * np.float32(scalar_a) + x.numpy() * np.float32(scalar_b)
        np.testing.assert_allclose(s.value.numpy(), want, rtol=TOL, atol=1e-6)
    return any(r.code == "MZ502" for r in ctx._last_rewrites)


def test_cse_merges_identical_calls_only_once_executed():
    x = torch.linspace(0.1, 1.0, 48)
    with tmozart.session(executor="fused", device="cpu", autotune=False) as ctx:
        got = tanp.add(tanp.exp(x), tanp.exp(x)).value.numpy()
    assert any(r.code == "MZ502" for r in ctx._last_rewrites)
    (entry,) = tpc.entries()
    assert sum(len(t.positions) for t in entry.stage_templates) == 2
    np.testing.assert_allclose(got, 2 * np.exp(x.numpy()), rtol=TOL)


def test_cse_respects_captured_scalars_types_and_devices():
    assert _cse_merged(2.0, 2.0)
    assert not _cse_merged(2.0, 3.0)
    assert not _cse_merged(2, 2.0)       # int vs float: distinct calls
    # distinct tensors of one shape, dtype and device never merge
    x, y = torch.linspace(0.1, 1.0, 16), torch.linspace(0.1, 1.0, 16)
    with tmozart.session(executor="fused", device="cpu") as ctx:
        s = tanp.add(tanp.exp(x), tanp.exp(y))
        s.value
    assert not any(r.code == "MZ502" for r in ctx._last_rewrites)


@given(a=hst.floats(-2, 2, allow_nan=False),
       b=hst.floats(-2, 2, allow_nan=False),
       same=hst.booleans())
@settings(max_examples=10, deadline=None)
def test_cse_property_never_merges_distinct_scalars(a, b, same):
    """CSE merges two calls iff their captured scalars are equal (same type,
    same value), on both packages alike."""
    if same:
        b = a
    merged = _cse_merged(a, b)
    assert merged == ((type(a), a) == (type(b), b))
    x = jnp.linspace(0.1, 1.0, 16, dtype=jnp.float32)
    with jmozart.session(executor="fused") as jctx:
        np.asarray(janp.add(janp.multiply(x, a), janp.multiply(x, b)).value)
    assert merged == any(r.code == "MZ502" for r in jctx._last_rewrites)


def test_pushdown_hoists_filter_ahead_of_map():
    n = 64
    x = torch.linspace(0.1, 1.0, n)
    mask = torch.from_numpy(np.arange(n) % 2 == 0)
    with tmozart.session(executor="fused", device="cpu", autotune=False) as ctx:
        got = tanp.compress(mask, tanp.multiply(x, 3.0)).value.numpy()
    recs = [r for r in ctx._last_rewrites if r.code == "MZ503"]
    assert len(recs) == 1 and recs[0].saved_s > 0.0
    np.testing.assert_allclose(got, (x.numpy() * 3.0)[mask.numpy()], rtol=TOL, atol=1e-6)


def test_pushdown_declines_when_map_output_is_observed():
    n = 32
    x = torch.linspace(0.1, 1.0, n)
    mask = torch.from_numpy(np.arange(n) % 2 == 0)
    with tmozart.session(executor="fused", device="cpu") as ctx:
        m = tanp.multiply(x, 3.0)        # live Future: a hoist would skip elements
        fl = tanp.compress(mask, m)
        _ = fl.value
        codes = [r.code for r in ctx._last_rewrites]
        assert "MZ503" not in codes and "MZ505" in codes
        assert any("live Future" in r.detail for r in ctx._last_rewrites)
        np.testing.assert_allclose(m.value.numpy(), x.numpy() * 3.0, rtol=TOL)


def test_reduce_past_map_declined_with_reason():
    x = torch.linspace(0.1, 1.0, 32)
    with tmozart.session(executor="fused", device="cpu") as ctx:
        got = float(tanp.sum(tanp.exp(x)).value)
    declines = [r for r in ctx._last_rewrites if r.code == "MZ505"]
    assert any("distributivity" in r.detail for r in declines)
    np.testing.assert_allclose(got, float(np.sum(np.exp(x.numpy()))), rtol=TOL)


def test_reassociation_clusters_interleaved_chains():
    x8, y12 = torch.linspace(0.1, 1.0, 8), torch.linspace(0.2, 1.2, 12)

    def interleaved(x, y):
        a1 = tanp.exp(x)
        c1 = tanp.exp(y)                 # another extent: breaks the stage
        a2 = tanp.multiply(a1, 2.0)
        c2 = tanp.multiply(c1, 2.0)
        return a2, c2

    stages, outs = {}, {}
    for on in (True, False):
        tpc.clear()
        with tmozart.session(executor="fused", device="cpu", rewrite=on,
                             autotune=False) as ctx:
            a2, c2 = interleaved(x8, y12)
            outs[on] = (a2.value.numpy(), c2.value.numpy())
            stages[on] = ctx.stats["stages"]
            if on:
                assert any(r.code == "MZ504" for r in ctx._last_rewrites)
    assert stages[True] < stages[False]
    for g, w in zip(outs[True], outs[False]):
        np.testing.assert_allclose(g, w, rtol=TOL)


def _simple(x):
    tanp.exp(x)                          # dead
    b1 = tanp.exp(x)
    b2 = tanp.exp(x)                     # CSE pair
    return tanp.add(b1, b2)


def test_rewrites_roundtrip_schema_v7(tmp_path):
    x = torch.linspace(0.1, 1.0, 64)
    with tmozart.session(executor="fused", device="cpu", autotune=False):
        _ = _simple(x).value
    path = str(tmp_path / "plans.json")
    assert tpc.save(path) == 1
    payload = json.load(open(path))
    assert payload["schema"] == tpc.SCHEMA_VERSION == 7
    tpc.clear()
    assert tpc.load(path) == 1
    (entry,) = tpc.entries()
    codes = [r["code"] for r in entry.rewrites]
    assert "MZ501" in codes and "MZ502" in codes


def test_schema_v6_file_migrates_forward(tmp_path):
    x = torch.linspace(0.1, 1.0, 64)
    with tmozart.session(executor="fused", device="cpu", autotune=False):
        _ = _simple(x).value
    path = str(tmp_path / "plans.json")
    assert tpc.save(path) == 1
    payload = json.load(open(path))
    payload["schema"] = 6
    for e in payload["entries"]:
        e.pop("rewrites", None)          # v6 entries never carried rewrites
    json.dump(payload, open(path, "w"))
    tpc.clear()
    assert tpc.load(path) == 1
    (entry,) = tpc.entries()
    assert entry.rewrites == []


@pytest.mark.parametrize("executor", ["fused", "cuda"])
def test_warm_replay_zero_planner_calls_zero_retraces(executor):
    n = 96
    x, mask = _chain_inputs(n)

    def run():
        return _port_chain(executor, x, mask, autotune=False)

    want, _ = run()                      # miss: rewrite + plan + build
    run()                                # first hit
    t0 = trace_count()
    got, ctx = run()                     # warm: replay the rewritten graph
    assert ctx.stats.get("planner_calls", 0) == 0
    assert trace_count() - t0 == 0 and ctx.stats.get("exec_builds", 0) == 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    (entry,) = tpc.entries()
    assert {"MZ501", "MZ502", "MZ503"} <= {r["code"] for r in entry.rewrites}


def test_periodic_reanalysis_ticks_and_refreshes(monkeypatch):
    monkeypatch.setenv("MOZART_REANALYZE_EVERY", "2")
    x = torch.linspace(0.1, 1.0, 64)

    def run():
        with tmozart.session(executor="fused", device="cpu", autotune=False) as ctx:
            _ = _simple(x).value
        return ctx

    run()                                # miss
    (entry,) = tpc.entries()
    first = _persisted(entry)
    entry.rewrites = [{"code": "MZ505", "kind": "declined", "subject": "stale",
                       "detail": "recorded by an older pass", "saved_s": 0.0}]
    run()                                # hit 1
    assert entry.rewrites[0]["subject"] == "stale"
    ctx = run()                          # hit 2: the tick refreshes the records
    assert ctx.stats["reanalysis_ticks"] == 1 and tpc.stats["reanalysis_ticks"] == 1
    assert _persisted(entry) == first
    assert {r["code"] for r in entry.rewrites} >= {"MZ501", "MZ502"}
    assert run().stats["planner_calls"] == 0


def test_reanalysis_env_off_by_default(monkeypatch):
    monkeypatch.delenv("MOZART_REANALYZE_EVERY", raising=False)
    x = torch.linspace(0.1, 1.0, 64)
    for _ in range(3):
        with tmozart.session(executor="fused", device="cpu", autotune=False):
            _ = _simple(x).value
    assert tpc.stats.get("reanalysis_ticks", 0) == 0


def test_rewrite_knob_reconfigures_and_off_records_nothing():
    x = torch.linspace(0.1, 1.0, 64)
    with tmozart.session(executor="fused", device="cpu") as ctx:
        tmozart.configure(rewrite=False)
        assert ctx.rewrite is False
        _ = _simple(x).value
    assert ctx._last_rewrites == [] and ctx.stats.get("rewrites_applied", 0) == 0
    (entry,) = tpc.entries()
    assert entry.rewrites == []


class _StubNode:
    def __init__(self, nid, deps):
        self.id, self._deps = nid, deps

    def deps(self):
        return list(self._deps)


@given(edges=hst.lists(hst.integers(0, 10_000), min_size=0, max_size=60),
       n=hst.integers(1, 24))
@settings(max_examples=40, deadline=None)
def test_cluster_order_equals_the_reference(edges, n):
    """The port's ``_cluster`` (in-degree counts and a heap) gives the
    reference's order on random DAGs, duplicate edges included."""
    from repro.core import rewrite as jrewrite
    deps = {i: [] for i in range(n)}
    for j, e in enumerate(edges):
        node = 1 + e % max(n - 1, 1) if n > 1 else 0
        if node:
            deps[node].append((e // 7 + j) % node)
    ids = np.random.RandomState(len(edges)).permutation(1000)[:n]
    nodes = [_StubNode(int(ids[i]), [int(ids[d]) for d in deps[i]]) for i in range(n)]
    assert [x.id for x in rewrite._cluster(nodes)] == [x.id for x in jrewrite._cluster(nodes)]


# ---------------------------------------------------------------------------
# C6: a node the pass retired is no consumer (the named difference from JAX)
# ---------------------------------------------------------------------------


def _dead_consumer(anp, arr, n):
    """MZ501 retires ``matvec``; its operand ``a`` feeds a live call too."""
    x = arr(np.linspace(0.1, 1.0, n, dtype=np.float32))
    dm = arr(np.ones((4, n), np.float32))

    def f():
        a = anp.exp(x)
        anp.matvec(dm, a)                # dead: retired before planning
        return (anp.multiply(a, 2.0),)
    return f


def _c6_cases():
    bs = _data("black_scholes")
    n = 4096
    return {
        "black_scholes": (
            lambda: CASES["black_scholes"][0](**{k: jnp.asarray(v) for k, v in bs.items()}),
            lambda: CASES["black_scholes"][1](
                **{k: torch.from_numpy(v.copy()) for k, v in bs.items()})),
        "smoke_rewrite": (_smoke_rewrite_chain(janp, jnp.asarray, n, 8),
                          _smoke_rewrite_chain(tanp, torch.from_numpy, n, 8)),
        "dead_consumer": (_dead_consumer(janp, jnp.asarray, n),
                          _dead_consumer(tanp, torch.from_numpy, n)),
    }


def _escaping_run(side, fn, executor, monkeypatch, **kw):
    """Run one capture; returns (escaping outputs over the plan's stages,
    interior bytes, outputs as numpy)."""
    if side == "jax":
        from repro.core import plan_cache as mod
        session = lambda: jmozart.session(executor=JAX_OF.get(executor, executor), **kw)
        value = np.asarray
    else:
        from repro_torch.core import runtime as mod
        session = lambda: tmozart.session(executor=executor, device="cpu", **kw)
        value = lambda o: o.value.numpy()
    seen = []
    real = mod.lookup_or_plan

    def recording(pending, graph, ctx):
        stages, entry = real(pending, graph, ctx)
        seen.append(sum(len(s.escaping) for s in stages))
        return stages, entry
    monkeypatch.setattr(mod, "lookup_or_plan", recording)
    with session() as ctx:
        outs = [value(o) for o in as_tuple(fn())]
    monkeypatch.setattr(mod, "lookup_or_plan", real)
    return sum(seen), ctx.counters.bytes_interior(), outs


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("executor", ["fused", "cuda"])
@pytest.mark.parametrize("case", ["black_scholes", "smoke_rewrite", "dead_consumer"])
def test_c6_escaping_sets_and_bytes_against_jax_as_named(case, executor, monkeypatch):
    """With the pass on, a retired node keeps nothing escaping in the port;
    the reference's plans differ exactly where ``C6_DIFFERENCES`` says
    (Black-Scholes: the CSE'd operand; ``dead_consumer``: the operand of
    the retired ``matvec``), with ``smoke/rewrite`` equal; outputs equal to
    JAX's and to the port's own ``rewrite=False`` run."""
    jfn, tfn = _c6_cases()[case]
    batch = CASES["black_scholes"][2] if case == "black_scholes" else 1024
    kw = dict(batch_elements=batch, handoff=False, plan_cache=False, autotune=False)
    jpc.clear()
    jesc, jbytes, jout = _escaping_run("jax", jfn, executor, monkeypatch, **kw)
    tesc, tbytes, tout = _escaping_run("port", tfn, executor, monkeypatch, **kw)
    assert_counts_as_named(case, {"escaping": tesc}, {"escaping": jesc})
    if executor == "fused":
        assert_counts_as_named(f"{case}/handoff_off", {"bytes_interior": tbytes},
                               {"bytes_interior": jbytes})
    if case == "smoke_rewrite":
        assert tesc == jesc
    else:
        assert tesc < jesc
    _off_esc, _off_bytes, off = _escaping_run("port", tfn, executor, monkeypatch,
                                              rewrite=False, **kw)
    for i, (g, w, o) in enumerate(zip(tout, jout, off)):
        close(g, w, **(_tol(case, i) if case in CASES else {}))
        assert np.array_equal(g, o), (case, i)


def test_c6_black_scholes_kernel_program_writes_two_outputs():
    """On ``cuda`` (the plain version on the CPU) the lowered Black-Scholes
    program escapes only call and put: 28 B/element, as with the pass off."""
    from repro_torch.core import cuda_exec
    jfn, tfn, batch = CASES["black_scholes"]
    data = _data("black_scholes")
    programs = []
    real = cuda_exec.lower_stage

    def recording(stage, *a, **kw):
        program, kinds = real(stage, *a, **kw)
        programs.append((len(program.outputs), program.n_split, len(program.code)))
        return program, kinds
    for on in (True, False):
        tpc.clear()
        programs.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cuda_exec, "lower_stage", recording)
            with tmozart.session(executor="cuda", device="cpu", batch_elements=batch,
                                 rewrite=on) as ctx:
                outs = [o.value.numpy() for o in
                        tfn(**{k: torch.from_numpy(v.copy()) for k, v in data.items()})]
        assert ctx.stats["cuda_stages"] == 1 and ctx.stats["cuda_fallback_stages"] == 0
        (outputs, inputs, instructions), = programs
        assert (outputs, inputs, instructions) == (2, 5, 31 if on else 32), on
        assert 4 * (outputs + inputs) == 28
        if on:
            on_outs = outs
    for g, w in zip(on_outs, outs):
        assert np.array_equal(g, w)


def test_c6_retired_alias_future_reads_the_survivor():
    """A Future of the CSE-retired duplicate still reads the survivor's
    value, and only while it lives does the survivor escape."""
    from repro_torch.core import runtime as truntime
    x = torch.linspace(0.1, 1.0, 96)
    plans = []
    real = truntime.lookup_or_plan

    def recording(pending, graph, ctx):
        stages, entry = real(pending, graph, ctx)
        plans.append({n.fn.name: n.id in s.escaping for s in stages for n in s.nodes})
        return stages, entry
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(truntime, "lookup_or_plan", recording)
        with tmozart.session(executor="fused", device="cpu", batch_elements=32,
                             plan_cache=False) as ctx:
            b1 = tanp.exp(x)
            b2 = tanp.exp(x)                 # retired by MZ502; its Future lives
            s = tanp.add(b1, b1)
            del b1
            got_s = s.value.numpy()
            got_b2 = b2.value.numpy()
        with tmozart.session(executor="fused", device="cpu", batch_elements=32,
                             plan_cache=False):
            s2 = tanp.add(tanp.exp(x), tanp.exp(x))
            got_s2 = s2.value.numpy()
    assert [r.code for r in ctx._last_rewrites].count("MZ502") == 1
    np.testing.assert_allclose(got_b2, np.exp(x.numpy()), rtol=TOL)
    np.testing.assert_allclose(got_s, 2 * np.exp(x.numpy()), rtol=TOL)
    np.testing.assert_allclose(got_s2, got_s, rtol=TOL)
    assert plans[0] == {"exp": True, "add": True}     # the alias is alive
    assert plans[1] == {"exp": False, "add": True}    # nothing keeps exp escaping
