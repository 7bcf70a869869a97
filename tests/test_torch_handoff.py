"""Cross-stage chunk handoff in the port, held against the JAX package.

The counterparts of ``tests/test_handoff.py``: the ``can_handoff`` /
``rechunk`` protocol; handoff on == handoff off over its ``SURFACES`` on
every port executor; ``StageHandoff`` decisions equal to JAX's ``analyze``
on the same pipelines; boundary traffic (interior and terminal bytes equal
to JAX's); ConcatSplit conversions; zero-chunk streams; and the donation
veto.  The JAX side runs with ``plan_cache=False, autotune=False``, the
rewrite pass on as the port's, and the port's ``handoff`` and
``batch_elements`` (without a plan cache both analyze afresh on every
evaluation).

Where torch and XLA differ the port's value is asserted with the reason:
a chunk inside one source chunk is a view in torch (``rechunk`` copies 0
bytes where JAX slices by copy), and nothing is copied before a donation
(``donation_copies`` stays 0: annotated functions return fresh tensors, so
a live Future's buffers are simply kept).  Tolerances: float32 rtol 2e-5,
atol 1e-6, as the reference's differential test.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import annotated_numpy as janp
from repro.core import handoff as jhandoff
from repro.core import mozart as jmozart
from repro.core import split_types as jst
from repro.core import splittable as jsplittable
from repro.core import stage_exec as jse
from repro_torch.core import annotated_numpy as tanp
from repro_torch.core import handoff as thandoff
from repro_torch.core import mozart as tmozart
from repro_torch.core import split_types as tst
from repro_torch.core import splittable as tsplittable
from repro_torch.core import stage_exec as tse
from repro_torch.core.stage_exec import ChunkStream

JAX_CFG = dict(plan_cache=False, autotune=False)
#: the port side of a comparison runs as the JAX side does: no plan cache
#: and no tuner, so the counters compare like with like.
PORT_CFG = dict(plan_cache=False, autotune=False)


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    """Each test starts with an empty port plan cache, as tests/conftest.py
    empties the JAX package's: no test replays a plan another left."""
    from repro_torch.core import plan_cache
    plan_cache.clear()
    yield
EXECUTORS = ["eager", "pipelined", "fused", "scan", "cuda"]
JAX_OF = {"cuda": "pallas"}

JAXNS = types.SimpleNamespace(
    anp=janp, mozart=jmozart, arr=jnp.asarray, np=lambda v: np.asarray(v),
    session=lambda **kw: jmozart.session(**JAX_CFG, **kw), st=jst,
    splittable=jsplittable)
PORTNS = types.SimpleNamespace(
    anp=tanp, mozart=tmozart, arr=lambda a: torch.from_numpy(np.array(a)),
    np=lambda v: (v.value if hasattr(v, "_node") else v).numpy(),
    session=lambda **kw: tmozart.session(device="cpu", **PORT_CFG, **kw), st=tst,
    splittable=tsplittable)


def _ranges(n, b):
    return [(s, min(s + b, n)) for s in range(0, n, b)]


def _stats(ctx, *keys):
    return {k: ctx.stats.get(k, 0) for k in keys}


# ---------------------------------------------------------------------------
# The SplitType handoff protocol
# ---------------------------------------------------------------------------

PAIRS = {
    "array_same_grid": (lambda m: m.ArraySplit((100,), 0), lambda m: m.ArraySplit((100,), 0)),
    "array_axis_mismatch": (lambda m: m.ArraySplit((8, 8), 0), lambda m: m.ArraySplit((8, 8), 1)),
    "array_shape_mismatch": (lambda m: m.ArraySplit((100,), 0), lambda m: m.ArraySplit((99,), 0)),
    "array_to_broadcast": (lambda m: m.ArraySplit((100,), 0), lambda m: m.BROADCAST),
    "array_to_reduce": (lambda m: m.ArraySplit((100,), 0), lambda m: m.ReduceSplit("add")),
    "array_to_concat": (lambda m: m.ArraySplit((100,), 0), lambda m: m.ConcatSplit("t", 0)),
    "broadcast_to_array": (lambda m: m.BROADCAST, lambda m: m.ArraySplit((100,), 0)),
    "reduce_to_array": (lambda m: m.ReduceSplit("add"), lambda m: m.ArraySplit((100,), 0)),
    "unknown_to_array": (lambda m: m.UnknownSplit(), lambda m: m.ArraySplit((100,), 0)),
    "pytree_same": (lambda m: m.PytreeSplit("td", 10, 0), lambda m: m.PytreeSplit("td", 10, 0)),
    "pytree_length": (lambda m: m.PytreeSplit("td", 10, 0), lambda m: m.PytreeSplit("td", 11, 0)),
    "pytree_to_array": (lambda m: m.PytreeSplit("td", 10, 0), lambda m: m.ArraySplit((10,), 0)),
    "concat_to_array": (lambda m: m.ConcatSplit("t", 0), lambda m: m.ArraySplit((64,), 0)),
    "concat_axis_mismatch": (lambda m: m.ConcatSplit("t", 0), lambda m: m.ArraySplit((8, 8), 1)),
    "concat_to_scalar_geometry": (lambda m: m.ConcatSplit("t", 0), lambda m: m.ArraySplit((), 0)),
    "concat_to_concat": (lambda m: m.ConcatSplit("t", 0), lambda m: m.ConcatSplit("t", 0)),
    "concat_axis1_to_array": (lambda m: m.ConcatSplit("t", 1), lambda m: m.ArraySplit((64,), 0)),
    "concat_to_pytree": (lambda m: m.ConcatSplit("t", 0), lambda m: m.PytreeSplit("t", 64, 0)),
    "concat_to_pytree_axis1": (lambda m: m.ConcatSplit("t", 0), lambda m: m.PytreeSplit("t", 64, 1)),
}


class TestCanHandoff:
    @pytest.mark.parametrize("pair", sorted(PAIRS))
    def test_equals_jax(self, pair):
        prod, cons = PAIRS[pair]
        assert prod(tst).can_handoff(cons(tst)) == prod(jst).can_handoff(cons(jst))

    def test_expected_verdicts(self):
        yes = {k for k, (p, c) in PAIRS.items() if p(tst).can_handoff(c(tst))}
        assert yes == {"array_same_grid", "pytree_same", "concat_to_array",
                       "concat_to_pytree"}


class TestRechunk:
    @pytest.mark.parametrize("src_b,dst_b", [(4, 4), (4, 8), (8, 4), (10, 4), (4, 10)])
    def test_round_trips_any_grids(self, src_b, dst_b):
        n = 20
        t, jt = tst.ArraySplit((n,), 0), jst.ArraySplit((n,), 0)
        x = torch.arange(n, dtype=torch.float32)
        src, dst = _ranges(n, src_b), _ranges(n, dst_b)
        out, copied = t.rechunk([t.split(x, s, e) for s, e in src], src, dst)
        jx = jnp.arange(n, dtype=jnp.float32)
        jout, jcopied = jt.rechunk([jt.split(jx, s, e) for s, e in src], src, dst)
        assert [tuple(o.shape) for o in out] == [tuple(o.shape) for o in jout]
        np.testing.assert_array_equal(t.merge(out).numpy(), np.asarray(jt.merge(jout)))
        if src_b == dst_b:
            assert copied == jcopied == 0          # identical grids: pass-through
        elif src_b % dst_b == 0:
            # refining: every piece is inside one source chunk, a view in
            # torch (JAX's slice is a copy)
            assert copied == 0 < jcopied
        else:
            assert 0 < copied <= jcopied <= x.nbytes

    def test_identity_passthrough_by_reference(self):
        n, b = 16, 4
        t = tst.ArraySplit((n,), 0)
        chunks = [t.split(torch.arange(n, dtype=torch.float32), s, e) for s, e in _ranges(n, b)]
        out, copied = t.rechunk(chunks, _ranges(n, b), _ranges(n, b))
        assert copied == 0
        assert all(o is c for o, c in zip(out, chunks))

    def test_refined_pieces_are_views(self):
        t = tst.ArraySplit((16,), 0)
        x = torch.arange(16, dtype=torch.float32)
        out, copied = t.rechunk([x], [(0, 16)], _ranges(16, 4))
        assert copied == 0
        assert all(o.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
                   for o in out)

    def test_coarsen_costs_one_copy_like_jax(self):
        n, src_b, dst_b = 64, 8, 16
        t, jt = tst.ArraySplit((n,), 0), jst.ArraySplit((n,), 0)
        x = torch.arange(n, dtype=torch.float32)
        out, copied = t.rechunk([t.split(x, s, e) for s, e in _ranges(n, src_b)],
                                _ranges(n, src_b), _ranges(n, dst_b))
        jx = jnp.arange(n, dtype=jnp.float32)
        _j, jcopied = jt.rechunk([jt.split(jx, s, e) for s, e in _ranges(n, src_b)],
                                 _ranges(n, src_b), _ranges(n, dst_b))
        assert copied == jcopied == x.nbytes     # merge + re-split pays two
        torch.testing.assert_close(t.merge(out), x)

    @pytest.mark.parametrize("n,src_b,dst_b", [(96, 7, 5), (31, 3, 31), (50, 49, 2),
                                               (64, 13, 64), (1, 1, 1), (17, 5, 3)])
    def test_any_grid_pair_at_most_one_copy(self, n, src_b, dst_b):
        t = tst.ArraySplit((n,), 0)
        x = torch.arange(n, dtype=torch.float32)
        src, dst = _ranges(n, src_b), _ranges(n, dst_b)
        out, copied = t.rechunk([t.split(x, s, e) for s, e in src], src, dst)
        assert len(out) == len(dst) and copied <= x.nbytes
        torch.testing.assert_close(t.merge(out), x)

    def test_pytree_split_rechunk(self):
        n = 12
        leaves = {"a": torch.arange(n, dtype=torch.float32), "b": torch.ones(n, 2)}
        t = tst.PytreeSplit("td", n, 0)
        out, copied = t.rechunk([t.split(leaves, s, e) for s, e in _ranges(n, 3)],
                                _ranges(n, 3), _ranges(n, 6))
        merged = t.merge(out)
        torch.testing.assert_close(merged["a"], leaves["a"])
        torch.testing.assert_close(merged["b"], leaves["b"])
        assert copied == n * 4 + n * 2 * 4


# ---------------------------------------------------------------------------
# Differential: handoff on == handoff off, on every port executor
# ---------------------------------------------------------------------------


def _eval_chain(ns, x, evals=3):
    cur = x
    for _ in range(evals):
        cur = ns.anp.multiply(ns.anp.add(cur, 1.0), 0.5)
        ns.mozart.evaluate()
    return cur


def _reduce_edge(ns, x):
    s = ns.anp.sum(ns.anp.exp(x))
    ns.mozart.evaluate()
    return ns.anp.multiply(x, s)


def _axis_mismatch(ns, m):
    a = ns.anp.normalize_axis(m, axis=1)
    ns.mozart.evaluate()
    return ns.anp.normalize_axis(a, axis=0)


SURFACES = {
    "element_chain": (lambda: np.linspace(0., 1., 10_000, dtype=np.float32), _eval_chain, 2048),
    "reduce_edge": (lambda: np.linspace(0., 1., 10_000, dtype=np.float32), _reduce_edge, 2048),
    "axis_mismatch": (lambda: np.arange(64 * 32, dtype=np.float32).reshape(64, 32),
                      _axis_mismatch, 2048),
    "empty": (lambda: np.zeros((0,), np.float32), _eval_chain, 2048),
    "odd_size": (lambda: np.linspace(0., 1., 17, dtype=np.float32),
                 lambda ns, x: _eval_chain(ns, x, evals=2), 4),
}


def _surface(ns, surface, executor, handoff):
    make, fn, batch = SURFACES[surface]
    with ns.session(executor=executor, handoff=handoff, batch_elements=batch) as ctx:
        out = ns.np(fn(ns, ns.arr(make())))
    return out, ctx


STREAM_KEYS = ("streamed_outputs", "stream_ingests", "stream_materialized",
               "handoff_rechunks", "chunks", "calls", "stages", "donated_chunks")


@pytest.mark.parametrize("surface", sorted(SURFACES))
@pytest.mark.parametrize("executor", EXECUTORS)
def test_differential_handoff_on_off(executor, surface):
    on, on_ctx = _surface(PORTNS, surface, executor, True)
    off, off_ctx = _surface(PORTNS, surface, executor, False)
    np.testing.assert_allclose(on, off, rtol=2e-5, atol=1e-6)
    assert off_ctx.stats.get("streamed_outputs", 0) == 0
    assert off_ctx.stats.get("stream_ingests", 0) == 0
    # and the JAX executor on the same surface, handoff on.  (After the
    # first normalize of "axis_mismatch" every row is the same, so the
    # second divides float noise by ~1e-9: its values are compared on/off
    # within one package only, as the reference's test does.)
    jon, j_ctx = _surface(JAXNS, surface, JAX_OF.get(executor, executor), True)
    if surface != "axis_mismatch":
        np.testing.assert_allclose(on, jon, rtol=2e-5, atol=1e-6)
    assert _stats(on_ctx, *STREAM_KEYS) == _stats(j_ctx, *STREAM_KEYS)
    if surface == "axis_mismatch" and executor in ("fused", "cuda"):
        # The second stage is the last use of a cross-evaluation value, a
        # donation point.  JAX's fused driver slices a donated whole-range
        # input by copy (a donated buffer must not alias the producer's
        # result) and counts it as a re-split; torch donates no buffer, so
        # the port passes the value through and counts nothing.
        assert j_ctx.counters.bytes_interior() == 64 * 32 * 4
        assert on_ctx.counters.bytes_interior() == 0
    else:
        assert on_ctx.counters.bytes_interior() == j_ctx.counters.bytes_interior()
    assert on_ctx.counters.bytes_terminal() == j_ctx.counters.bytes_terminal()


def _tree_step_fns():
    def tree_step(s):
        return {"p": s["p"] * 0.5 + 1.0, "m": s["m"] + s["p"][:, None]}
    return (jsplittable(s=jst.Pytree(0), ret=jst.Pytree(0))(tree_step),
            tsplittable(s=tst.Pytree(0), ret=tst.Pytree(0))(tree_step))


def test_pytree_split_streams_end_to_end():
    """PytreeSplit outputs hand off like arrays across evaluation
    boundaries; batch sizing reads the stream's aval."""
    jstep, tstep = _tree_step_fns()
    n = 4096
    state = {"p": np.arange(n, dtype=np.float32), "m": np.ones((n, 2), np.float32)}
    outs = {}
    for handoff in (True, False):
        with tmozart.session(executor="fused", device="cpu", **PORT_CFG, batch_elements=512,
                             handoff=handoff) as ctx:
            cur = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
            for _ in range(3):
                cur = tstep(cur)
                tmozart.evaluate()
            outs[handoff] = ({k: v.numpy() for k, v in cur.value.items()}, ctx)
    with jmozart.session(executor="fused", batch_elements=512, handoff=True,
                         **JAX_CFG) as jctx:
        cur = {k: jnp.asarray(v) for k, v in state.items()}
        for _ in range(3):
            cur = jstep(cur)
            jmozart.evaluate()
        jout = jax.tree_util.tree_map(np.asarray, cur.value)
    ctx = outs[True][1]
    assert ctx.stats["streamed_outputs"] == jctx.stats["streamed_outputs"] == 3
    assert ctx.stats["stream_ingests"] == jctx.stats["stream_ingests"] == 2
    for k in ("p", "m"):
        np.testing.assert_allclose(outs[True][0][k], outs[False][0][k], rtol=1e-6)
        np.testing.assert_allclose(outs[True][0][k], jout[k], rtol=1e-6)


# ---------------------------------------------------------------------------
# StageHandoff decisions equal JAX's analyze on the same pipelines
# ---------------------------------------------------------------------------


def _repeat2_fns():
    def repeat2(x):
        return x.repeat_interleave(2) if isinstance(x, torch.Tensor) else jnp.repeat(x, 2)
    return (jsplittable(x=jst.Along(0), ret=jst.Concat("rep2", 0))(repeat2),
            tsplittable(x=tst.Along(0), ret=tst.Concat("rep2", 0))(repeat2))


_REPEAT2 = _repeat2_fns()


def _pipe_chain(ns, x, hold):
    a = ns.anp.add(x, 1.0)
    b = ns.anp.multiply(a, 0.5)
    out = ns.anp.exp(b)
    return (out, a) if hold else (out,)


def _pipe_two_stage(ns, x, hold):
    a = ns.anp.exp(x)
    s = ns.anp.sum(a)
    return ns.anp.multiply(a, s), s


def _pipe_concat(ns, x, hold):
    rep = _REPEAT2[0] if ns is JAXNS else _REPEAT2[1]
    return (ns.anp.multiply(ns.anp.add(rep(x), 1.0), 0.5),)


def _pipe_axis(ns, x, hold):
    m = x.reshape(100, 80)
    return (ns.anp.normalize_axis(ns.anp.normalize_axis(m, axis=1), axis=0),)


PIPELINES = {"chain": _pipe_chain, "two_stage": _pipe_two_stage,
             "concat": _pipe_concat, "axis": _pipe_axis}


def _decisions(ns, name, hold, pipeline):
    x = np.linspace(0., 1., 8000, dtype=np.float32)
    handoff_mod = jhandoff if ns is JAXNS else thandoff
    with ns.session(executor="fused", batch_elements=1000, pipeline=pipeline) as ctx:
        outs = PIPELINES[name](ns, ns.arr(x), hold)
        stages = ctx.last_plan()
        dec = {s.id: ho.to_json() for s, ho in (
            (s, handoff_mod.analyze(stages, "fused").get(s.id)) for s in stages) if ho}
        shape = [len(s.nodes) for s in stages]
        fresh = handoff_mod.decisions_fresh(handoff_mod.analyze(stages, "fused"), stages)
        del outs
    return dec, shape, fresh


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("hold", [False, True])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_stage_handoff_equals_jax_analyze(name, hold, pipeline):
    mine = _decisions(PORTNS, name, hold, pipeline)
    theirs = _decisions(JAXNS, name, hold, pipeline)
    assert mine == theirs
    assert mine[2] is True


def test_stage_handoff_json_round_trip():
    ho = thandoff.StageHandoff(frozenset({0, 2}), frozenset({1}), frozenset({1}),
                               frozenset({1}), frozenset(), frozenset({3}))
    assert thandoff.StageHandoff.from_json(ho.to_json()) == ho
    assert ho.to_json() == jhandoff.StageHandoff(
        ho.stream_out, ho.stream_in, ho.last_use, ho.convert_in, ho.shard_in,
        ho.vetoed).to_json()


def test_handoff_false_resolves_no_decisions():
    ctx = types.SimpleNamespace(handoff=False, executor="fused")
    assert thandoff.resolve_decisions(ctx, None, []) is None


def test_edge_fallback_reasons_equal_jax():
    cases = [(lambda m: m.ArraySplit((8, 8), 0), lambda m: m.ArraySplit((8, 8), 1), None),
             (lambda m: m.ArraySplit((100,), 0), lambda m: m.BROADCAST, None),
             (lambda m: m.ReduceSplit("add"), lambda m: m.ArraySplit((100,), 0), None),
             (lambda m: m.ArraySplit((100,), 0), lambda m: m.ArraySplit((100,), 0), 50),
             (lambda m: m.ArraySplit((100,), 0), lambda m: m.ArraySplit((100,), 0), None)]
    for p, c, count in cases:
        assert thandoff.edge_fallback_reason(p(tst), c(tst), count) == \
            jhandoff.edge_fallback_reason(p(jst), c(jst), count)


# ---------------------------------------------------------------------------
# Boundary traffic: interior boundaries drop to zero, bytes equal JAX's
# ---------------------------------------------------------------------------


class TestBoundaryTraffic:
    N, BATCH = 50_000, 8192

    def _run(self, ns, handoff, observe=True, executor="fused", **kw):
        x = np.linspace(0., 1., self.N, dtype=np.float32)
        with ns.session(executor=executor, batch_elements=self.BATCH, handoff=handoff,
                        **kw) as ctx:
            cur = _eval_chain(ns, ns.arr(x))
            out = ns.np(cur) if observe else None
        return out, ctx

    def _both(self, *args, **kw):
        out, ctx = self._run(PORTNS, *args, **kw)
        jout, jctx = self._run(JAXNS, *args, **kw)
        assert ctx.counters.bytes_interior() == jctx.counters.bytes_interior()
        assert ctx.counters.bytes_terminal() == jctx.counters.bytes_terminal()
        return out, ctx, jout

    def test_interior_boundaries_zero_bytes(self):
        final_bytes = self.N * 4
        out, ctx, jout = self._both(True)
        assert ctx.counters.bytes_interior() == 0
        assert ctx.counters.bytes_terminal() == final_bytes  # only the observed output
        assert ctx.stats["streamed_outputs"] == 3
        assert ctx.stats["stream_ingests"] == 2
        off, off_ctx, _j = self._both(False)
        # merge-everything pays >= (3 merges + 2 re-splits) x n bytes
        assert off_ctx.counters.bytes_materialized() >= 5 * final_bytes
        np.testing.assert_allclose(out, off, rtol=2e-5)
        np.testing.assert_allclose(out, jout, rtol=2e-5)

    def test_unobserved_output_never_materializes(self):
        _o, ctx, _j = self._both(True, observe=False)
        assert ctx.counters.bytes_materialized() == 0

    def test_pipe_ablation_streams_interior(self):
        """pipeline=False makes every op its own stage; handoff removes the
        per-boundary round trips inside one evaluation."""
        x = np.linspace(0., 1., self.N, dtype=np.float32)

        def once(ns, handoff):
            with ns.session(executor="fused", batch_elements=self.BATCH,
                            pipeline=False, handoff=handoff) as ctx:
                out = ns.np(ns.anp.multiply(ns.anp.exp(ns.anp.add(ns.arr(x), 1.0)), 0.5))
            return out, ctx
        on, ctx = once(PORTNS, True)
        _jon, jctx = once(JAXNS, True)
        assert ctx.stats["streamed_outputs"] == jctx.stats["streamed_outputs"] >= 2
        assert ctx.counters.bytes_materialized() == jctx.counters.bytes_materialized() \
            == self.N * 4
        off, off_ctx = once(PORTNS, False)
        _joff, joff_ctx = once(JAXNS, False)
        assert off_ctx.counters.bytes_materialized() == \
            joff_ctx.counters.bytes_materialized() >= 5 * self.N * 4
        np.testing.assert_allclose(on, off, rtol=2e-5)

    @pytest.mark.parametrize("consumer", ["eager", "scan"])
    def test_consumer_of_a_fused_stream(self, consumer):
        """A stream handed to ``eager`` (stream-incapable) merges on ingest,
        with a fallback event; ``scan`` ingests it without a merge."""
        x = np.linspace(0., 1., self.N, dtype=np.float32)

        def once(ns):
            with ns.session(executor="fused", batch_elements=self.BATCH) as ctx:
                a = ns.anp.multiply(ns.anp.add(ns.arr(x), 1.0), 0.5)
                ns.mozart.evaluate()
                streamed = type(ctx.graph.nodes[a._node.id].result).__name__
                ns.mozart.configure(executor=consumer)
                out = ns.np(ns.anp.exp(a))
            return out, ctx, streamed
        out, ctx, streamed = once(PORTNS)
        jout, jctx, _js = once(JAXNS)
        assert streamed == "ChunkStream"
        keys = ("stream_materialized", "stream_ingests")
        assert _stats(ctx, *keys) == _stats(jctx, *keys)
        if consumer == "eager":
            assert ctx.stats["stream_materialized"] == 1
            kinds = [k for k, _w, _n in ctx.counters.materialize_events()]
            assert "interior:fallback" in kinds
        else:
            assert ctx.stats["stream_ingests"] == 1
            assert ctx.stats.get("stream_materialized", 0) == 0
        want = np.exp((x + 1) * 0.5)
        np.testing.assert_allclose(out, want, rtol=2e-5)
        np.testing.assert_allclose(out, jout, rtol=2e-5)

    def test_event_trail_names_the_boundary(self):
        _o, ctx, _j = self._both(False)
        kinds = {k.split(":")[1] for k, _w, _n in ctx.counters.materialize_events()}
        assert {"merge", "resplit"} <= kinds
        assert all(w for _k, w, _n in ctx.counters.materialize_events())

    def test_global_aggregate_and_reset(self):
        tse.reset_materialized()
        _o, ctx = self._run(PORTNS, True)
        assert tse.bytes_terminal() == ctx.counters.bytes_terminal() == self.N * 4
        assert tse.bytes_interior() == 0
        assert tse.materialize_events()
        tse.reset_materialized()
        assert tse.bytes_materialized() == 0 and not tse.materialize_events()
        assert ctx.counters.bytes_terminal() == self.N * 4   # scoped view untouched


# ---------------------------------------------------------------------------
# ConcatSplit -> ArraySplit / PytreeSplit handoff (fresh-output producers)
# ---------------------------------------------------------------------------


class TestConcatHandoff:
    N, BATCH = 10_000, 2048

    def _run(self, ns, handoff):
        rep = _REPEAT2[0] if ns is JAXNS else _REPEAT2[1]
        x = np.linspace(0., 1., self.N, dtype=np.float32)
        with ns.session(executor="fused", batch_elements=self.BATCH, handoff=handoff) as ctx:
            y = rep(ns.arr(x))
            out = ns.np(ns.anp.multiply(ns.anp.add(y, 1.0), 0.5))
        return out, ctx

    def test_concat_producer_hands_off_to_array_consumer(self):
        out, ctx = self._run(PORTNS, True)
        jout, jctx = self._run(JAXNS, True)
        keys = ("stream_converted", "stream_ingests", "streamed_outputs")
        assert _stats(ctx, *keys) == _stats(jctx, *keys) == \
            {"stream_converted": 1, "stream_ingests": 1, "streamed_outputs": 2}
        assert ctx.counters.bytes_interior() == jctx.counters.bytes_interior() == 0
        off, _c = self._run(PORTNS, False)
        np.testing.assert_allclose(out, off, rtol=1e-6)
        np.testing.assert_allclose(out, jout, rtol=1e-6)

    def test_total_mismatch_materializes(self):
        t = tst.ConcatSplit("t", 0)
        s = ChunkStream([torch.ones(3), torch.ones(4)], [(0, 2), (2, 4)], t,
                        torch.empty(7, device="meta"))
        good = tse.adapt_stream(s, tst.ArraySplit((7,), 0))
        assert good is not None and good.ranges == [(0, 3), (3, 7)]
        assert good._chunks == s._chunks or all(
            a is b for a, b in zip(good._chunks, s._chunks))
        assert tse.adapt_stream(s, tst.ArraySplit((8,), 0)) is None

    def test_concat_producer_hands_off_to_pytree_consumer(self):
        def tree_repeat2(x):
            y = x.repeat_interleave(2) if isinstance(x, torch.Tensor) else jnp.repeat(x, 2)
            stack = torch.stack if isinstance(x, torch.Tensor) else jnp.stack
            return {"p": y, "m": stack([y, y * 2.0], 1)}

        def tree_scale(s):
            return {"p": (s["p"] + 1.0) * 0.5, "m": s["m"] * 2.0}

        fns = {id(JAXNS): (jsplittable(x=jst.Along(0), ret=jst.Concat("trep2", 0))(tree_repeat2),
                           jsplittable(s=jst.Pytree(0), ret=jst.Pytree(0))(tree_scale)),
               id(PORTNS): (tsplittable(x=tst.Along(0), ret=tst.Concat("trep2", 0))(tree_repeat2),
                            tsplittable(s=tst.Pytree(0), ret=tst.Pytree(0))(tree_scale))}
        x = np.linspace(0., 1., self.N, dtype=np.float32)

        def run(ns, handoff):
            rep, scale = fns[id(ns)]
            with ns.session(executor="fused", batch_elements=self.BATCH,
                            handoff=handoff) as ctx:
                v = scale(rep(ns.arr(x))).value
            return {k: np.asarray(v[k]) if ns is JAXNS else v[k].numpy() for k in v}, ctx

        out, ctx = run(PORTNS, True)
        jout, jctx = run(JAXNS, True)
        assert ctx.stats["stream_converted"] == jctx.stats["stream_converted"] == 1
        assert ctx.counters.bytes_interior() == jctx.counters.bytes_interior() == 0
        off, _c = run(PORTNS, False)
        for k in ("p", "m"):
            np.testing.assert_allclose(out[k], off[k], rtol=1e-6)
            np.testing.assert_allclose(out[k], jout[k], rtol=1e-6)

    def test_pytree_leaf_extent_mismatch_materializes(self):
        t = tst.ConcatSplit("t", 0)
        meta = {"a": torch.empty(7, device="meta"), "b": torch.empty(7, 2, device="meta")}
        good = [{"a": torch.ones(3), "b": torch.ones(3, 2)},
                {"a": torch.ones(4), "b": torch.ones(4, 2)}]
        s = ChunkStream(good, [(0, 2), (2, 4)], t, meta)
        ok = tse.adapt_stream(s, tst.PytreeSplit("t", 7, 0))
        assert ok is not None and ok.ranges == [(0, 3), (3, 7)]
        bad = [{"a": torch.ones(3), "b": torch.ones(4, 2)}]
        s2 = ChunkStream(bad, [(0, 1)], t, meta)
        assert tse.adapt_stream(s2, tst.PytreeSplit("t", 3, 0)) is None
        assert tse.adapt_stream(s, tst.PytreeSplit("t", 8, 0)) is None

    def test_empty_concat_pieces_stream(self):
        drop_all = tsplittable(x=tst.Along(0), ret=tst.Concat("nil", 0))(lambda x: x[:0])
        x = torch.linspace(0., 1., self.N)
        with tmozart.session(executor="fused", device="cpu", batch_elements=self.BATCH):
            out = tanp.add(drop_all(x), 1.0).value
        assert tuple(out.shape) == (0,)


# ---------------------------------------------------------------------------
# Zero-chunk / empty streams
# ---------------------------------------------------------------------------


class TestZeroChunkStreams:
    AVAL = torch.empty(0, device="meta")

    def test_materialize_zero_chunk_stream(self):
        s = ChunkStream([], [(0, 0)], tst.ArraySplit((0,), 0), self.AVAL)
        out = s.materialize()
        assert tuple(out.shape) == (0,) and out.dtype == torch.float32

    def test_chunk_accessor_zero_chunk_stream(self):
        s = ChunkStream([], [(0, 0)], tst.ArraySplit((0,), 0), self.AVAL)
        assert tuple(s.chunk(0).shape) == (0,)

    def test_rechunk_degenerate_grids(self):
        t = tst.ArraySplit((0,), 0)
        out, copied = t.rechunk([torch.zeros(0)] * 3, [(0, 0)] * 3, [(0, 0)])
        assert len(out) == 1 and tuple(out[0].shape) == (0,) and copied == 0

    @pytest.mark.parametrize("executor", EXECUTORS)
    def test_empty_chain_streams_safely(self, executor):
        with tmozart.session(executor=executor, device="cpu", batch_elements=64):
            out = _eval_chain(PORTNS, torch.zeros(0)).value
        assert tuple(out.shape) == (0,)


# ---------------------------------------------------------------------------
# Donation: plan-time veto, the release of dead streams, the backstop
# ---------------------------------------------------------------------------


class TestDonationVeto:
    N, B = 20_000, 4096
    KEYS = ("donated_chunks", "streamed_outputs", "stream_ingests")

    def _pipe(self, ns, hold):
        x = np.linspace(0., 1., self.N, dtype=np.float32)
        with ns.session(executor="fused", batch_elements=self.B, pipeline=False) as ctx:
            a = ns.anp.add(ns.arr(x), 1.0)          # own stage (pipeline=False)
            if hold:
                out = ns.np(ns.anp.multiply(a, 0.5))   # a's Future held
                a_val = ns.np(a)                       # observed after consumption
            else:
                e = ns.anp.multiply(a, 0.5)
                del a
                out, a_val = ns.np(e), None
        return out, a_val, ctx

    def test_observable_producer_vetoed_at_plan_time(self):
        out, a_val, ctx = self._pipe(PORTNS, hold=True)
        _jo, _ja, jctx = self._pipe(JAXNS, hold=True)
        assert _stats(ctx, *self.KEYS) == _stats(jctx, *self.KEYS)
        assert ctx.stats.get("donated_chunks", 0) == 0
        assert ctx.stats.get("donation_copies", 0) == jctx.stats.get("donation_copies", 0) == 0
        x = np.linspace(0., 1., self.N, dtype=np.float32)
        np.testing.assert_allclose(a_val, x + 1, rtol=1e-6)
        np.testing.assert_allclose(out, (x + 1) * 0.5, rtol=1e-6)

    def test_dead_producer_donates_and_releases(self):
        out, _a, ctx = self._pipe(PORTNS, hold=False)
        _jo, _ja, jctx = self._pipe(JAXNS, hold=False)
        assert _stats(ctx, *self.KEYS) == _stats(jctx, *self.KEYS)
        assert ctx.stats["donated_chunks"] > 0
        x = np.linspace(0., 1., self.N, dtype=np.float32)
        np.testing.assert_allclose(out, (x + 1) * 0.5, rtol=1e-6)

    def test_release_drops_the_buffers(self):
        """The port's donation: after its last consumer, a dead stream
        holds no buffer, and a late merge raises the backstop error."""
        x = torch.linspace(0., 1., self.N)
        with tmozart.session(executor="fused", device="cpu", batch_elements=self.B,
                             pipeline=False) as ctx:
            a = tanp.add(x, 1.0)
            node = a._node
            e = tanp.multiply(a, 0.5)
            del a
            seen = {}
            real_finish = tse.finish_stage

            def spy(stage, partials, ranges=None, ctx=None):
                if any(n.id != node.id for n in stage.nodes):
                    seen["result"] = node.result
                return real_finish(stage, partials, ranges, ctx)
            tse.finish_stage, saved = spy, tse.finish_stage
            import repro_torch.core.executor as ex
            ex.finish_stage, saved_ex = spy, ex.finish_stage
            try:
                e.value
            finally:
                tse.finish_stage, ex.finish_stage = saved, saved_ex
        stream = seen["result"]
        assert isinstance(stream, ChunkStream) and stream.consumed
        assert stream._chunks is None
        with pytest.raises(RuntimeError, match="donated to a driver"):
            stream.materialize()
        assert ctx.stats["donated_chunks"] > 0

    def test_alive_future_keeps_its_buffers(self):
        """A cross-evaluation stream whose producer Future is alive: JAX
        donates defensive copies; the port counts the same donation points
        and copies nothing (``donation_copies`` 0), keeping the stream, which
        is then observed intact."""
        x = np.linspace(0., 1., self.N, dtype=np.float32)

        def once(ns):
            with ns.session(executor="fused", batch_elements=self.B) as ctx:
                a = ns.anp.multiply(ns.anp.add(ns.arr(x), 1.0), 0.5)
                ns.mozart.evaluate()
                out = ns.np(ns.anp.exp(a))      # consumes a's stream
                a_val = ns.np(a)                # a observed AFTER consumption
            return out, a_val, ctx
        out, a_val, ctx = once(PORTNS)
        _jo, _ja, jctx = once(JAXNS)
        assert ctx.stats["donated_chunks"] == jctx.stats["donated_chunks"] > 0
        assert jctx.stats["donation_copies"] == jctx.stats["donated_chunks"]
        assert ctx.stats.get("donation_copies", 0) == 0
        want_a = (x + 1) * 0.5
        np.testing.assert_allclose(a_val, want_a, rtol=2e-5)
        np.testing.assert_allclose(out, np.exp(want_a), rtol=2e-5)

    def test_runtime_backstop_message_pinned(self):
        t = tst.ArraySplit((8,), 0)
        s = ChunkStream([torch.arange(4.), torch.arange(4.)], [(0, 4), (4, 8)], t,
                        torch.empty(8, device="meta"))
        s.release("stage 7 input ('in', 0)")
        with pytest.raises(RuntimeError, match="donated to a driver and can no longer "
                                               "be merged") as ei:
            s.materialize()
        assert "[MZ301]" in str(ei.value)
        assert "stage 7 input ('in', 0)" in str(ei.value)
        assert tse.DONATED_MERGE_ERROR == jse.DONATED_MERGE_ERROR


def test_trace_counter_counts_fx_traces_and_lowerings():
    """``trace_count`` counts each ``torch.fx`` trace of a library function,
    each stage lowering and each driver build not served from a cache: the
    counter a warm-call gate reads.  Without the plan cache every evaluation
    lowers its stages again; with it (the default) the lowering is pinned
    into the plan entry, so a warm evaluation traces and lowers nothing."""
    from repro_torch.core import plan_cache
    double_exp = tsplittable(x=tst.Along(0), ret=tst.Along(0), elementwise=True,
                             name="double_exp")(lambda x: torch.exp(x) * 2.0)
    x = torch.linspace(0.1, 0.9, 64)
    before = tse.trace_count()
    with tmozart.session(executor="cuda", device="cpu", **PORT_CFG) as ctx:
        first = double_exp(x).value
    assert ctx.counters.trace_count() == 2        # one fx trace + one lowering
    with tmozart.session(executor="cuda", device="cpu", **PORT_CFG) as ctx2:
        again = double_exp(x).value
    assert ctx2.counters.trace_count() == 1       # the fx trace is cached
    assert tse.trace_count() - before == 3
    torch.testing.assert_close(first, again)
    plan_cache.clear()
    with tmozart.session(executor="cuda", device="cpu") as ctx4:
        double_exp(x).value
    assert ctx4.counters.trace_count() == 1       # the lowering, pinned
    with tmozart.session(executor="cuda", device="cpu") as ctx5:
        warm = double_exp(x).value
    assert ctx5.stats["plan_cache_hits"] == 1
    assert ctx5.counters.trace_count() == 0       # a warm call lowers nothing
    torch.testing.assert_close(first, warm)
    with tmozart.session(executor="fused", device="cpu", **PORT_CFG) as ctx3:
        double_exp(x).value
    assert ctx3.counters.trace_count() == 1       # the fused driver's build
    plan_cache.clear()


def test_stream_helpers():
    """``compatible``, ``materialize`` and ``materialize_inputs`` on a
    chunk-list stream, as the reference's."""
    t = tst.ArraySplit((8,), 0)
    chunks = [torch.arange(4.), torch.arange(4., 8.)]
    s = ChunkStream(chunks, [(0, 4), (4, 8)], t, torch.empty(8, device="meta"))
    assert s.compatible(tst.ArraySplit((8,), 0))
    assert not s.compatible(tst.ArraySplit((9,), 0))
    assert s.uniform_batch() == 4 and s.n == 8 and tuple(s.shape) == (8,)
    ctx = types.SimpleNamespace(stats={"stream_materialized": 0})
    out = tse.materialize_inputs(None, {"a": s, "b": 3.0}, ctx)
    torch.testing.assert_close(out["a"], torch.arange(8.))
    assert out["b"] == 3.0 and ctx.stats["stream_materialized"] == 1
    assert tse.materialize(s) is out["a"]            # merged once, then cached
    assert tse.materialize(5) == 5
    s.release("stage 0 input ('in', 0)")
    assert not s.compatible(tst.ArraySplit((8,), 0))
