"""The port's plan cache (``repro_torch/core/plan_cache.py``) and tuner
against the JAX package's, on the same numpy inputs.

Quickstart, Black-Scholes, Haversine, the two-stage chain and the
``smoke/handoff`` chain run through both packages with the plan cache on:
both sides with the static rewrite pass on (the default), the JAX side with
``pallas`` where the port uses ``cuda``; the port side on
the CPU, where ``cuda`` runs the kernel's plain version.  Both sides use the
same chip constants (the host model, or the tiny chip that forces tuning).

Equal exactly: the stage templates (positions, the split types of inputs,
outputs and arguments), the counters over a miss, a first hit and later hits
(``planner_calls``, ``plan_cache_hits``/``_misses``/``_uncacheable``,
``autotuned_stages`` on the first hit, ``configure_rekeyed``,
``reanalysis_ticks``), the handoff decisions recorded on the entries and
``candidate_batches``.  Tuned batches depend on wall time and are only
asserted to be pinned and replayed.  Outputs match within float32 2e-5
(sums 1e-4; Haversine also atol 1e-2, as in ``test_torch_executors.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hardware as jhw
from repro.core import annotated_numpy as janp
from repro.core import mozart as jmozart
from repro.core import plan_cache as jpc
from repro.core import splittable as jsplittable
from repro.core import split_types as jst
from repro.core.stage_exec import candidate_batches as jcandidate_batches
from repro_torch import hardware as thw
from repro_torch.core import annotated_numpy as tanp
from repro_torch.core import mozart as tmozart
from repro_torch.core import plan_cache as tpc
from repro_torch.core import splittable as tsplittable
from repro_torch.core import split_types as tst
from repro_torch.core import stage_exec as tse
from repro_torch.kernels import split_pipeline as tsp

from test_torch_executors import CASES, _data, _tol, close

JAX_CFG = dict()
JAX_OF = {"cuda": "pallas"}

#: the same tiny fast memory on both sides: the §5.2 estimate falls below
#: the array, so the tuner has candidates to measure.
JTINY = jhw.Chip(name="tiny_test_chip", peak_bf16_flops=1e11, hbm_bandwidth=2e10,
                 ici_link_bandwidth=1e10, ici_links=1, hbm_bytes=2**30,
                 vmem_bytes=64 * 1024, mozart_c=1.0)
TTINY = thw.Chip(name="tiny_test_chip", peak_bf16_flops=1e11, hbm_bandwidth=2e10,
                 ici_link_bandwidth=1e10, ici_links=1, hbm_bytes=2**30,
                 vmem_bytes=64 * 1024, mozart_c=1.0)

COUNTERS = ("planner_calls", "plan_cache_hits", "plan_cache_misses",
            "plan_cache_uncacheable")


@pytest.fixture(autouse=True)
def _fresh_port_cache():
    tpc.clear()
    yield
    tpc.clear()


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def run_jax(name, executor, chip=None, **kw):
    jfn, _tfn, _batch = CASES[name]
    data = _data(name)
    with jmozart.session(executor=JAX_OF.get(executor, executor),
                         chip=chip or jhw.CPU_HOST, **JAX_CFG, **kw) as ctx:
        outs = _as_tuple(jfn(**{k: jnp.asarray(v) for k, v in data.items()}))
        vals = [np.asarray(o) for o in outs]
    return vals, ctx


def run_port(name, executor, chip=None, **kw):
    _jfn, tfn, _batch = CASES[name]
    data = _data(name)
    with tmozart.session(executor=executor, device="cpu", chip=chip or thw.CPU_HOST,
                         **kw) as ctx:
        outs = _as_tuple(tfn(**{k: torch.from_numpy(v.copy()) for k, v in data.items()}))
        vals = [o.value.numpy() for o in outs]
    return vals, ctx


def _counts(ctx, keys=COUNTERS):
    return {k: ctx.stats.get(k, 0) for k in keys}


def _type_sig(t):
    return (type(t).__name__, t.params)


def _templates(entry):
    return [(list(tm.positions),
             [(desc, _type_sig(t)) for desc, t in tm.inputs],
             sorted((p, _type_sig(t)) for p, t in tm.out_types.items()),
             sorted((k, _type_sig(t)) for k, t in tm.arg_types.items()))
            for tm in entry.stage_templates]


def _handoff_chain(ns, executor, n=20_000, batch=4096, evals=3, **kw):
    """The reference's ``smoke/handoff`` chain: ``evals`` evaluations of
    ``multiply(add(x, 1.0), 0.5)`` with ``mozart.evaluate()`` between."""
    with ns["session"](executor=executor, batch_elements=batch, **kw) as ctx:
        cur = ns["arr"](np.linspace(0.0, 1.0, n, dtype=np.float32))
        for _ in range(evals):
            cur = ns["anp"].multiply(ns["anp"].add(cur, 1.0), 0.5)
            ns["mozart"].evaluate()
        out = ns["np"](cur)
    return out, ctx


JNS = dict(session=lambda **kw: jmozart.session(**JAX_CFG, **kw), anp=janp, mozart=jmozart,
           arr=jnp.asarray, np=np.asarray)
TNS = dict(session=lambda **kw: tmozart.session(device="cpu", **kw), anp=tanp,
           mozart=tmozart, arr=torch.from_numpy, np=lambda f: f.value.numpy())


# ---------------------------------------------------------------------------
# Templates and counters against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_stage_templates_equal_jax(name):
    jvals, _ = run_jax(name, "fused")
    tvals, _ = run_port(name, "fused")
    (je,), (te,) = jpc.entries(), tpc.entries()
    assert _templates(te) == _templates(je)
    assert te.fn_names == je.fn_names
    for i, (g, w) in enumerate(zip(tvals, jvals)):
        close(g, w, **_tol(name, i))


def test_handoff_chain_templates_and_decisions_equal_jax():
    jout, jctx = _handoff_chain(JNS, "fused")
    tout, tctx = _handoff_chain(TNS, "fused")
    close(tout, jout)
    jes, tes = jpc.entries(), tpc.entries()
    assert len(tes) == len(jes) == 2          # first evaluation, then a done input
    for je, te in zip(jes, tes):
        assert _templates(te) == _templates(je)
        assert te.handoff is not None and je.handoff is not None
        assert {s: h.to_json() for s, h in te.handoff.items()} == \
            {s: h.to_json() for s, h in je.handoff.items()}
    assert _counts(tctx) == _counts(jctx)
    assert tctx.stats["plan_cache_hits"] == 1      # the third evaluation hit


@pytest.mark.parametrize("executor", ["fused", "scan", "pipelined", "cuda"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_counters_over_miss_first_hit_and_later_hits_equal_jax(name, executor):
    keys = COUNTERS + (() if executor == "cuda" else ("autotuned_stages",))
    for call in range(4):
        jvals, jctx = run_jax(name, executor)
        tvals, tctx = run_port(name, executor)
        assert _counts(tctx, keys) == _counts(jctx, keys), call
        for i, (g, w) in enumerate(zip(tvals, jvals)):
            close(g, w, **_tol(name, i))
    assert tctx.stats["planner_calls"] == 0 and tctx.stats["plan_cache_hits"] == 1


@pytest.mark.parametrize("executor", ["fused", "scan"])
def test_tiny_chip_tunes_on_the_first_hit_like_jax(executor):
    """With the tiny chip the estimate is below the array: the first hit
    tunes on both sides, later hits replay the pin."""
    for call in range(3):
        _jv, jctx = run_jax("black_scholes", executor, chip=JTINY)
        tv, tctx = run_port("black_scholes", executor, chip=TTINY)
        assert _counts(tctx, COUNTERS + ("autotuned_stages",)) == \
            _counts(jctx, COUNTERS + ("autotuned_stages",)), call
        assert tctx.stats.get("autotuned_stages", 0) == (1 if call == 1 else 0)
    (te,) = tpc.entries()
    pinned = te.tuned_batch[0]
    assert tctx.stats["chunks"] == -(-50_000 // pinned)
    assert len(te.trials[0]) >= 2


def test_uncacheable_pipeline_plans_every_time_like_jax():
    def make(split, anp_):
        @split(x=(jst if split is jsplittable else tst).Along(0),
               ret=(jst if split is jsplittable else tst).Along(0), static=("tags",),
               name="tagged")
        def tagged(x, tags):
            return x * 2.0
        return lambda x: anp_.sum(tagged(x, frozenset({"a"})))

    jfn, tfn = make(jsplittable, janp), make(tsplittable, tanp)
    x = np.linspace(0.0, 1.0, 4096, dtype=np.float32)
    for _ in range(2):
        with jmozart.session(executor="fused", **JAX_CFG) as jctx:
            jv = float(jfn(jnp.asarray(x)))
        with tmozart.session(executor="fused", device="cpu") as tctx:
            tv = float(tfn(torch.from_numpy(x)).value)
        assert _counts(tctx) == _counts(jctx) == {
            "planner_calls": 1, "plan_cache_hits": 0, "plan_cache_misses": 0,
            "plan_cache_uncacheable": 1}
        assert np.isclose(tv, jv, rtol=1e-5)
    assert tpc.cache_info()["entries"] == 0


def test_configure_rekeyed_equal_jax():
    x = np.linspace(0.0, 1.0, 4096, dtype=np.float32)

    def run(ns, arr):
        with ns["session"](executor="fused", batch_elements=512) as ctx:
            a = float(ns["np"](ns["anp"].sum(ns["anp"].exp(arr(x)))))
            ns["mozart"].configure(executor="scan")
            b = float(ns["np"](ns["anp"].sum(ns["anp"].exp(arr(x)))))
        return a, b, ctx

    ja, jb, jctx = run(JNS, jnp.asarray)
    ta, tb, tctx = run(TNS, torch.from_numpy)
    keys = COUNTERS + ("configure_rekeyed",)
    assert _counts(tctx, keys) == _counts(jctx, keys)
    assert tctx.stats["configure_rekeyed"] == 1 and tctx.stats["plan_cache_hits"] == 1
    assert tpc.stats["rekeyed"] == jpc.stats["rekeyed"] == 1
    assert np.isclose(ta, ja, rtol=1e-5) and np.isclose(tb, jb, rtol=1e-5)


def test_reanalysis_ticks_equal_jax(monkeypatch):
    monkeypatch.setenv("MOZART_REANALYZE_EVERY", "2")
    for call in range(6):
        _jv, jctx = run_jax("black_scholes", "fused", batch_elements=8192)
        _tv, tctx = run_port("black_scholes", "fused", batch_elements=8192)
        keys = COUNTERS + ("reanalysis_ticks",)
        assert _counts(tctx, keys) == _counts(jctx, keys), call
    assert tpc.stats["reanalysis_ticks"] == jpc.stats["reanalysis_ticks"] == 2
    (te,) = tpc.entries()
    assert te.handoff is not None          # re-analyzed on the next use


def test_stale_donation_veto_reanalyzes_like_jax():
    """A producer observed on the first call (donation vetoed) and dead on
    later calls: after ``STALE_THRESHOLD`` stale calls the recorded
    decisions re-analyze, on both sides."""
    def pipe(ns, hold):
        x = np.linspace(0., 1., 20_000, dtype=np.float32)
        with ns["session"](executor="fused", batch_elements=4096, pipeline=False) as ctx:
            a = ns["anp"].add(ns["arr"](x), 1.0)
            e = ns["anp"].multiply(a, 0.5)
            if hold:
                out = ns["np"](e)
                ns["np"](a)
            else:
                del a
                out = ns["np"](e)
        return out, ctx

    for hold in (True, False, False, False):
        jout, jctx = pipe(JNS, hold)
        tout, tctx = pipe(TNS, hold)
        keys = COUNTERS + ("handoff_reanalyzed", "donated_chunks")
        assert _counts(tctx, keys) == _counts(jctx, keys), hold
        close(tout, jout)
    (te,), (je,) = tpc.entries(), jpc.entries()
    assert {s: h.to_json() for s, h in te.handoff.items()} == \
        {s: h.to_json() for s, h in je.handoff.items()}


@pytest.mark.parametrize("est,n", [(100, 1000), (100, 150), (100, 80), (1, 1000),
                                   (100, 0), (0, 7), (5000, 10_000), (7, 7), (3, 4)])
def test_candidate_batches_equal_jax(est, n):
    assert tse.candidate_batches(est, n) == jcandidate_batches(est, n)


# ---------------------------------------------------------------------------
# The port's own key and warm-call behaviour
# ---------------------------------------------------------------------------


def _quick(x, executor="fused", **kw):
    with tmozart.session(executor=executor, device="cpu", **kw) as ctx:
        v = float(tanp.sum(tanp.multiply(tanp.exp(x), 0.5)).value)
    return v, ctx


class TestKey:
    def test_fresh_data_same_shape_hits(self):
        _quick(torch.linspace(0.0, 1.0, 4096))
        v, ctx = _quick(torch.linspace(1.0, 2.0, 4096))
        assert ctx.stats["plan_cache_hits"] == 1 and ctx.stats["planner_calls"] == 0
        assert np.isclose(v, float(np.sum(np.exp(np.linspace(1, 2, 4096)) * 0.5)),
                          rtol=1e-5)

    def test_shape_change_misses(self):
        _quick(torch.linspace(0.0, 1.0, 4096))
        _, ctx = _quick(torch.linspace(0.0, 1.0, 4097))
        assert ctx.stats["plan_cache_misses"] == 1

    def test_executor_is_part_of_the_key(self):
        x = torch.linspace(0.0, 1.0, 4096)
        _quick(x, "fused")
        _, ctx = _quick(x, "scan")
        assert ctx.stats["plan_cache_misses"] == 1

    def test_device_type_and_dtype_are_part_of_the_key(self):
        x = torch.linspace(0.0, 1.0, 64)
        fp = tpc.value_fingerprint(x)
        assert fp == ("arr", (64,), "torch.float32", "cpu")
        assert tpc.value_fingerprint(x.to(device="meta")) != fp
        assert tpc.value_fingerprint(x.double()) != fp
        ctx = tmozart.MozartContext(executor="cuda", device="cpu")
        assert tpc.context_key_prefix(ctx) == ("cuda", thw.CPU_HOST.name, True, "cpu", True)

    def test_aliased_arguments_key_differently(self):
        x, y = torch.linspace(0, 1, 1024), torch.linspace(1, 2, 1024)
        with tmozart.session(executor="fused", device="cpu"):
            tanp.add(x, x).value
        with tmozart.session(executor="fused", device="cpu") as ctx:
            tanp.add(x, y).value
        assert ctx.stats["plan_cache_misses"] == 1

    @pytest.mark.parametrize("executor", ["fused", "scan", "cuda"])
    def test_same_named_closures_get_their_own_executables(self, executor):
        """Two closures with one name share a fingerprint; the second one's
        plan replaces the first's entry and must not replay the drivers or
        the lowered program built from the first one's body."""
        def make(k):
            return tsplittable(x=tst.Along(0), ret=tst.Along(0),
                               name="scale_by")(lambda x: x * k)
        by2, by3 = make(2.0), make(3.0)
        x = torch.linspace(0.0, 1.0, 4096)
        want = {by2: float((x * 2.0 * 0.5).sum()), by3: float((x * 3.0 * 0.5).sum())}
        for fn in (by2, by2, by3, by3, by2, by3):
            with tmozart.session(executor=executor, device="cpu") as ctx:
                v = float(tanp.sum(tanp.multiply(fn(x), 0.5)).value)
            assert v == pytest.approx(want[fn], rel=1e-5)
        assert tpc.cache_info()["entries"] == 1
        assert len(tpc._exec_tables) <= 1

    def test_plan_cache_can_be_disabled(self):
        x = torch.linspace(0.0, 1.0, 4096)
        for _ in range(2):
            _, ctx = _quick(x, plan_cache=False)
            assert ctx.stats["planner_calls"] == 1
        assert tpc.cache_info()["entries"] == 0

    def test_planner_n_calls_counts_only_real_planning(self):
        from repro_torch.core import planner
        x = torch.linspace(0.0, 1.0, 4096)
        before = planner.N_CALLS
        for _ in range(3):
            _quick(x)
        assert planner.N_CALLS - before == 1

    def test_peek_is_read_only(self):
        x = torch.linspace(0.0, 1.0, 4096)
        _quick(x)
        with tmozart.session(executor="fused", device="cpu") as ctx:
            f = tanp.sum(tanp.multiply(tanp.exp(x), 0.5))
            (entry,) = tpc.entries()
            hits = entry.hits
            assert tpc.peek(ctx.graph.pending(), ctx.graph, ctx) is entry
            assert entry.hits == hits and ctx.stats["plan_cache_hits"] == 0
            f.value


class TestAutoTuner:
    def _run(self, x, executor="fused", **kw):
        return _quick(x, executor, chip=TTINY, **kw)

    def test_tunes_on_first_cached_execution_then_pins(self):
        x = torch.linspace(0.0, 1.0, 100_000)
        v1, c1 = self._run(x)
        assert c1.stats["autotuned_stages"] == 0
        v2, c2 = self._run(x)
        assert c2.stats["autotuned_stages"] == 1
        (entry,) = tpc.entries()
        assert entry.tuned_batch and all(len(t) >= 2 for t in entry.trials.values())
        v3, c3 = self._run(x)
        assert c3.stats["autotuned_stages"] == 0
        assert c3.stats["chunks"] == -(-100_000 // entry.tuned_batch[0])
        assert np.isclose(v1, v2, rtol=1e-5) and np.isclose(v2, v3, rtol=1e-5)

    def test_explicit_batch_elements_disables_tuning(self):
        x = torch.linspace(0.0, 1.0, 50_000)
        for _ in range(3):
            _, ctx = self._run(x, batch_elements=7000)
        assert ctx.stats["autotuned_stages"] == 0 and not tpc.tuned_batches()
        assert ctx.stats["chunks"] == -(-50_000 // 7000)

    def test_autotune_flag_off(self):
        x = torch.linspace(0.0, 1.0, 50_000)
        for _ in range(3):
            _, ctx = self._run(x, autotune=False)
        assert ctx.stats["autotuned_stages"] == 0 and not tpc.tuned_batches()

    def test_tuning_cost_is_a_bounded_sample(self):
        n = 100_000
        x = torch.linspace(0.0, 1.0, n)
        self._run(x)
        _, c2 = self._run(x)
        assert c2.stats["autotuned_stages"] == 1
        assert 0 < c2.stats["tuning_sample_elems"] < n
        _, c3 = self._run(x)
        assert c3.stats.get("tuning_sample_elems", 0) == 0


# ---------------------------------------------------------------------------
# The cuda executor: a pinned program and tile, replayed
# ---------------------------------------------------------------------------


class TestCudaPinned:
    def test_warm_cuda_evaluation_lowers_nothing(self):
        """On the CPU (the kernel's plain version) a warm ``cuda`` evaluation
        of a cached plan makes no planner call, no fx trace or lowering and
        builds nothing, and equals the cold one."""
        cold, c1 = run_port("black_scholes", "cuda")
        assert c1.stats["exec_builds"] == 1 and c1.stats["cuda_stages"] == 1
        run_port("black_scholes", "cuda")            # first hit: the tuner
        before = tse.trace_count()
        for _ in range(2):
            warm, ctx = run_port("black_scholes", "cuda")
            assert ctx.stats["planner_calls"] == 0
            assert ctx.stats.get("exec_builds", 0) == 0
            assert ctx.counters.trace_count() == 0
            assert ctx.stats["cuda_stages"] == 1
            assert ctx.stats.get("cuda_fallback_stages", 0) == 0
            for g, w in zip(warm, cold):
                np.testing.assert_array_equal(g, w)
        assert tse.trace_count() == before
        (entry,) = tpc.entries()
        assert entry.block_shape[0][0] == 1 and entry.block_shape[0][1] in tsp.TILES
        assert ("cuda" in {k[1] for k in entry.exec_table()})

    def test_uncacheable_cuda_stage_keeps_its_program_on_the_stage(self):
        x = torch.linspace(0.1, 0.9, 256)
        for _ in range(2):
            v, ctx = _quick(x, "cuda", plan_cache=False)
            assert ctx.stats["exec_builds"] == 1      # lowered per evaluation
            assert ctx.counters.trace_count() >= 1

    def test_tiles_replace_the_bracket_and_pin_a_block_shape(self):
        """With a small estimate the bracket spans several of the kernel's
        tiles: the first hit times each tile once and pins the winner as
        ``(1, tile)``."""
        from repro_torch.core.cuda_exec import CudaExecutor
        ex = tse.get_executor("cuda")
        assert isinstance(ex, CudaExecutor) and ex.tunable
        x = torch.linspace(0.1, 0.9, 60_000)
        chip = thw.Chip(name="kernel_tile_chip", peak_bf16_flops=1e11,
                        hbm_bandwidth=2e10, ici_link_bandwidth=1e10, ici_links=1,
                        hbm_bytes=2**30, vmem_bytes=36 * 1024, mozart_c=1.0)
        vals = []
        for call in range(3):
            with tmozart.session(executor="cuda", device="cpu", chip=chip) as ctx:
                vals.append(tanp.multiply(tanp.exp(x), 0.5).value)
            assert ctx.stats.get("autotuned_stages", 0) == (1 if call == 1 else 0)
            assert ctx.stats.get("cuda_fallback_stages", 0) == 0
        (entry,) = tpc.entries()
        trials = [b for b, _s in entry.trials[0]]
        assert len(trials) >= 2 and set(trials) <= set(tsp.TILES)
        assert entry.block_shape[0] == (1, entry.tuned_batch[0])
        for v in vals[1:]:
            torch.testing.assert_close(v, vals[0], rtol=0, atol=0)

    def test_single_tile_first_hit_merges_no_stream(self):
        """When the bracket rounds to one tile there is nothing to measure:
        the first hit pins it and ingests the handed-off stream as every
        later call does, with no merge and no interior bytes."""
        def chain():
            with tmozart.session(executor="fused", device="cpu", chip=TTINY) as ctx:
                cur = torch.linspace(0.0, 1.0, 20_000)
                for i in range(2):          # the cuda stage ingests a stream
                    cur = tanp.multiply(tanp.add(cur, 1.0), 0.5)
                    tmozart.evaluate()
                    if i == 0:
                        tmozart.configure(executor="cuda")
                out = cur.value
            return out, ctx
        outs = []
        for call in range(3):
            out, ctx = chain()
            outs.append(out)
            assert ctx.stats.get("stream_ingests", 0) >= 1
            assert ctx.stats.get("stream_materialized", 0) == 0, (call, dict(ctx.stats))
            assert ctx.counters.bytes_interior() == 0, call
        assert any(e.block_shape for e in tpc.entries())
        for o in outs[1:]:
            torch.testing.assert_close(o, outs[0], rtol=0, atol=0)

    def test_tiles_up_to(self):
        from repro_torch.core.cuda_exec import tiles_up_to
        assert tiles_up_to(100) == (512,)
        assert tiles_up_to(1024) == (1024, 512)
        assert tiles_up_to(10**6) == tsp.TILES

    def test_stage_that_stays_off_the_kernel_tunes_the_fused_bracket(self):
        plain = tsplittable(x=tst.Along(0), ret=tst.Along(0),
                            name="plain_double")(lambda x: x * 2.0)
        x = torch.linspace(0.0, 1.0, 100_000)
        for call in range(3):
            with tmozart.session(executor="cuda", device="cpu", chip=TTINY) as ctx:
                v = plain(x).value
            # the tuner's sampled runs (call 1) count as executions too
            assert ctx.stats["cuda_fallback_stages"] >= 1
            assert ctx.stats["cuda_fallback_stages"] == 1 or call == 1
            assert ctx.stats.get("autotuned_stages", 0) == (1 if call == 1 else 0)
        torch.testing.assert_close(v, x * 2.0)
        (entry,) = tpc.entries()
        assert entry.tuned_batch and not entry.block_shape


# ---------------------------------------------------------------------------
# Planner hooks the plan cache and the cost model read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("pipeline", [True, False])
def test_simulated_stage_breaks_equal_jax_and_count_no_planner_call(name, pipeline):
    from repro.core import planner as jplanner
    from repro_torch.core import planner as tplanner
    jfn, tfn, _b = CASES[name]
    data = _data(name)
    with jmozart.session(executor="fused", plan_cache=False, **JAX_CFG) as jctx:
        jouts = jfn(**{k: jnp.asarray(v) for k, v in data.items()})
        jpend = jctx.graph.pending()
        jgroups = jplanner.simulate_stage_breaks(jpend, jctx.graph,
                                                 None if pipeline else 1)
        jinternal = [[s.internal(n, a) for n in s.nodes for a in n.bound]
                     for s in jctx.last_plan()]
        del jouts
    with tmozart.session(executor="fused", device="cpu", plan_cache=False) as tctx:
        touts = tfn(**{k: torch.from_numpy(v.copy()) for k, v in data.items()})
        tpend = tctx.graph.pending()
        before = tplanner.N_CALLS
        tgroups = tplanner.simulate_stage_breaks(tpend, tctx.graph, None if pipeline else 1)
        assert tplanner.N_CALLS == before
        stages = tctx.last_plan()
        assert tplanner.N_CALLS == before + 1
        tinternal = [[s.internal(n, a) for n in s.nodes for a in n.bound] for s in stages]
        del touts
    assert [[n.fn.name for n in g] for g in tgroups] == \
        [[n.fn.name for n in g] for g in jgroups]
    if pipeline:
        assert [[n.id for n in s.nodes] for s in stages] == \
            [[n.id for n in g] for g in tgroups]
        assert tinternal == jinternal
        assert [s.flops_hint() for s in stages] == [float(len(g)) for g in tgroups]
