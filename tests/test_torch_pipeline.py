"""The port's AOT pipeline API (``mozart.pipeline``), case for case the
reference's ``tests/test_pipeline.py`` where the port has the machinery
(``sharded`` waits for ROADMAP A8), and held against the
JAX package: the same pipeline compiled on both sides is warm on both, its
warm calls show the same zeros in ``last_call_stats`` (planner calls,
tuning and measurement runs, traces), and the outputs agree within float32
2e-5 (sums 1e-4).  Both sides run the static rewrite pass (the default); the
JAX side runs ``pallas`` where the port runs ``cuda``; the port side on the
CPU, where ``cuda`` runs the kernel's plain version.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Along as JAlong
from repro.core import annotated_numpy as janp
from repro.core import mozart as jmozart
from repro.core import splittable as jsplittable
from repro_torch.core import Along, mozart, plan_cache, splittable
from repro_torch.core import annotated_numpy as anp
from repro_torch.core import stage_exec
from repro_torch.core.pipeline import WARM_STATS, Pipeline
from repro_torch.core.stage_exec import available_executors

from test_torch_plan_cache import JTINY, TTINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_cache():
    plan_cache.clear()
    yield
    plan_cache.clear()


@splittable(x=Along(0), y=Along(0), ret=Along(0), elementwise=True)
def saxpy(x, y):
    return 2.0 * x + y


@jsplittable(x=JAlong(0), y=JAlong(0), ret=JAlong(0), elementwise=True, name="saxpy")
def jsaxpy(x, y):
    return 2.0 * x + y


def quickstart(x, y):
    a = saxpy(x, y)
    b = anp.exp(a)
    c = anp.multiply(b, 0.5)
    return c, anp.sum(c)


def jquickstart(x, y):
    c = janp.multiply(janp.exp(jsaxpy(x, y)), 0.5)
    return c, janp.sum(c)


def _data(n=4096):
    return torch.arange(n, dtype=torch.float32) / n, torch.ones(n)


def _pipe(fn, **kw):
    return mozart.pipeline(fn, device="cpu", **kw)


def _want(x, y):
    return np.exp(2 * x.numpy() + y.numpy()) * 0.5


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------


class TestLifecycle:
    def test_lower_resolves_a_plan_entry_without_executing(self):
        x, y = _data()
        p = _pipe(quickstart, executor="fused")
        assert p.plan_entry is None
        p.lower(x, y)
        assert p.plan_entry is not None and len(p.plan_entry.stage_templates) >= 1
        assert p.ctx.stats["stages"] == 0
        assert p.ctx.stats["planner_calls"] == 1

    def test_call_without_compile_still_correct(self):
        x, y = _data()
        c, s = _pipe(quickstart, executor="fused")(x, y)
        np.testing.assert_allclose(c.numpy(), _want(x, y), rtol=2e-5)

    def test_decorator_form(self):
        @mozart.pipeline(executor="fused", device="cpu", batch_elements=512)
        def pipe(x, y):
            return anp.sum(saxpy(x, y))

        x, y = _data(1024)
        assert isinstance(pipe, Pipeline)
        assert np.isclose(float(pipe(x, y)), float(np.sum(2 * x.numpy() + 1)), rtol=1e-5)

    def test_compile_requires_example_args(self):
        with pytest.raises(ValueError, match="example arguments"):
            _pipe(quickstart, executor="fused").compile()

    def test_compile_warns_when_it_cannot_converge(self):
        x, y = _data(1024)
        p = _pipe(quickstart, executor="fused", batch_elements=256, plan_cache=False)
        with pytest.warns(RuntimeWarning, match="warm fixed point"):
            p.compile(x, y)
        assert not p.warm()

    def test_session_scope_pipeline_rejects_calls(self):
        p = Pipeline(None, executor="fused", device="cpu")
        with pytest.raises(TypeError, match="wraps no function"):
            p(1)

    def test_lower_leaves_no_pending_work_behind(self):
        x, y = _data()
        p = _pipe(quickstart, executor="fused")
        p.lower(x, y)
        assert p.ctx.graph.pending() == []
        c, s = p(x, y)
        assert p.last_call_stats.get("planner_calls", 0) == 0
        np.testing.assert_allclose(c.numpy(), _want(x, y), rtol=2e-5)

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="torch.cuda is not available"):
            mozart.pipeline(quickstart, executor="cuda")

    def test_verify_waits_for_the_checking_layers(self):
        """``Pipeline.verify`` (a stub until the checking layers were ported;
        the test keeps its name): on quickstart and Black-Scholes, lowered
        then warm, the reference ``Pipeline.verify``'s (code, severity,
        subject) with node ids renumbered, nothing executed, and the
        recorded handoff reused where the reference reuses it (a graph the
        rewrite pass leaves alone: quickstart; Black-Scholes' MZ502 makes
        its entry describe another graph, so both packages re-analyze)."""
        from test_torch_analysis import _normalized
        from benchmarks import workloads as jw
        from repro.core import plan_cache as jpc
        from repro_torch import workloads as tw
        x, y = _data(1024)
        bs = tw.black_scholes_data(1024, device="cpu")
        cases = [(quickstart, jquickstart, (x, y), (jnp.asarray(x.numpy()), jnp.asarray(y.numpy())),
                  1),
                 (tw.black_scholes, jw.black_scholes, tuple(bs.values()),
                  tuple(jnp.asarray(v.numpy()) for v in bs.values()), 0)]
        jpc.clear()
        for fn, jfn, args, jargs, reused in cases:
            p = _pipe(fn, executor="cuda", autotune=False).lower(*args)
            jp = jmozart.pipeline(jfn, executor="pallas", autotune=False).lower(*jargs)
            before = dict(p.ctx.stats)
            rep, jrep = p.verify(), jp.verify()
            assert dict(p.ctx.stats) == before              # traced, never run
            assert rep.ok and _normalized(rep) == _normalized(jrep) != []
            p(*args), p(*args)
            jp(*jargs), jp(*jargs)
            base, jbase = (plan_cache.stats["verify_handoff_reused"],
                           jpc.stats["verify_handoff_reused"])
            entries = plan_cache.cache_info()["entries"]
            rep, jrep = p.verify(*args), jp.verify(*jargs)
            assert _normalized(rep) == _normalized(jrep)
            assert plan_cache.stats["verify_handoff_reused"] - base == reused
            assert jpc.stats["verify_handoff_reused"] - jbase == reused
            assert plan_cache.cache_info()["entries"] == entries
        jpc.clear()
        with pytest.raises(TypeError, match="wraps no function"):
            Pipeline(None, device="cpu").verify()

    def test_core_exports_every_reference_name_but_the_checking_layers(self):
        """``repro_torch.core`` re-exports every name ``repro.core`` does
        (the checking layers' ``CODES``, ``Diagnostic``, ``Report`` and
        ``verify`` included, which once waited; the test keeps its name),
        the same objects as its submodules', plus the port's named extras."""
        import repro.core as jcore
        import repro_torch.core as tcore
        from repro_torch.core import analysis
        assert set(jcore.__all__) - set(tcore.__all__) == set()
        assert set(tcore.__all__) - set(jcore.__all__) == {
            "plan_cache", "cost_model", "pipeline", "resilience", "rewrite", "bytes_interior"}
        assert all(hasattr(tcore, name) for name in tcore.__all__)
        from repro_torch.core import ChunkStream, bytes_materialized
        assert tcore.Pipeline is Pipeline
        assert ChunkStream is stage_exec.ChunkStream
        assert bytes_materialized is stage_exec.bytes_materialized
        assert (tcore.CODES, tcore.Diagnostic, tcore.Report, tcore.verify) == \
            (analysis.CODES, analysis.Diagnostic, analysis.Report, analysis.verify)
        assert mozart.verify(n=8, device="cpu").ok

    def test_describe_and_buckets(self):
        x, y = _data()
        p = _pipe(quickstart, executor="cuda")
        assert "not lowered" in p.describe()
        p.lower(x, y).compile(bucket=("prefill", 1, 4096))
        assert p.buckets == {("prefill", 1, 4096): p.plan_entry}
        assert p.plan_entry.bucket == ("prefill", 1, 4096)
        text = p.describe()
        assert "block_shape" in text and "'cuda'" in text


# ---------------------------------------------------------------------------
# Differential: pipeline output == session output, and == the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("executor", sorted(available_executors()))
def test_pipeline_matches_session_differential(executor):
    x, y = _data()
    with mozart.session(executor=executor, device="cpu", batch_elements=512):
        c0, s0 = quickstart(x, y)
        want_c, want_s = c0.value.numpy(), float(s0.value)
    plan_cache.clear()
    p = _pipe(quickstart, executor=executor, batch_elements=512)
    p.lower(x, y).compile()
    c, s = p(x, y)
    np.testing.assert_allclose(c.numpy(), want_c, rtol=2e-5, atol=1e-6)
    assert np.isclose(float(s), want_s, rtol=1e-5)


@pytest.mark.parametrize("executor", ["pipelined", "fused", "scan", "cuda", "auto", "eager"])
def test_compiled_pipeline_is_warm_like_jax(executor):
    """Both packages compile the same pipeline to a warm fixed point, and
    each warm call shows the same zeros."""
    n = 30_000
    xn = np.linspace(0.0, 1.0, n, dtype=np.float32)
    yn = np.ones(n, np.float32)
    jp = jmozart.pipeline(jquickstart, executor={"cuda": "pallas"}.get(executor, executor),
                          chip=JTINY)
    jp.lower(jnp.asarray(xn), jnp.asarray(yn)).compile()
    p = _pipe(quickstart, executor=executor, chip=TTINY)
    p.lower(torch.from_numpy(xn), torch.from_numpy(yn)).compile()
    assert p.warm() and jp.warm()
    for _ in range(2):
        jc, js = jp(jnp.asarray(xn), jnp.asarray(yn))
        c, s = p(torch.from_numpy(xn), torch.from_numpy(yn))
        assert p.warm() and jp.warm()
        assert {k: p.last_call_stats.get(k, 0) for k in WARM_STATS} == \
            {k: jp.last_call_stats.get(k, 0) for k in WARM_STATS} == dict.fromkeys(WARM_STATS, 0)
        assert p.last_call_stats.get("plan_cache_hits") == jp.last_call_stats.get(
            "plan_cache_hits") == 1
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=2e-5, atol=2e-5 * 3)
        assert np.isclose(float(s), float(js), rtol=1e-4)


# ---------------------------------------------------------------------------
# The zero-trace warm-call guarantee
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("executor", ["pipelined", "fused", "scan", "cuda", "auto", "eager"])
def test_warm_calls_zero_planner_calls_and_zero_traces(executor):
    n = 30_000
    x = torch.linspace(0.0, 1.0, n)
    y = torch.ones(n)
    p = _pipe(quickstart, executor=executor, chip=TTINY)
    p.lower(x, y).compile()
    assert p.warm(), f"compile() did not converge: {p.last_call_stats}"
    planner_before = p.ctx.stats["planner_calls"]
    traces_before = stage_exec.trace_count()
    for _ in range(3):
        c, s = p(x, y)
        assert p.last_call_stats.get("planner_calls", 0) == 0
        assert p.last_call_stats["jit_traces"] == 0
        assert p.last_call_stats.get("exec_builds", 0) == 0
        assert p.last_call_stats.get("autotuned_stages", 0) == 0
        assert p.last_call_stats.get("auto_measured_stages", 0) == 0
    assert p.ctx.stats["planner_calls"] == planner_before
    assert stage_exec.trace_count() == traces_before
    np.testing.assert_allclose(c.numpy(), _want(x, y), rtol=2e-5)


def test_warm_cuda_pipeline_runs_the_pinned_program():
    """On the CPU the ``cuda`` stages run the kernel's plain version: a warm
    call plans nothing, lowers nothing and falls back nowhere."""
    x, y = _data(50_000)
    p = _pipe(quickstart, executor="cuda")
    p.lower(x, y).compile()
    for _ in range(3):
        c, s = p(x, y)
        st = p.last_call_stats
        assert st.get("planner_calls", 0) == 0 and st["jit_traces"] == 0
        assert st.get("exec_builds", 0) == 0
        assert st["cuda_stages"] == len(p.plan_entry.stage_templates)
        assert st.get("cuda_fallback_stages", 0) == 0
    np.testing.assert_allclose(c.numpy(), _want(x, y), rtol=2e-5)
    assert all(k[1] == "cuda" for k in p.plan_entry.exec_table())


def test_warm_calls_hit_on_fresh_data_of_same_shape():
    n = 10_000
    p = _pipe(quickstart, executor="scan", chip=TTINY)
    p.lower(torch.linspace(0.0, 1.0, n), torch.ones(n)).compile()
    for i in range(3):
        x2 = torch.linspace(float(i), float(i) + 1.0, n)
        y2 = torch.full((n,), float(i))
        c, s = p(x2, y2)
        assert p.last_call_stats["jit_traces"] == 0
        assert p.last_call_stats.get("planner_calls", 0) == 0
        np.testing.assert_allclose(c.numpy(), _want(x2, y2), rtol=2e-5)


@pytest.mark.parametrize("executor", ["scan", "cuda"])
def test_pinned_executables_do_not_bake_broadcast_scalars(executor):
    n = 8192
    x = torch.linspace(0.0, 1.0, n)

    def scaled(x, k):
        return anp.sum(anp.multiply(x, k))

    p = _pipe(scaled, executor=executor, chip=TTINY)
    p.lower(x, 2.0).compile()
    base = float(x.sum())
    for k in (2.0, 3.0, 0.5):
        v = float(p(x, k))
        assert np.isclose(v, base * k, rtol=1e-5), (k, v, base * k)
        assert p.last_call_stats["jit_traces"] == 0


def test_session_path_shares_pinned_executables():
    x = torch.linspace(0.0, 1.0, 20_000)

    def run():
        with mozart.session(executor="fused", device="cpu", chip=TTINY) as ctx:
            v = float(anp.sum(anp.multiply(anp.exp(x), 0.5)).value)
        return v, ctx

    run()
    run()
    run()
    before = stage_exec.trace_count()
    v, ctx = run()
    assert stage_exec.trace_count() == before
    assert ctx.stats["planner_calls"] == 0
    assert ctx.stats.get("exec_builds", 0) == 0


def test_call_with_stats_pairs_a_call_with_its_delta():
    x, y = _data()
    p = _pipe(quickstart, executor="fused")
    (c, s), first = p.call_with_stats(x, y)
    assert first["planner_calls"] == 1
    (c, s), second = p.call_with_stats(x, y)
    assert second.get("planner_calls", 0) == 0 and second["plan_cache_hits"] == 1


# ---------------------------------------------------------------------------
# Plan-cache-aware configure()
# ---------------------------------------------------------------------------


class TestConfigureRekey:
    def test_executor_change_rekeys_instead_of_stranding(self):
        x = torch.linspace(0.0, 1.0, 4096)
        with mozart.session(executor="fused", device="cpu", batch_elements=512) as ctx:
            _ = float(anp.sum(anp.exp(x)).value)
            assert ctx.stats["planner_calls"] == 1
            mozart.configure(executor="cuda")
            v = float(anp.sum(anp.exp(x)).value)
        assert ctx.stats["planner_calls"] == 1
        assert ctx.stats["plan_cache_hits"] == 1
        assert ctx.stats["configure_rekeyed"] == 1
        assert plan_cache.stats["rekeyed"] == 1
        assert np.isclose(v, float(np.sum(np.exp(x.numpy()))), rtol=1e-5)

    def test_rekey_migrates_tuned_batches_on_same_chip(self):
        x = torch.linspace(0.0, 1.0, 50_000)
        for _ in range(2):
            with mozart.session(executor="fused", device="cpu", chip=TTINY):
                _ = float(anp.sum(anp.exp(x)).value)
        assert plan_cache.tuned_batches()
        with mozart.session(executor="fused", device="cpu", chip=TTINY) as ctx:
            _ = float(anp.sum(anp.exp(x)).value)
            mozart.configure(executor="pipelined")
            _ = float(anp.sum(anp.exp(x)).value)
        by_exec = {e.key[0]: e for e in plan_cache.entries()}
        assert set(by_exec) == {"fused", "pipelined"}
        assert by_exec["fused"].tuned_batch
        assert by_exec["pipelined"].tuned_batch == by_exec["fused"].tuned_batch
        assert by_exec["pipelined"].chosen_exec == {}
        assert ctx.stats.get("autotuned_stages", 0) == 0

    def test_rekey_drops_measured_state_on_chip_change(self):
        x = torch.linspace(0.0, 1.0, 50_000)
        for _ in range(2):
            with mozart.session(executor="fused", device="cpu", chip=TTINY):
                _ = float(anp.sum(anp.exp(x)).value)
        assert plan_cache.tuned_batches()
        from repro_torch import hardware
        with mozart.session(executor="fused", device="cpu", chip=TTINY):
            _ = float(anp.sum(anp.exp(x)).value)
            mozart.configure(chip=hardware.CPU_HOST)
        by_chip = {e.key[1]: e for e in plan_cache.entries()}
        assert set(by_chip) == {TTINY.name, hardware.CPU_HOST.name}
        assert by_chip[TTINY.name].tuned_batch
        assert by_chip[hardware.CPU_HOST.name].tuned_batch == {}

    def test_pipeline_flag_change_plans_fresh(self):
        x = torch.linspace(0.0, 1.0, 1024)
        with mozart.session(executor="fused", device="cpu", batch_elements=256) as ctx:
            _ = float(anp.sum(anp.exp(x)).value)
            mozart.configure(pipeline=False)
            _ = float(anp.sum(anp.exp(x)).value)
        assert ctx.stats["planner_calls"] == 2
        assert plan_cache.stats["rekey_skipped_structural"] == 1
        assert {e.key[2] for e in plan_cache.entries()} == {True, False}

    def test_unrelated_configs_untouched(self):
        x = torch.linspace(0.0, 1.0, 1024)
        with mozart.session(executor="scan", device="cpu", batch_elements=256):
            _ = float(anp.sum(anp.exp(x)).value)
        with mozart.session(executor="fused", device="cpu", batch_elements=256):
            _ = float(anp.sum(anp.exp(x)).value)
            mozart.configure(executor="pipelined")
        assert {e.key[0] for e in plan_cache.entries()} == {"scan", "fused", "pipelined"}

    def test_configure_does_not_break_other_pipelines_warm_state(self):
        n = 20_000
        x, y = torch.linspace(0.0, 1.0, n), torch.ones(n)
        p = _pipe(quickstart, executor="fused", chip=TTINY)
        p.lower(x, y).compile()
        assert p.warm()
        with mozart.session(executor="fused", device="cpu", chip=TTINY):
            _ = float(anp.sum(anp.exp(x)).value)
            mozart.configure(executor="scan")
        p(x, y)
        assert p.last_call_stats.get("planner_calls", 0) == 0
        assert p.last_call_stats["jit_traces"] == 0


# ---------------------------------------------------------------------------
# Bound-arguments fast path (arg_transparent)
# ---------------------------------------------------------------------------


class TestArgTransparentFastPath:
    def _p(self, fn=quickstart):
        return _pipe(fn, executor="fused", batch_elements=512, arg_transparent=True)

    def test_warm_calls_skip_graph_capture(self):
        x, y = _data()
        p = self._p()
        p.lower(x, y).compile()
        p(x, y)
        captures = p.ctx.stats["graph_captures"]
        for i in range(1, 4):
            x2 = torch.linspace(float(i), float(i) + 1.0, 4096)
            y2 = torch.full((4096,), float(i))
            c, s = p(x2, y2)
            assert p.ctx.stats["graph_captures"] == captures
            assert p.ctx.stats["fast_path_calls"] == i
            assert p.last_call_stats.get("planner_calls", 0) == 0
            assert p.last_call_stats.get("plan_cache_hits", 0) == 0
            assert p.last_call_stats["jit_traces"] == 0
            want = _want(x2, y2)
            np.testing.assert_allclose(c.numpy(), want, rtol=2e-5)
            assert np.isclose(float(s), want.sum(), rtol=1e-4)

    @pytest.mark.parametrize("executor", ["fused", "cuda"])
    def test_retained_nodes_keep_no_tensors_between_calls(self, executor):
        """The replay keeps the node set, not the last call's results or
        arguments: between calls no retained node or stage holds a tensor."""
        x, y = _data()
        p = _pipe(quickstart, executor=executor, batch_elements=512, arg_transparent=True)
        p.lower(x, y).compile()
        for i in range(3):
            x2 = torch.linspace(float(i), float(i) + 1.0, 4096)
            c, _s = p(x2, y)
            np.testing.assert_allclose(c.numpy(), _want(x2, y), rtol=2e-5)
            f = p._fast
            assert all(n.result is None for n in f.pending)
            assert all(v is None or not isinstance(v, torch.Tensor)
                       for n in f.pending for v in n.bound.values())
            assert all(not isinstance(si.value, torch.Tensor)
                       for s in f.stages for si in s.inputs.values())
        assert p.ctx.stats["fast_path_calls"] == 2

    def test_falls_back_on_shape_change_then_recovers(self):
        x, y = _data()
        p = self._p()
        p.lower(x, y).compile()
        p(x, y)
        captures = p.ctx.stats["graph_captures"]
        xs, ys = _data(1000)
        c, _ = p(xs, ys)
        assert p.ctx.stats["graph_captures"] == captures + 1
        np.testing.assert_allclose(c.numpy(), _want(xs, ys), rtol=2e-5)
        p(x, y)
        assert p.ctx.stats["graph_captures"] == captures + 1

    def test_non_tensor_args_are_specialized(self):
        x = torch.linspace(0.0, 1.0, 2048)

        def scaled(x, k):
            return anp.sum(anp.multiply(x, k))

        p = self._p(scaled)
        p.lower(x, 2.0).compile()
        v = float(p(x, 2.0))
        captures = p.ctx.stats["graph_captures"]
        assert float(p(x, 2.0)) == v
        assert p.ctx.stats["graph_captures"] == captures
        v3 = float(p(x, 3.0))
        assert p.ctx.stats["graph_captures"] == captures + 1
        assert np.isclose(v3, v * 1.5, rtol=1e-5)

    def test_alias_pattern_guard(self):
        def add2(a, b):
            return anp.add(a, b)

        x, y = _data(1024)
        p = self._p(add2)
        p.lower(x, x).compile()
        p(x, x)
        captures = p.ctx.stats["graph_captures"]
        out = p(x, y)
        assert p.ctx.stats["graph_captures"] == captures + 1
        np.testing.assert_allclose(out.numpy(), (x + y).numpy(), rtol=1e-6)

    def test_fn_with_internal_evaluate_refuses_fast_path(self):
        x = torch.linspace(0.0, 1.0, 2048)

        def staged(a):
            y = anp.exp(a)
            mozart.evaluate()
            return anp.add(y, a)

        p = self._p(staged)
        p.lower(x).compile()
        before = p.ctx.stats["graph_captures"]
        for i in range(3):
            out = p(torch.full((2048,), float(i)))
            np.testing.assert_allclose(out.numpy(), np.exp(float(i)) + float(i), rtol=1e-5)
        assert p.ctx.stats.get("fast_path_calls", 0) == 0
        assert p.ctx.stats["graph_captures"] == before + 3

    def test_without_flag_every_call_captures(self):
        x, y = _data()
        p = _pipe(quickstart, executor="fused", batch_elements=512)
        p.lower(x, y).compile()
        before = p.ctx.stats["graph_captures"]
        p(x, y)
        p(x, y)
        assert p.ctx.stats["graph_captures"] == before + 2
        assert p.ctx.stats.get("fast_path_calls", 0) == 0


# ---------------------------------------------------------------------------
# Cross-process warm start via plan_cache_path (subprocess, port only)
# ---------------------------------------------------------------------------

_PRELUDE = """
import json, sys
import torch
from repro_torch import hardware
from repro_torch.core import mozart, plan_cache
from repro_torch.core import annotated_numpy as anp
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
               for m in sys.modules)

TINY = hardware.Chip(name="tiny_subproc_chip", peak_bf16_flops=1e11,
                     hbm_bandwidth=2e10, ici_link_bandwidth=1e10, ici_links=1,
                     hbm_bytes=2**30, vmem_bytes=64 * 1024, mozart_c=1.0)

def fn(x):
    return anp.sum(anp.multiply(anp.exp(x), 0.5))

x = torch.linspace(0.0, 1.0, 50_000)
path = sys.argv[1]
p = mozart.pipeline(fn, executor=sys.argv[2], device="cpu", chip=TINY,
                    plan_cache_path=path)
"""

_PROC_A = _PRELUDE + """
p.lower(x)
p.compile()
v = float(p(x))
print(json.dumps({"v": v, "warm": p.warm(), "last": p.last_call_stats,
                  "ctx": dict(p.ctx.stats), "pc": dict(plan_cache.stats)}))
"""

_PROC_B = _PRELUDE + """
v1 = float(p(x))
first = dict(p.last_call_stats)
v2 = float(p(x))
second = dict(p.last_call_stats)
print(json.dumps({"v": v2, "first": first, "second": second,
                  "ctx": dict(p.ctx.stats), "pc": dict(plan_cache.stats)}))
"""


def _run_subprocess(code, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("MOZART_PLAN_CACHE", None)
    out = subprocess.run([sys.executable, "-c", code, *args],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("executor", ["auto", "cuda"])
def test_cross_process_pipeline_warm_start(tmp_path, executor):
    """Process A lowers, compiles and persists; a FRESH process B replays the
    pinned plan: zero planner calls and zero tuning ever, one build pass at
    most, and warm from the second call on."""
    path = str(tmp_path / "plans.json")
    a = _run_subprocess(_PROC_A, path, executor)
    assert a["warm"], a
    assert a["last"].get("jit_traces", 0) == 0
    assert os.path.exists(path)

    b = _run_subprocess(_PROC_B, path, executor)
    assert b["pc"].get("persist_loaded", 0) >= 1
    assert b["ctx"].get("planner_calls", 0) == 0
    assert b["ctx"].get("autotuned_stages", 0) == 0
    assert b["ctx"].get("auto_measured_stages", 0) == 0
    if executor == "auto":
        assert b["ctx"].get("auto_pinned_replays", 0) >= 1
    assert b["second"].get("jit_traces", 0) == 0
    assert b["second"].get("planner_calls", 0) == 0
    assert np.isclose(a["v"], b["v"], rtol=1e-5)
