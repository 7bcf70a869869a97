"""The port's cost model (``executor="auto"``) against the JAX package's.

``analytic_seconds`` and ``choose(features, ctx, timings=None)`` are held
against the reference on a grid of the same features and the same ``Chip``
constants, with ``pallas`` mapped to ``cuda`` (and the reference's
``on_tpu`` to the port's ``on_cuda``), and with the measured no-op dispatch
pinned to one value on both sides (it is a per-process wall-clock figure).
``features_of`` is held against the reference on the paper's workloads.
Measured winners depend on wall time and are only asserted to be pinned
and replayed; the counters of a measurement pass are equal.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hardware as jhw
from repro.core import cost_model as jcm
from repro.core import mozart as jmozart
from repro_torch import hardware as thw
from repro_torch.core import annotated_numpy as anp
from repro_torch.core import cost_model as tcm
from repro_torch.core import mozart as tmozart
from repro_torch.core import plan_cache as tpc

from test_torch_executors import CASES, _data, _tol, close
from test_torch_plan_cache import JTINY, TTINY

DISPATCH_S = 20e-6
JAX_CFG = dict()


@pytest.fixture(autouse=True)
def _fresh_port_cache():
    tpc.clear()
    yield
    tpc.clear()


@pytest.fixture
def same_dispatch(monkeypatch):
    """One measured dispatch for both packages (a wall-clock figure)."""
    monkeypatch.setattr(jhw, "measured_dispatch_overhead_s", lambda: DISPATCH_S)
    monkeypatch.setattr(thw, "measured_dispatch_overhead_s", lambda device="cuda": DISPATCH_S)


def _pair(n, elem_bytes, n_nodes, flops, dynamic, eligible, on_device):
    j = jcm.StageFeatures(n=n, elem_bytes=elem_bytes, n_nodes=n_nodes,
                          flops_per_elem=flops, dynamic=dynamic,
                          pallas_eligible=eligible, mesh_devices=0, on_tpu=on_device)
    t = tcm.StageFeatures(n=n, elem_bytes=elem_bytes, n_nodes=n_nodes,
                          flops_per_elem=flops, dynamic=dynamic,
                          cuda_eligible=eligible, on_cuda=on_device)
    return j, t


GRID = list(itertools.product(
    (0, 1, 1000, 100_000, 1 << 27), (4, 12, 28, 148), (1, 3, 32), (8.0, 256.0),
    (False, True), (False, True), (False, True)))


def _ctxs(jchip, tchip):
    return (jmozart.MozartContext(executor="auto", chip=jchip),
            tmozart.MozartContext(executor="auto", device="cpu", chip=tchip))


#: the H100's data-sheet constants in both packages' Chip (fast memory in
#: ``vmem_bytes`` on both sides, so the §5.2 estimates agree).
JH100 = jhw.Chip(name="h100_sheet", peak_bf16_flops=989e12, hbm_bandwidth=3.35e12,
                 ici_link_bandwidth=450e9, ici_links=2, hbm_bytes=80 * 10**9,
                 vmem_bytes=50 * 10**6, dispatch_overhead_s=10e-6)
TH100 = thw.Chip(name="h100_sheet", peak_bf16_flops=989e12, hbm_bandwidth=3.35e12,
                 ici_link_bandwidth=450e9, ici_links=2, hbm_bytes=80 * 10**9,
                 vmem_bytes=50 * 10**6, dispatch_overhead_s=10e-6)


@pytest.mark.parametrize("chips", [(jhw.CPU_HOST, thw.CPU_HOST), (JTINY, TTINY),
                                   (JH100, TH100)], ids=["host", "tiny", "h100"])
def test_analytic_choice_equals_jax(chips, same_dispatch):
    """The analytic pick and the candidate list per stage, on the same
    features and constants."""
    jctx, tctx = _ctxs(*chips)
    for args in GRID:
        jf, tf = _pair(*args)
        want = jcm.choose(jf, jctx)
        assert tcm.choose(tf, tctx) == {"pallas": "cuda"}.get(want, want), args
        jc = [{"pallas": "cuda"}.get(c, c) for c in jcm.candidates(jf, jctx)]
        assert tcm.candidates(tf, tctx) == jc, args


def test_analytic_seconds_equal_jax(same_dispatch):
    for args in GRID:
        jf, tf = _pair(*args)
        for name in tcm.CANDIDATE_ORDER:
            want = jcm.analytic_seconds({"cuda": "pallas"}.get(name, name), jf, JTINY)
            got = tcm.analytic_seconds(name, tf, TTINY, "cpu")
            assert got == want or (math.isinf(got) and math.isinf(want)), (name, args)


def test_measured_timings_are_authoritative_like_jax(same_dispatch):
    jctx, tctx = _ctxs(JTINY, TTINY)
    jf, tf = _pair(100_000, 12, 3, 24.0, False, True, False)
    for timings in ({"fused": 0.010, "scan": 0.020, "pipelined": 0.030},
                    {"fused": 0.01, "scan": 0.01, "eager": 0.01},
                    {"eager": 1e-9}, {"cuda": 1e-9, "fused": 1.0}, {}):
        jt = {{"cuda": "pallas"}.get(k, k): v for k, v in timings.items()}
        want = jcm.choose(jf, jctx, jt)
        assert tcm.choose(tf, tctx, timings) == {"pallas": "cuda"}.get(want, want)


def test_drifted_past_crossover_equals_jax(same_dispatch):
    jctx, tctx = _ctxs(JTINY, TTINY)
    for args in GRID[::7]:
        jf, tf = _pair(*args)
        for then in (1, 101, 1 << 16, 1 << 27):
            assert tcm.drifted_past_crossover(tf, {"n": then}, tctx) == \
                jcm.drifted_past_crossover(jf, {"n": then}, jctx), (args, then)


@pytest.mark.parametrize("name", sorted(CASES))
def test_features_of_equal_jax(name):
    """The features the model reads, taken from the same planned first
    stage (its inputs are the pipeline's own)."""
    jfn, tfn, _b = CASES[name]
    data = _data(name)
    with jmozart.session(executor="fused", **JAX_CFG, plan_cache=False) as jctx:
        jouts = jfn(**{k: jnp.asarray(v) for k, v in data.items()})
        jstages = jctx.last_plan()
        jfeats = [jcm.features_of(s, {k: jctx.graph.resolve(si.value)
                                      for k, si in s.inputs.items()}, jctx)
                  for s in jstages[:1]]
        del jouts
    with tmozart.session(executor="fused", device="cpu", plan_cache=False) as tctx:
        touts = tfn(**{k: torch.from_numpy(v.copy()) for k, v in data.items()})
        tstages = tctx.last_plan()
        tfeats = [tcm.features_of(s, {k: tctx.graph.resolve(si.value)
                                      for k, si in s.inputs.items()}, tctx)
                  for s in tstages[:1]]
        del touts
    assert len(tstages) == len(jstages)
    for t, j in zip(tfeats, jfeats):
        assert (t.n, t.elem_bytes, t.n_nodes, t.flops_per_elem, t.dynamic,
                t.cuda_eligible, t.on_cuda) == \
            (j.n, j.elem_bytes, j.n_nodes, j.flops_per_elem, j.dynamic,
             j.pallas_eligible, j.on_tpu)


def test_cost_hint_feeds_the_flops(same_dispatch):
    from repro_torch.core.annotation import SA
    assert SA({}, None).cost_hint == 1.0
    with tmozart.session(executor="fused", device="cpu", plan_cache=False) as ctx:
        f = anp.exp(torch.linspace(0, 1, 64))
        (stage,) = ctx.last_plan()
        assert stage.flops_hint() == 1.0
        stage.nodes[0].fn.sa.cost_hint, saved = 4.0, stage.nodes[0].fn.sa.cost_hint
        try:
            assert tcm.features_of(stage, {k: ctx.graph.resolve(si.value) for k, si in
                                           stage.inputs.items()}, ctx).flops_per_elem == 32.0
        finally:
            stage.nodes[0].fn.sa.cost_hint = saved
        f.value


def test_cuda_is_never_picked_off_the_card(same_dispatch):
    """Off the card ``cuda`` runs the plain version: the interpret penalty
    keeps it out of the analytic pick and out of the measured candidates."""
    ctx = tmozart.MozartContext(executor="auto", device="cpu", chip=TTINY)
    for n in (1, 1000, 100_000, 1 << 24):
        _j, f = _pair(n, 12, 3, 24.0, False, True, False)
        assert tcm.choose(f, ctx) != "cuda"
        scores = {c: tcm.analytic_seconds(c, f, TTINY, "cpu") for c in tcm.candidates(f, ctx)}
        if n >= 1000:
            assert scores["cuda"] > tcm._MEASURE_RATIO * min(scores.values())
    _j, on_card = _pair(1 << 24, 12, 3, 24.0, False, True, True)
    assert tcm.analytic_seconds("cuda", on_card, thw.H100, "cpu") == \
        tcm.analytic_seconds("scan", on_card, thw.H100, "cpu")


def test_candidate_order_maps_the_reference():
    assert tcm.CANDIDATE_ORDER == tuple(
        {"pallas": "cuda"}.get(c, c) for c in jcm.CANDIDATE_ORDER if c != "sharded")


# ---------------------------------------------------------------------------
# The AutoExecutor: measure on the first hit, pin, replay
# ---------------------------------------------------------------------------


def _run_port(x, **kw):
    with tmozart.session(executor="auto", device="cpu", chip=TTINY, **kw) as ctx:
        v = float(anp.sum(anp.multiply(anp.exp(x), 0.5)).value)
    return v, ctx


class TestAutoSelection:
    AUTO_KEYS = ("planner_calls", "plan_cache_hits", "auto_stages",
                 "auto_measured_stages", "auto_pinned_replays")

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_measurement_counters_equal_jax(self, name, same_dispatch):
        jfn, tfn, _b = CASES[name]
        data = _data(name)
        for call in range(3):
            with jmozart.session(executor="auto", chip=JTINY, **JAX_CFG) as jctx:
                jouts = jfn(**{k: jnp.asarray(v) for k, v in data.items()})
                jouts = jouts if isinstance(jouts, tuple) else (jouts,)
                jv = [np.asarray(o) for o in jouts]
            with tmozart.session(executor="auto", device="cpu", chip=TTINY) as tctx:
                outs = tfn(**{k: torch.from_numpy(v.copy()) for k, v in data.items()})
                outs = outs if isinstance(outs, tuple) else (outs,)
                tv = [o.value.numpy() for o in outs]
            assert {k: tctx.stats.get(k, 0) for k in self.AUTO_KEYS} == \
                {k: jctx.stats.get(k, 0) for k in self.AUTO_KEYS}, call
            assert tctx.stats.get("auto_pick_cuda", 0) == 0
            for i, (g, w) in enumerate(zip(tv, jv)):
                close(g, w, **_tol(name, i))
        (entry,) = tpc.entries()
        assert set(entry.chosen_exec) == set(range(len(entry.stage_templates)))

    def test_auto_measures_then_replays_pinned(self):
        x = torch.linspace(0.0, 1.0, 60_000)
        _, c1 = _run_port(x)
        assert c1.stats["auto_stages"] == 1 and c1.stats.get("auto_measured_stages", 0) == 0
        _, c2 = _run_port(x)
        assert c2.stats["auto_measured_stages"] == 1
        _, c3 = _run_port(x)
        assert c3.stats.get("auto_measured_stages", 0) == 0
        assert c3.stats["auto_pinned_replays"] == 1
        (entry,) = tpc.entries()
        assert entry.chosen_exec and entry.exec_timings
        assert entry.exec_meta[0] == {"n": 60_000, "bucket": (60_000).bit_length()}

    def test_poisoned_cost_entry_overridden_by_fresh_measurement(self):
        x = torch.linspace(0.0, 1.0, 60_000)
        v0, _ = _run_port(x)
        (entry,) = tpc.entries()
        entry.exec_timings[0] = {"eager": 1e-15}
        v1, ctx = _run_port(x)
        assert ctx.stats["auto_measured_stages"] == 1
        assert entry.exec_timings[0]["eager"] > 1e-9
        assert entry.chosen_exec[0] == min(sorted(entry.exec_timings[0]),
                                           key=entry.exec_timings[0].get)
        assert np.isclose(v0, v1, rtol=1e-5)

    def test_same_timings_same_choice_after_reload(self, tmp_path):
        x = torch.linspace(0.0, 1.0, 60_000)
        _run_port(x)
        _run_port(x)
        (entry,) = tpc.entries()
        first_pick = entry.chosen_exec[0]
        path = str(tmp_path / "plans.json")
        tpc.save(path)
        for _ in range(3):
            tpc.clear()
            tpc.load(path)
            (e2,) = tpc.entries()
            del e2.chosen_exec[0]
            _, ctx = _run_port(x, autotune=False)
            assert ctx.stats[f"auto_pick_{first_pick}"] == 1
            assert e2.chosen_exec == {}

    def test_auto_respects_explicit_batch_elements(self):
        x = torch.linspace(0.0, 1.0, 10_000)
        want = float(np.sum(np.exp(np.linspace(0.0, 1.0, 10_000, dtype=np.float32)) * 0.5))
        for _ in range(3):
            v, ctx = _run_port(x, batch_elements=1024)
        assert np.isclose(v, want, rtol=1e-5)
        assert not tpc.tuned_batches()

    def test_dynamic_stage_excludes_traced_strategies(self, same_dispatch):
        ctx = tmozart.MozartContext(executor="auto", device="cpu", chip=TTINY)
        _j, f = _pair(100_000, 12, 3, 24.0, True, False, False)
        assert set(tcm.candidates(f, ctx)) == {"pipelined", "eager"}

    def test_every_candidate_is_sampled_on_one_size(self, monkeypatch):
        """The measurement samples every candidate of a stage on the largest
        size any of them asks for: one that needs the whole value (as
        ``cuda``'s single launch does) sets it for the others too."""
        from repro_torch.core.executor import EagerExecutor
        from repro_torch.core.stage_exec import StageExecutor
        x = torch.linspace(0.0, 1.0, 60_000)
        seen = []
        orig = StageExecutor.sampled_time

        def spy(self, stage, concrete, ctx, batch, n, elems=None):
            seen.append((self.name, elems))
            return orig(self, stage, concrete, ctx, batch, n, elems)
        monkeypatch.setattr(StageExecutor, "sampled_time", spy)
        monkeypatch.setattr(EagerExecutor, "sample_elems",
                            lambda self, stage, concrete, ctx, batch, n: n)
        _run_port(x)
        _, ctx = _run_port(x)
        assert ctx.stats["auto_measured_stages"] == 1
        assert len(seen) >= 2 and "eager" in {name for name, _e in seen}
        assert {e for _name, e in seen} == {60_000}

    def test_a_failing_candidate_raises_while_measured(self, monkeypatch):
        """A kernel fault raised while ``auto`` measures a candidate
        propagates (the claim is released); any other probe error is
        swallowed, counted (``swallowed_errors``) and leaves that candidate
        unscored, as the reference's ``note_swallowed("auto_measure")``."""
        from repro_torch.core import resilience
        from repro_torch.core.executor import FusedExecutor
        from repro_torch.kernels.build import KernelError
        x = torch.linspace(0.0, 1.0, 60_000)
        _run_port(x)

        def fault(self, *a, **k):
            raise KernelError("fused sample failed")
        monkeypatch.setattr(FusedExecutor, "sampled_time", fault)
        with pytest.raises(KernelError, match="fused sample failed"):
            _run_port(x)
        (entry,) = tpc.entries()
        assert entry.chosen_exec == {}          # the claim was released

        def boom(self, *a, **k):
            raise RuntimeError("fused sample failed")
        monkeypatch.setattr(FusedExecutor, "sampled_time", boom)
        resilience.clear_events()
        v, ctx = _run_port(x)
        assert ctx.stats["swallowed_errors"] == 1
        assert resilience.stats["swallowed:auto_measure"] == 1
        assert "fused" not in entry.exec_timings.get(0, {})
        assert entry.chosen_exec and "fused" not in entry.chosen_exec.values()
        assert v == pytest.approx(float((torch.exp(x) * 0.5).sum()), rel=1e-4)
        resilience.clear_events()


class TestAutoReMeasurementAging:
    def test_pins_record_their_shape_regime(self):
        x = torch.linspace(0.0, 1.0, 30_000)
        p = tmozart.pipeline(lambda: anp.sum(anp.exp(x)), executor="auto",
                             device="cpu", chip=TTINY)
        p.lower().compile()
        entry = p.plan_entry
        assert entry.chosen_exec
        for sid in entry.chosen_exec:
            assert entry.exec_meta[sid] == {"n": 30_000, "bucket": (30_000).bit_length()}

    def test_stale_pin_is_remeasured_on_drift(self, monkeypatch):
        n = 1 << 16
        x = torch.linspace(0.0, 1.0, n)
        p = tmozart.pipeline(lambda: anp.multiply(anp.exp(x), 0.5),
                             executor="auto", device="cpu", chip=TTINY)
        p.lower().compile()
        entry = p.plan_entry
        (sid, _), = list(entry.chosen_exec.items())
        entry.exec_meta[sid] = {"n": 101, "bucket": (101).bit_length()}
        monkeypatch.setattr(tcm, "drifted_past_crossover", lambda feats, meta, ctx: True)
        p()
        assert p.ctx.stats["auto_repinned_drift"] == 1
        assert entry.chosen_exec and entry.exec_meta[sid]["n"] == n
        monkeypatch.undo()
        p()
        assert p.ctx.stats["auto_repinned_drift"] == 1
        assert p.last_call_stats.get("auto_measured_stages", 0) == 0

    def test_same_winner_drift_refreshes_regime_without_remeasuring(self):
        n = 1 << 16
        x = torch.linspace(0.0, 1.0, n)
        p = tmozart.pipeline(lambda: anp.multiply(anp.exp(x), 0.5),
                             executor="auto", device="cpu", chip=TTINY)
        p.lower().compile()
        entry = p.plan_entry
        (sid, _), = list(entry.chosen_exec.items())
        entry.exec_meta[sid] = {"n": 101, "bucket": (101).bit_length()}
        p()
        assert p.ctx.stats.get("auto_repinned_drift", 0) == 0
        assert p.last_call_stats.get("auto_measured_stages", 0) == 0
        assert entry.exec_meta[sid]["n"] == n

    def test_periodic_recheck_consumes_its_flag(self, monkeypatch):
        monkeypatch.setenv("MOZART_REANALYZE_EVERY", "1")
        x = torch.linspace(0.0, 1.0, 30_000)
        for _ in range(3):
            _, ctx = _run_port(x)
        (entry,) = tpc.entries()
        assert ctx.stats["reanalysis_ticks"] == 1
        assert entry.recheck_stages == set()
        assert ctx.stats.get("auto_repinned_periodic", 0) == 0   # same winner


class TestDispatchCalibration:
    def test_measured_once_per_device_and_positive(self):
        a = thw.measured_dispatch_overhead_s("cpu")
        b = thw.measured_dispatch_overhead_s("cpu")
        assert a == b > 0

    def test_effective_overhead_blends_constant_with_measurement(self):
        m = thw.measured_dispatch_overhead_s("cpu")
        c = TTINY.dispatch_overhead_s
        eff = thw.effective_dispatch_overhead_s(TTINY, "cpu")
        assert np.isclose(eff, np.sqrt(m * c), rtol=1e-9)
        assert min(m, c) <= eff <= max(m, c)

    def test_cost_model_uses_calibrated_overhead(self):
        _j, f = _pair(100_000, 12, 3, 24.0, False, True, False)
        eff = thw.effective_dispatch_overhead_s(TTINY, "cpu")
        got = tcm.analytic_seconds("scan", f, TTINY, "cpu")
        stream = max(100_000 * 12 / TTINY.hbm_bandwidth,
                     100_000 * 24.0 / TTINY.peak_bf16_flops)
        assert np.isclose(got, stream + eff, rtol=1e-9)
