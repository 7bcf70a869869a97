"""The port's resilience layer (``repro_torch/core/resilience.py``) held
against the JAX package's (``src/repro/core/resilience.py``): deterministic
fault injection, the executor degradation ladder, chunk-granular OOM
recovery, plan-cache quarantine and its persistence, the serving failure
domain and the step-level helpers.

The spine is differential: the same fault spec on both packages, on the
same numpy inputs (the port on the CPU, where ``cuda`` runs the kernel's
plain version; JAX with ``pallas`` where the port has ``cuda``), fires at
the same crossings and recovers with the same counts (``exec_demotions``,
``exec_quarantine_skips``, ``chunk_oom_halvings``, the quarantined
executors, the MZ4xx counters), and every faulted run returns the
fault-free eager oracle's answer within float32 2e-5 (sums 1e-5).  Both
ladders have a ``sharded`` rung between ``pallas``/``cuda`` and ``scan``
that fails without a mesh, so a mesh-less walk from the top is
``cuda -> sharded -> scan`` on both; the sweep also runs ``sharded`` on a
one-rank mesh on each side.

Port-only: a kernel fault (``KernelError``, a CUDA error) propagates out of
``cuda`` sessions and ``Pipeline`` calls with no demotion, quarantine or
swallow; on ``cuda`` only injected faults and resource exhaustion demote;
``torch.OutOfMemoryError`` is resource exhaustion; a failed attempt is
re-driven when it counted a donation point but released no stream, never
when it released one.  ``test_sanitizer_errors_are_never_demoted_around``
and the MZ4xx events as ``Diagnostic``s are held in
``tests/test_torch_sanitizer.py``.
"""

import asyncio
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Along as JAlong
from repro.core import annotated_numpy as janp
from repro.core import mozart as jmozart
from repro.core import plan_cache as jpc
from repro.core import resilience as jres
from repro.core import splittable as jsplittable
from repro.core.serving import AsyncServer as JAsyncServer
from repro.core.serving import ContinuousBatcher as JBatcher
from repro_torch.core import Along as TAlong
from repro_torch.core import annotated_numpy as tanp
from repro_torch.core import mozart as tmozart
from repro_torch.core import plan_cache as tpc
from repro_torch.core import resilience
from repro_torch.core import splittable as tsplittable
from repro_torch.core.resilience import (FaultConfig, FaultPlan, FaultSpec,
                                         InjectedFault, InjectedResourceExhausted,
                                         StepFailure, StepTimer, run_with_restarts,
                                         with_retries)
from repro_torch.core.serving import AsyncServer, ContinuousBatcher
from repro_torch.kernels import build as kernel_build
from repro_torch.kernels import split_pipeline as tsp
from repro_torch.kernels.build import KernelError

from sharded_scenarios import jax_mesh, port_mesh
from test_torch_plan_cache import JTINY, TTINY
from test_torch_serving import MAX_LEN, _carry
from repro.configs.registry import get_smoke_config as jsmoke

JAX_OF = {"cuda": "pallas"}
PORT_OF = {"pallas": "cuda"}


@pytest.fixture(autouse=True)
def _fresh():
    """Disarm fault plans and zero the counters on both sides; empty the
    port's plan cache (tests/conftest.py empties the JAX one)."""
    for r in (resilience, jres):
        r.clear_faults()
        r.clear_events()
    tpc.clear()
    yield
    for r in (resilience, jres):
        r.clear_faults()
        r.clear_events()
    tpc.clear()


@jsplittable(x=JAlong(0), y=JAlong(0), ret=JAlong(0), elementwise=True, name="saxpy")
def jsaxpy(x, y):
    return 2.0 * x + y


@tsplittable(x=TAlong(0), y=TAlong(0), ret=TAlong(0), elementwise=True, name="saxpy")
def tsaxpy(x, y):
    return 2.0 * x + y


def quickstart(saxpy, anp):
    def f(x, y):
        c = anp.multiply(anp.exp(saxpy(x, y)), 0.5)
        return c, anp.sum(c)
    return f


def chain3(saxpy, anp):
    """A multi-stage pipeline: the scalar reduction forces a stage break, so
    downstream stages ingest upstream results."""
    def f(x, y):
        a = saxpy(x, y)
        s = anp.sum(a)
        b = anp.multiply(x, 0.5)
        c = anp.subtract(b, s)
        return anp.sum(anp.exp(anp.multiply(c, 0.01)))
    return f


N = 4096
XN = np.arange(N, dtype=np.float32) / N
YN = np.ones(N, np.float32)
JQ, TQ = quickstart(jsaxpy, janp), quickstart(tsaxpy, tanp)
JC3, TC3 = chain3(jsaxpy, janp), chain3(tsaxpy, tanp)


@pytest.fixture(scope="module")
def oracle():
    """Fault-free JAX eager results for both pipelines."""
    with jmozart.session(executor="eager"):
        c, s = JQ(jnp.asarray(XN), jnp.asarray(YN))
        q = (np.asarray(c), float(s))
        t = float(JC3(jnp.asarray(XN), jnp.asarray(YN)))
    return q, t


def _port_quickstart(executor, **kw):
    if executor == "sharded":
        kw["mesh"] = port_mesh()
    with tmozart.session(executor=executor, device="cpu", **kw) as ctx:
        c, s = TQ(torch.from_numpy(XN), torch.from_numpy(YN))
        got = (c.value.numpy(), float(s.value))
    return got, ctx


def _jax_quickstart(executor, **kw):
    if executor == "sharded":
        kw["mesh"] = jax_mesh()
    with jmozart.session(executor=JAX_OF.get(executor, executor), **kw) as ctx:
        c, s = JQ(jnp.asarray(XN), jnp.asarray(YN))
        got = (np.asarray(c), float(s))
    return got, ctx


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=1e-6)
    assert np.isclose(got[1], want[1], rtol=1e-5)


RECOVERY = ("exec_demotions", "exec_quarantine_skips", "chunk_oom_halvings",
            "swallowed_errors")


def _as_port(stats: dict, quarantined: list) -> tuple[dict, list]:
    """The reference's recovery counts and quarantines as the port shows
    them: pallas is cuda, every other rung (``sharded`` among them) as it is."""
    out = {k: stats.get(k, 0) for k in RECOVERY}
    quar = [{sid: {PORT_OF.get(n, n) for n in names}
             for sid, names in q.items()} for q in quarantined]
    return out, quar


def _quarantined(entries):
    return [{sid: set(ages) for sid, ages in e.quarantined.items()} for e in entries]


def _mz(stats, codes=("MZ401", "MZ402", "MZ403", "MZ404", "MZ406")):
    return {c: stats.get(c, 0) for c in codes}


def _where(fired):
    return [(b, w.replace("pallas", "cuda")) for b, w in fired]


# ---------------------------------------------------------------------------
# Fault plans: parsing, firing, arming
# ---------------------------------------------------------------------------


class TestFaultPlan:
    def test_parse_defaults_and_fields_like_jax(self):
        for spec in ("compile", "chunk:oom:2, merge:fail:1:stage 0", "chunk:fail:1+3",
                     "persist:fail:1,serve_step"):
            t, j = FaultPlan.parse(spec), jres.FaultPlan.parse(spec)
            assert [vars(s) for s in t.specs] == [vars(s) for s in j.specs]
        assert FaultPlan.parse("compile").specs == [FaultSpec("compile", "fail", 1, "", 0)]
        assert resilience.BOUNDARIES == jres.BOUNDARIES

    def test_unknown_boundary_and_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown fault boundary"):
            FaultPlan.parse("warp-drive:fail:1")
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultPlan.parse("chunk:frobnicate:1")

    def test_fires_count_times_then_disarms(self):
        p = FaultPlan.parse("merge:fail:2")
        for _ in range(2):
            with pytest.raises(InjectedFault):
                p.check("merge", "stage 0")
        p.check("merge", "stage 0")
        assert p.fired == [("merge", "stage 0")] * 2
        assert resilience.stats["MZ401"] == 2

    def test_match_and_after_filter_crossings(self):
        p = FaultPlan.parse("merge:fail:1:stage 2")
        p.check("merge", "stage 0")
        with pytest.raises(InjectedFault):
            p.check("merge", "stage 2")
        p = FaultPlan.parse("chunk:fail:1+2")
        p.check("chunk", "a")
        p.check("chunk", "b")
        with pytest.raises(InjectedFault):
            p.check("chunk", "c")

    def test_oom_kind_raises_resource_exhausted(self):
        with pytest.raises(InjectedResourceExhausted) as ei:
            FaultPlan.parse("chunk:oom:1").check("chunk", "x")
        assert resilience.is_resource_exhausted(ei.value)
        assert isinstance(ei.value, InjectedFault)

    def test_inject_faults_nests_and_restores(self):
        with tmozart.inject_faults("merge:fail:1") as outer:
            with tmozart.inject_faults("split:fail:1") as inner:
                resilience.maybe_fail("merge")
                with pytest.raises(InjectedFault):
                    resilience.maybe_fail("split")
            assert inner.fired and not outer.fired
            with pytest.raises(InjectedFault):
                resilience.maybe_fail("merge")
        resilience.maybe_fail("merge")

    def test_env_plan_fires_once_and_stays_spent(self, monkeypatch):
        monkeypatch.setenv("MOZART_FAULTS", "merge:fail:1")
        with pytest.raises(InjectedFault):
            resilience.maybe_fail("merge", "env")
        resilience.maybe_fail("merge", "env")
        assert resilience.stats["MZ401"] == 1

    def test_is_resource_exhausted(self):
        assert resilience.is_resource_exhausted(MemoryError())
        assert resilience.is_resource_exhausted(
            RuntimeError("RESOURCE_EXHAUSTED: out of memory on device"))
        assert not resilience.is_resource_exhausted(RuntimeError("boom"))

    def test_torch_out_of_memory_is_resource_exhaustion(self):
        e = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        assert resilience.is_resource_exhausted(e)
        assert resilience.is_resource_exhausted(torch.OutOfMemoryError("x"))
        assert not resilience.is_kernel_fault(e)


# ---------------------------------------------------------------------------
# Chaos sweep: injected boundary faults, parity with the JAX package
# ---------------------------------------------------------------------------

SWEEP_EXECUTORS = ("pipelined", "fused", "scan", "cuda", "sharded", "auto")
SWEEP_BOUNDARIES = ("split", "chunk", "compile", "ingest", "merge")


@pytest.mark.parametrize("executor", SWEEP_EXECUTORS)
@pytest.mark.parametrize("boundary", SWEEP_BOUNDARIES)
def test_boundary_fault_parity_with_jax(executor, boundary, oracle):
    """A fault at the first crossing of each boundary fires where the
    reference's fires, recovers with the reference's counts and returns the
    fault-free answer."""
    (want_c, want_s), _ = oracle
    spec = f"{boundary}:fail:1"
    with jmozart.inject_faults(spec) as jplan:
        jgot, jctx = _jax_quickstart(executor, batch_elements=512)
    jquar = _quarantined(jpc.entries())
    with tmozart.inject_faults(spec) as tplan:
        tgot, tctx = _port_quickstart(executor, batch_elements=512)
    _check(tgot, (want_c, want_s))
    _check(jgot, (want_c, want_s))
    assert _where(tplan.fired) == _where(jplan.fired)
    want_counts, want_quar = _as_port(jctx.stats, jquar)
    assert {k: tctx.stats.get(k, 0) for k in RECOVERY} == want_counts
    assert _quarantined(tpc.entries()) == want_quar
    assert _mz(resilience.stats) == _mz(jres.stats)
    if tplan.fired:
        assert resilience.stats["MZ401"] == 1 and tctx.stats["exec_demotions"] >= 1


def test_cuda_compile_fault_demotes_once_to_scan(oracle):
    """The reference's walk: ``cuda`` -> ``sharded`` (no mesh: it raises)
    -> ``scan``, one MZ402 and one MZ404 per rung, both quarantined; with a
    mesh the same fault demotes once, to a ``sharded`` stage that runs."""
    with tmozart.inject_faults("compile:fail:1"):
        got, ctx = _port_quickstart("cuda", batch_elements=512)
    _check(got, oracle[0])
    assert ctx.stats["exec_demotions"] == 2
    assert ctx.stats["exec_demoted_to_sharded"] == 1 and ctx.stats["exec_demoted_to_scan"] == 1
    assert ctx.stats.get("cuda_stages", 0) == 0 and ctx.stats.get("sharded_stages", 0) == 0
    assert _quarantined(tpc.entries()) == [{0: {"cuda", "sharded"}}]
    assert resilience.stats["MZ402"] == resilience.stats["MZ404"] == 2
    tpc.clear()
    with tmozart.inject_faults("compile:fail:1"):
        got, ctx = _port_quickstart("cuda", batch_elements=512, mesh=port_mesh())
    _check(got, oracle[0])
    assert ctx.stats["exec_demotions"] == ctx.stats["exec_demoted_to_sharded"] == 1
    assert ctx.stats["sharded_stages"] == 1


@pytest.mark.parametrize("executor", ("fused", "scan"))
@pytest.mark.parametrize("spec", ("merge:fail:1+1", "merge:fail:1+2"))
def test_attempt_that_released_a_stream_is_not_redriven_like_jax(executor, spec):
    """The handoff chain's later evaluations consume (release) the previous
    evaluation's stream before their merge: a merge fault there propagates
    on both packages, never re-driving released buffers."""
    def chain(session, anp, mozart, arr):
        with session(executor=executor, batch_elements=4096) as ctx:
            cur = arr(np.linspace(0.0, 1.0, 20_000, dtype=np.float32))
            for _ in range(3):
                cur = anp.multiply(anp.add(cur, 1.0), 0.5)
                mozart.evaluate()
        return ctx

    with jmozart.inject_faults(spec) as jplan:
        with pytest.raises(jres.InjectedFault):
            chain(jmozart.session, janp, jmozart, jnp.asarray)
    with tmozart.inject_faults(spec) as tplan:
        with pytest.raises(InjectedFault):
            chain(lambda **kw: tmozart.session(device="cpu", **kw), tanp, tmozart,
                  torch.from_numpy)
    assert tplan.fired == jplan.fired
    assert _mz(resilience.stats) == _mz(jres.stats) == {
        "MZ401": 1, "MZ402": 0, "MZ403": 0, "MZ404": 0, "MZ406": 0}


def test_counted_donation_without_release_is_redriven():
    """On ``cuda`` the handoff chain counts donation points but releases no
    stream (the kernel's outputs are whole tensors): an injected launch
    failure there demotes, where the reference (which counts the donation
    as done) refuses."""
    calls = {"n": 0}
    real = tsp._launch

    def launch_once_failing(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise InjectedFault("injected launch failure")
        return real(*a, **kw)

    x = np.linspace(0.0, 1.0, 20_000, dtype=np.float32)
    want = ((x + 1.0) * 0.5 + 1.0) * 0.5
    mp = pytest.MonkeyPatch()
    mp.setattr(tsp, "_launch", launch_once_failing)
    try:
        with tmozart.session(executor="cuda", device="cpu", batch_elements=4096) as ctx:
            cur = torch.from_numpy(x)
            for _ in range(2):
                cur = tanp.multiply(tanp.add(cur, 1.0), 0.5)
                tmozart.evaluate()
            got = cur.value.numpy()
    finally:
        mp.undo()
    assert ctx.stats["donated_chunks"] >= 1 and ctx.stats.get("streams_released", 0) == 0
    assert ctx.stats["exec_demotions"] == 2 and ctx.stats["exec_demoted_to_scan"] == 1
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_donation_counter_and_release_counter_decide_recovery():
    class _Ctx:
        def __init__(self, **stats):
            self.stats = dict(stats)

    # a counted donation point alone: still recoverable
    assert resilience._recoverable(RuntimeError("x"), _Ctx(donated_chunks=3), 0)
    # a released stream: never re-driven
    assert not resilience._recoverable(RuntimeError("x"), _Ctx(streams_released=1), 0)
    assert resilience._recoverable(RuntimeError("x"), _Ctx(streams_released=1), 1)
    # on cuda only injected faults (an injected OOM among them), never a
    # real memory exhaustion
    assert not resilience._recoverable(RuntimeError("x"), _Ctx(), 0, "cuda")
    assert resilience._recoverable(InjectedFault("x"), _Ctx(), 0, "cuda")
    assert resilience._recoverable(InjectedResourceExhausted("x"), _Ctx(), 0, "cuda")
    assert not resilience._recoverable(torch.OutOfMemoryError("x"), _Ctx(), 0, "cuda")
    assert resilience._recoverable(torch.OutOfMemoryError("x"), _Ctx(), 0, "fused")
    # kernel faults never
    for e in (KernelError("nvcc failed"),
              RuntimeError("CUDA error: an illegal memory access was encountered")):
        assert resilience.is_kernel_fault(e)
        assert not resilience._recoverable(e, _Ctx(), 0)
        assert not resilience._recoverable(e, _Ctx(), 0, "fused")


def test_handoff_chain_fault_parity(oracle):
    _, want = oracle
    with jmozart.inject_faults("ingest:fail:1") as jplan:
        with jmozart.session(executor="fused", batch_elements=512) as jctx:
            jgot = float(JC3(jnp.asarray(XN), jnp.asarray(YN)))
    with tmozart.inject_faults("ingest:fail:1") as tplan:
        with tmozart.session(executor="fused", device="cpu", batch_elements=512) as tctx:
            tgot = float(TC3(torch.from_numpy(XN), torch.from_numpy(YN)).value)
    assert np.isclose(tgot, want, rtol=1e-5) and np.isclose(jgot, want, rtol=1e-5)
    assert tplan.fired == jplan.fired
    assert {k: tctx.stats.get(k, 0) for k in RECOVERY + ("stages",)} == \
        {k: jctx.stats.get(k, 0) for k in RECOVERY + ("stages",)}


def test_compile_fault_demotes_and_quarantines_like_jax(oracle):
    """fused -> pipelined, MZ402/MZ404, and the next call skips the
    quarantined executor, on both packages alike."""
    got = {}
    for name, session, run in (
            ("jax", jmozart.session,
             lambda: JQ(jnp.asarray(XN), jnp.asarray(YN))),
            ("port", lambda **kw: tmozart.session(device="cpu", **kw),
             lambda: TQ(torch.from_numpy(XN), torch.from_numpy(YN)))):
        inject = jmozart.inject_faults if name == "jax" else tmozart.inject_faults
        with session(executor="fused", batch_elements=512) as ctx:
            with inject("compile:fail:1") as plan:
                c, s = run()
                first = (np.asarray(c) if name == "jax" else c.value.numpy(), float(s))
            assert plan.fired
            skips = ctx.stats["exec_quarantine_skips"]
            c2, s2 = run()
            second = (np.asarray(c2) if name == "jax" else c2.value.numpy(), float(s2))
            got[name] = ({k: ctx.stats.get(k, 0) for k in RECOVERY}, skips,
                         ctx.stats["exec_quarantine_skips"])
        _check(first, oracle[0])
        _check(second, oracle[0])
    assert got["port"] == got["jax"]
    assert got["port"][0]["exec_demotions"] == 1 and got["port"][2] > got["port"][1]
    assert _mz(resilience.stats) == _mz(jres.stats)
    assert _quarantined(tpc.entries()) == _quarantined(jpc.entries()) == [{0: {"fused"}}]


def test_chunk_oom_halves_batch_and_repins_like_jax(oracle):
    with jmozart.inject_faults("chunk:oom:1"):
        jgot, jctx = _jax_quickstart("fused", batch_elements=512)
    jtuned = set(jpc.tuned_batches().values())
    with tmozart.inject_faults("chunk:oom:1") as plan:
        tgot, tctx = _port_quickstart("fused", batch_elements=512)
    _check(tgot, oracle[0])
    assert plan.fired
    assert tctx.stats["chunk_oom_halvings"] == jctx.stats["chunk_oom_halvings"] == 1
    assert tctx.stats.get("exec_demotions", 0) == 0
    assert resilience.stats["MZ403"] == jres.stats["MZ403"] == 1
    assert set(tpc.tuned_batches().values()) == jtuned == {256}


def test_sustained_oom_bounded_then_ladder_finishes_on_eager_like_jax(oracle):
    with jmozart.inject_faults("chunk:oom:999"):
        jgot, jctx = _jax_quickstart("fused", batch_elements=512)
    with tmozart.inject_faults("chunk:oom:999"):
        tgot, tctx = _port_quickstart("fused", batch_elements=512)
    _check(tgot, oracle[0])
    assert tctx.stats["exec_demoted_to_eager"] == 1
    assert tctx.stats["chunk_oom_halvings"] <= 2 * resilience.MAX_OOM_HALVINGS
    assert {k: tctx.stats.get(k, 0) for k in RECOVERY + ("exec_demoted_to_eager",)} == \
        {k: jctx.stats.get(k, 0) for k in RECOVERY + ("exec_demoted_to_eager",)}


def test_real_out_of_memory_halves_the_batch():
    """A ``torch.OutOfMemoryError`` from a library call (not injected) is
    resource exhaustion: the chunk loop halves and completes."""
    state = {"armed": True}

    @tsplittable(x=TAlong(0), ret=TAlong(0), elementwise=True, name="hungry")
    def hungry(x):
        if state["armed"] and x.shape[0] > 256 and x.device.type != "meta":
            state["armed"] = False
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.00 GiB")
        return x * 2.0

    x = torch.linspace(0.0, 1.0, 2048)
    with tmozart.session(executor="fused", device="cpu", batch_elements=512) as ctx:
        got = hungry(x).value
    assert ctx.stats["chunk_oom_halvings"] == 1 and ctx.stats.get("exec_demotions", 0) == 0
    np.testing.assert_allclose(got.numpy(), x.numpy() * 2.0)


def test_demotion_ladder_order():
    assert resilience.DEGRADE_ORDER == tuple(PORT_OF.get(n, n) for n in jres.DEGRADE_ORDER)
    assert resilience.demotion_ladder("cuda") == [
        "sharded", "scan", "fused", "pipelined", "eager"]
    assert resilience.demotion_ladder("eager") == []
    assert resilience.demotion_ladder("auto") == list(resilience.DEGRADE_ORDER)
    assert resilience.MAX_OOM_HALVINGS == jres.MAX_OOM_HALVINGS


# ---------------------------------------------------------------------------
# Kernel faults: never demoted around, swallowed or retried
# ---------------------------------------------------------------------------


def _kernel_build_fails(monkeypatch):
    """The card's launch path on the CPU: every kernel launch first loads
    the library (``split_pipeline._load``), whose build fails."""
    def nvcc_fails(source):
        raise KernelError(f"nvcc failed on {source.name} (1)")

    def launch_on_the_card(*a, **kw):
        tsp._load()
        raise AssertionError("unreachable: the build failed")

    monkeypatch.setattr(kernel_build, "build", nvcc_fails)
    monkeypatch.delitem(kernel_build._libs, tsp.SOURCE, raising=False)
    monkeypatch.setattr(tsp, "_launch", launch_on_the_card)


@pytest.mark.parametrize("autotune", (False, True))
def test_kernel_build_failure_propagates_from_a_session(monkeypatch, autotune):
    """Also from the tuner's sampled runs (the tiny chip gives the first hit
    several tiles to time): ``note_swallowed`` re-raises the fault."""
    tiny = TTINY
    x, y = torch.from_numpy(np.tile(XN, 8)), torch.from_numpy(np.tile(YN, 8))
    with tmozart.session(executor="cuda", device="cpu", chip=tiny) as ctx:
        float(TQ(x, y)[1].value)                   # the miss: plans, no tuning
    _kernel_build_fails(monkeypatch)
    seen = []
    real = resilience.note_swallowed
    monkeypatch.setattr(resilience, "note_swallowed",
                        lambda where, e, ctx=None: (seen.append(where), real(where, e, ctx)))
    with pytest.raises(KernelError, match="nvcc failed"):
        with tmozart.session(executor="cuda", device="cpu", chip=tiny,
                             autotune=autotune) as ctx:
            float(TQ(x, y)[1].value)
    assert seen == (["tune_sample"] if autotune else [])
    assert ctx.stats.get("exec_demotions", 0) == 0
    assert ctx.stats.get("swallowed_errors", 0) == 0
    assert resilience.stats["swallowed_errors"] == 0 and resilience.stats["MZ402"] == 0
    assert all(not e.quarantined for e in tpc.entries())


@pytest.mark.parametrize("fast", (False, True))
def test_kernel_build_failure_propagates_from_a_pipeline(monkeypatch, fast):
    p = tmozart.pipeline(TQ, executor="cuda", device="cpu", arg_transparent=fast)
    x, y = torch.from_numpy(XN), torch.from_numpy(YN)
    p.lower(x, y).compile()
    p(x, y)
    _kernel_build_fails(monkeypatch)
    tpc.clear()                                    # the lowering is rebuilt too
    for _ in range(2):
        with pytest.raises(KernelError, match="nvcc failed"):
            p(x, y)
    assert p.stats.get("exec_demotions", 0) == 0 and p.stats.get("swallowed_errors", 0) == 0
    assert resilience.stats["swallowed_errors"] == 0
    assert all(not e.quarantined for e in tpc.entries())


def test_other_errors_on_cuda_propagate_but_demote_on_fused(monkeypatch):
    """On ``cuda`` only injected faults and resource exhaustion demote; the
    chunk-loop drivers keep the reference's wider rule."""
    def boom(*a, **kw):
        raise RuntimeError("launch refused")
    monkeypatch.setattr(tsp, "_launch", boom)
    with pytest.raises(RuntimeError, match="launch refused"):
        _port_quickstart("cuda", batch_elements=512)
    assert resilience.stats["MZ402"] == 0

    state = {"armed": True}

    @tsplittable(x=TAlong(0), ret=TAlong(0), elementwise=True, name="flaky")
    def flaky(x):
        if state["armed"] and x.device.type != "meta":
            state["armed"] = False
            raise RuntimeError("library hiccup")
        return x + 1.0

    x = torch.linspace(0.0, 1.0, 1024)
    with tmozart.session(executor="fused", device="cpu", batch_elements=256) as ctx:
        got = flaky(x).value
    assert ctx.stats["exec_demotions"] == 1 and ctx.stats["exec_demoted_to_pipelined"] == 1
    np.testing.assert_allclose(got.numpy(), x.numpy() + 1.0)


def _kernel_runs_out_of_memory(monkeypatch):
    def launch_out_of_memory(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    monkeypatch.setattr(tsp, "_launch", launch_out_of_memory)


@pytest.mark.parametrize("fast", (False, True))
def test_real_out_of_memory_on_cuda_propagates(monkeypatch, fast):
    """A real memory exhaustion in the kernel's wrapper is not routed around:
    no demotion to plain PyTorch, no quarantine (persisted or not), from a
    session and from a ``Pipeline`` call alike."""
    x, y = torch.from_numpy(XN), torch.from_numpy(YN)
    p = tmozart.pipeline(TQ, executor="cuda", device="cpu", arg_transparent=fast)
    p.lower(x, y).compile()
    p(x, y)
    _kernel_runs_out_of_memory(monkeypatch)
    with pytest.raises(torch.OutOfMemoryError):
        _port_quickstart("cuda", batch_elements=512)
    for _ in range(2):
        with pytest.raises(torch.OutOfMemoryError):
            p(x, y)
    assert p.stats.get("exec_demotions", 0) == 0
    assert p.stats.get("exec_quarantine_skips", 0) == 0
    assert resilience.stats["MZ402"] == 0 and resilience.stats["MZ404"] == 0
    assert resilience.stats["swallowed_errors"] == 0
    assert all(not e.quarantined for e in tpc.entries())


def test_auto_does_not_skip_a_cuda_candidate_out_of_memory(monkeypatch, oracle):
    """``auto`` leaves a failing candidate unscored, except ``cuda``: there
    only an injected fault is skipped, a real OOM propagates.  (The equal
    analytic scores keep ``cuda`` among the candidates ``auto`` measures on
    its first warm call.)"""
    from repro_torch.core import cost_model
    real = cost_model.analytic_seconds
    # every candidate scores alike; ``sharded`` keeps its real (infinite,
    # mesh-less) score
    monkeypatch.setattr(cost_model, "analytic_seconds",
                        lambda name, *a, **k: real(name, *a, **k) if name == "sharded" else 1.0)
    _port_quickstart("auto", batch_elements=512)
    _kernel_runs_out_of_memory(monkeypatch)
    with pytest.raises(torch.OutOfMemoryError):
        _port_quickstart("auto", batch_elements=512)
    assert resilience.stats["swallowed_errors"] == 0
    assert all(not e.chosen_exec and not e.quarantined for e in tpc.entries())

    def injected(*a, **kw):
        raise InjectedFault("injected launch failure")
    monkeypatch.setattr(tsp, "_launch", injected)
    got, ctx = _port_quickstart("auto", batch_elements=512)
    _check(got, oracle[0])
    assert ctx.stats["auto_measured_stages"] == 1
    assert ctx.stats["swallowed_errors"] == 1
    assert resilience.stats["swallowed:auto_measure"] == 1
    (entry,) = tpc.entries()
    assert "cuda" not in entry.exec_timings[0] and entry.chosen_exec[0] != "cuda"


def test_note_swallowed_is_counted_and_evented_but_reraises_kernel_faults():
    resilience.note_swallowed("unit_test", ValueError("nope"))
    assert resilience.stats["swallowed_errors"] == 1
    assert resilience.stats["swallowed:unit_test"] == 1
    ev = resilience.events()
    assert any(d.code == "MZ406" and "unit_test" in d.subject for d in ev)
    from repro_torch.core.analysis import CODES
    assert ev[-1].message == CODES["MZ406"]
    with pytest.raises(KernelError):
        resilience.note_swallowed("unit_test", KernelError("launch failed"))
    assert resilience.stats["swallowed_errors"] == 1


def test_tuner_swallows_a_failing_candidate_like_jax():
    """An unsampleable candidate is skipped and counted by the tuner."""
    from repro.core.stage_exec import StageExecutor as JSE
    from repro_torch.core.stage_exec import StageExecutor as TSE
    got = {}
    for name, cls, session, run in (
            ("jax", JSE, lambda: jmozart.session(executor="fused", chip=JTINY),
             lambda: float(JQ(jnp.asarray(XN), jnp.asarray(YN))[1])),
            ("port", TSE, lambda: tmozart.session(executor="fused", chip=TTINY, device="cpu"),
             lambda: float(TQ(torch.from_numpy(XN), torch.from_numpy(YN))[1].value))):
        real = cls.sampled_time
        seen = {"n": 0}

        def first_fails(self, *a, _real=real, _seen=seen, **kw):
            _seen["n"] += 1
            if _seen["n"] == 1:
                raise ValueError("unsampleable")
            return _real(self, *a, **kw)

        mp = pytest.MonkeyPatch()
        mp.setattr(cls, "sampled_time", first_fails)
        try:
            for _ in range(2):
                with session() as ctx:
                    v = run()
        finally:
            mp.undo()
        got[name] = (ctx.stats.get("swallowed_errors", 0),
                     ctx.stats.get("autotuned_stages", 0), v)
    assert got["port"][:2] == got["jax"][:2] == (1, 1)
    assert np.isclose(got["port"][2], got["jax"][2], rtol=1e-5)
    assert resilience.stats["swallowed:tune_sample"] == jres.stats["swallowed:tune_sample"] == 1


# ---------------------------------------------------------------------------
# Quarantine ageing
# ---------------------------------------------------------------------------


def test_quarantine_ages_out(oracle):
    with tmozart.session(executor="fused", device="cpu", batch_elements=512):
        with tmozart.inject_faults("compile:fail:1"):
            _, s = TQ(torch.from_numpy(XN), torch.from_numpy(YN))
            float(s.value)
        entry = next(e for e in tpc.entries() if e.quarantined)
        (sid,) = [k for k, v in entry.quarantined.items() if "fused" in v]
        assert entry.quarantined_execs(sid) == {"fused"}
        assert entry.tick_quarantine(sid, ttl=2) == {"fused"}
        assert entry.tick_quarantine(sid, ttl=2) == set()
        assert entry.quarantined_execs(sid) == set()
        c, s = TQ(torch.from_numpy(XN), torch.from_numpy(YN))
        np.testing.assert_allclose(c.value.numpy(), oracle[0][0], rtol=2e-5, atol=1e-6)


def test_cuda_quarantine_skips_then_launches_again(monkeypatch, oracle):
    """After a compile fault the warm calls dispatch ``scan`` (counted skips,
    no launch); once ``QUARANTINE_TTL`` dispatches passed, ``cuda`` runs."""
    monkeypatch.setattr(resilience, "QUARANTINE_TTL", 3)
    launches = {"n": 0}
    real = tsp._launch

    def counted(*a, **kw):
        launches["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(tsp, "_launch", counted)
    p = tmozart.pipeline(TQ, executor="cuda", device="cpu")
    x, y = torch.from_numpy(XN), torch.from_numpy(YN)
    with tmozart.inject_faults("compile:fail:1"):
        _check(tuple(v if i == 0 else float(v) for i, v in enumerate(p(x, y))), oracle[0])
    assert p.last_call_stats["exec_demotions"] == 2 and launches["n"] == 0
    trail = []
    for _ in range(3):
        c, s = p(x, y)
        _check((c.numpy(), float(s)), oracle[0])
        trail.append((p.last_call_stats.get("exec_quarantine_skips", 0), launches["n"]))
    assert trail == [(1, 0), (1, 0), (0, 1)]
    assert all(not e.quarantined for e in tpc.entries())


def test_tick_quarantine_multiple_names():
    with tmozart.session(executor="fused", device="cpu", batch_elements=512):
        _, s = TQ(torch.from_numpy(XN), torch.from_numpy(YN))
        float(s.value)
    entry = tpc.entries()[0]
    entry.quarantine_exec(7, "cuda")
    entry.quarantine_exec(7, "scan")
    assert entry.quarantined_execs(7) == {"cuda", "scan"}
    assert entry.tick_quarantine(7, ttl=2) == {"cuda", "scan"}
    assert entry.tick_quarantine(7, ttl=2) == set()
    assert 7 not in entry.quarantined


def test_auto_skips_a_quarantined_pin():
    x, y = torch.from_numpy(XN), torch.from_numpy(YN)
    for _ in range(2):
        with tmozart.session(executor="auto", device="cpu") as ctx:
            float(TQ(x, y)[1].value)
    entry = tpc.entries()[0]
    pinned = entry.chosen_exec[0]
    entry.quarantine_exec(0, pinned)
    with tmozart.session(executor="auto", device="cpu") as ctx:
        float(TQ(x, y)[1].value)
    assert ctx.stats["auto_quarantine_skips"] == 1
    assert ctx.stats.get(f"auto_pick_{pinned}", 0) == 0
    assert entry.chosen_exec[0] == pinned          # the pin stays


# ---------------------------------------------------------------------------
# Plan-cache persistence
# ---------------------------------------------------------------------------


def _warm_cache():
    with tmozart.session(executor="fused", device="cpu", batch_elements=512):
        _, s = TQ(torch.from_numpy(XN), torch.from_numpy(YN))
        float(s.value)


class TestPersistence:
    def test_persist_fault_leaves_existing_file_intact(self, tmp_path):
        path = str(tmp_path / "plans.json")
        _warm_cache()
        assert tpc.save(path, force=True) >= 1
        before = json.loads(open(path).read())
        with tmozart.inject_faults("persist:fail:1") as plan:
            with pytest.raises(InjectedFault):
                tpc.save(path, force=True)
        assert plan.fired == [("persist", str(tmp_path / "plans.json"))]
        assert json.loads(open(path).read()) == before
        assert not list(tmp_path.glob("plans.json.tmp*"))
        tpc.clear()
        assert tpc.load(path) >= 1

    def test_quarantine_round_trips_through_persistence(self, tmp_path):
        path = str(tmp_path / "plans.json")
        _warm_cache()
        tpc.entries()[0].quarantine_exec(0, "cuda")
        assert tpc.save(path, force=True) >= 1
        tpc.clear()
        assert tpc.load(path) >= 1
        assert tpc.entries()[0].quarantined_execs(0) == {"cuda"}

    def test_v5_file_forward_migrates(self, tmp_path):
        path = str(tmp_path / "plans.json")
        _warm_cache()
        assert tpc.save(path, force=True) >= 1
        payload = json.loads(open(path).read())
        payload["schema"] = 5
        for e in payload["entries"]:
            e.pop("quarantined", None)
        open(path, "w").write(json.dumps(payload))
        tpc.clear()
        assert tpc.load(path) >= 1
        assert tpc.stats["persist_migrated_v5"] >= 1
        assert tpc.entries()[0].quarantined == {}


# ---------------------------------------------------------------------------
# The serving failure domain
# ---------------------------------------------------------------------------


def _serve_churn(batcher, server_cls, inject, prompts):
    """The reference's ``smoke/chaos`` serving scenario: a step fault fails
    the first wave's requests visibly, the driver survives, the next wave
    completes."""
    wave1 = [batcher.submit(batcher.make_request(p, 3)) for p in prompts[:2]]
    srv = server_cls(batcher, idle_poll_s=1e-4)
    with inject("serve_step:fail:1"):
        srv.start()
        for r in wave1:
            r.done.wait(120)
        wave2 = [batcher.submit(batcher.make_request(p, 4)) for p in prompts[2:]]
        for r in wave2:
            r.done.wait(120)
    srv.close()
    return wave1, wave2


def _serve_step_fault_like_jax(driver):
    jcfg = jsmoke("internlm2-20b").with_runtime(dtype=jnp.float32)
    params, tcfg, model = _carry(jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32) for p in (5, 7, 4, 6)]
    jb = JBatcher(jcfg, params, batch=2, max_len=MAX_LEN, driver="jit", max_queue=16)
    jw1, jw2 = _serve_churn(jb, JAsyncServer, jmozart.inject_faults, prompts)
    tb = ContinuousBatcher(tcfg, model, batch=2, max_len=MAX_LEN, driver=driver, device="cpu",
                           max_queue=16)
    tw1, tw2 = _serve_churn(tb, AsyncServer, tmozart.inject_faults, prompts)
    assert all(r.finished for r in tw1 + tw2)
    assert all(isinstance(r.error, InjectedFault) for r in tw1)
    assert all(r.error is None and len(r.out) == 4 for r in tw2)
    assert [r.out for r in tw2] == [r.out for r in jw2]
    for k in ("step_failures", "failed_requests"):
        assert tb.stats[k] == jb.stats[k]
    assert tb.stats["step_failures"] == 1 and tb.stats["failed_requests"] == 2
    assert resilience.stats["MZ405"] == jres.stats["MZ405"] == 1
    # the next wave equals the same requests served fault-free
    fresh = ContinuousBatcher(tcfg, model, batch=2, max_len=MAX_LEN, driver=driver,
                              device="cpu")
    ref = [fresh.make_request(p, 4) for p in prompts[2:]]
    fresh.run(ref)
    assert [r.out for r in ref] == [r.out for r in tw2]


def test_serve_step_fault_fails_wave_and_driver_survives_like_jax():
    _serve_step_fault_like_jax("jit")


def test_serve_step_fault_on_the_mozart_driver_like_jax():
    """The same wave with the port's default driver, serving over
    ``mozart.pipeline``: the fault fires at the step boundary, before the
    pipeline, and the pipelines stay usable."""
    _serve_step_fault_like_jax("mozart")


def test_async_server_survives_an_injected_step_fault():
    """The request in flight when the fault fires fails with it; a later
    ``generate`` on the same server completes."""
    _async_server_survives("jit")


def test_async_server_survives_an_injected_step_fault_on_the_mozart_driver():
    _async_server_survives("mozart")


def _async_server_survives(driver):
    jcfg = jsmoke("internlm2-20b").with_runtime(dtype=jnp.float32)
    _params, tcfg, model = _carry(jcfg)
    b = ContinuousBatcher(tcfg, model, batch=2, max_len=MAX_LEN, driver=driver, device="cpu")
    prompt = np.arange(5, dtype=np.int32)
    req = b.submit(b.make_request(prompt, 3))
    server = AsyncServer(b, idle_poll_s=1e-4)
    try:
        with tmozart.inject_faults("serve_step:fail:1"):
            server.start()
            assert req.done.wait(60)
            out = asyncio.run(server.generate(prompt, 3))
    finally:
        server.close()
    assert isinstance(req.error, InjectedFault) and req.out == []
    assert len(out) == 3 and b.stats["step_failures"] == 1
    assert resilience.stats["MZ405"] == 1


# ---------------------------------------------------------------------------
# Step-level helpers (runtime/fault.py re-exports them)
# ---------------------------------------------------------------------------


def test_fault_shim_reexports_same_objects():
    from repro_torch.runtime import fault
    assert fault.with_retries is resilience.with_retries
    assert fault.StepTimer is resilience.StepTimer
    assert fault.FaultConfig is resilience.FaultConfig
    assert fault.run_with_restarts is resilience.run_with_restarts
    assert fault.TRANSIENT_ERRORS is resilience.TRANSIENT_ERRORS
    assert fault.StepFailure is resilience.StepFailure
    assert resilience.TRANSIENT_ERRORS == jres.TRANSIENT_ERRORS
    assert resilience.PROBE_ERRORS == jres.PROBE_ERRORS


class TestWithRetries:
    def test_transient_retried_then_succeeds(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("transient")
            return 42

        assert with_retries(flaky, retries=4) == 42
        assert len(calls) == 3
        assert resilience.stats["step_retries"] == 2

    def test_non_transient_and_kernel_faults_propagate_immediately(self):
        for exc in (KeyError("programming error"), KernelError("launch failed")):
            calls = []

            def buggy(exc=exc):
                calls.append(1)
                raise exc

            with pytest.raises(type(exc)):
                with_retries(buggy, retries=5)
            assert len(calls) == 1

    def test_exhaustion_raises_step_failure_with_cause(self):
        boom = RuntimeError("always")

        def always():
            raise boom

        with pytest.raises(StepFailure) as ei:
            with_retries(always, retries=2)
        assert ei.value.__cause__ is boom

    def test_backoff_sleeps_exponentially(self, monkeypatch):
        slept = []
        monkeypatch.setattr(time, "sleep", slept.append)

        def always():
            raise RuntimeError("x")

        with pytest.raises(StepFailure):
            with_retries(always, retries=3, backoff_s=0.1)
        assert slept == [0.1, 0.2, 0.4]


class TestStepTimer:
    def test_straggler_flagged_and_hook_called(self):
        hits = []
        cfg = FaultConfig(min_steps_for_baseline=3, straggler_factor=2.0)
        t = StepTimer(cfg, on_straggler=lambda s, sec, med: hits.append((s, sec, med)))
        for i in range(3):
            assert not t.record(i, 0.01)
        assert t.record(3, 0.05)
        assert t.stragglers == [3]
        assert hits and hits[0][0] == 3 and hits[0][1] == 0.05
        assert resilience.stats["stragglers"] == 1

    def test_no_flag_before_baseline(self):
        t = StepTimer(FaultConfig(min_steps_for_baseline=5))
        assert not t.record(0, 100.0)


def test_run_with_restarts_restarts_from_checkpoint():
    calls = {"n": 0}
    ckpts = [None, 3, 7]

    def run_from(state, start):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError(f"crash {calls['n']}")
        return ("done", start)

    result = run_with_restarts(
        lambda step: ({"from": step}, step or 0), run_from,
        fault_cfg=FaultConfig(max_restarts=3, backoff_s=0.0),
        latest_step=lambda: ckpts[min(calls["n"], 2)])
    assert result == ("done", 7)
    assert resilience.stats["restarts"] == 2


def test_run_with_restarts_gives_up_after_max():
    def run_from(state, start):
        raise RuntimeError("always down")

    with pytest.raises(RuntimeError, match="always down"):
        run_with_restarts(
            lambda step: (None, 0), run_from,
            fault_cfg=FaultConfig(max_restarts=1, backoff_s=0.0),
            latest_step=lambda: None)


def test_mz4xx_codes_registered():
    """The resilience layer's MZ4xx codes stand in the verifier's table,
    with the reference's meanings."""
    from repro.core.analysis import CODES as JCODES
    from repro_torch.core.analysis import CODES
    for code in ("MZ401", "MZ402", "MZ403", "MZ404", "MZ405", "MZ406"):
        assert CODES[code] == JCODES[code]
    resilience.record_event("MZ402", "unit test")
    assert resilience.events()[-1].message == CODES["MZ402"]


# -- C15: a retried step starts with the failed attempt's tensors released ------


@pytest.mark.parametrize("agree", [False, True])
def test_retry_starts_with_the_failed_attempts_tensors_released(agree):
    """C15: the first attempt allocates a tensor, keeps it in a local of a
    nested frame and raises a transient error; when the second attempt
    starts, nothing holds that tensor any more (a weak reference to it is
    dead), with and without ``agree``, and the ``StepFailure`` of an
    exhausted retry still names the first error."""
    import gc
    import weakref
    refs, alive_at_retry = [], []

    def inner():
        held = torch.ones(1 << 16)
        refs.append(weakref.ref(held))
        raise RuntimeError("injected transient fault")

    def step():
        if refs:
            gc.disable()               # the release is by reference count alone
            try:
                alive_at_retry.append(refs[0]() is not None)
            finally:
                gc.enable()
            return "done"
        partial = torch.zeros(1 << 16)          # a local of the failed frame too
        refs_partial.append(weakref.ref(partial))
        inner()

    refs_partial = []
    kw = {"agree": (lambda outcome: [outcome])} if agree else {}
    assert with_retries(step, retries=1, **kw) == "done"
    assert alive_at_retry == [False]
    assert refs_partial[0]() is None

    def always():
        inner()
    with pytest.raises(StepFailure) as info:
        with_retries(always, retries=1, **kw)
    assert "injected transient fault" in str(info.value.__cause__)
