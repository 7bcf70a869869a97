"""The port's boundary sanitizer (``MOZART_SANITIZE=1``, codes MZ301-303) and
the resilience layer's handling of it, held against the JAX package.

The counterparts of ``tests/test_analysis.py``'s sanitizer section: a read
of a released stream, or of its graph-node alias, raises MZ301 naming the
donor; with the sanitizer off the stream is released as before and the
backstop still raises; MZ302 on a hole and on an extent mismatch; MZ303 on
a corrupted scope, with an exception inside the scope left untouched; and
a sanitized handoff chain on every executor of the port (``cuda`` on the
CPU through its plain path, against JAX's ``pallas``) equal to the
reference and to its own unsanitized run, counters included.  Then
``tests/test_resilience.py``'s ``test_sanitizer_errors_are_never_demoted_around``
(on every executor name) and its MZ406 event test (``events()`` gives
``analysis.Diagnostic``s), and one test per ``ChunkStream`` read path: the
chunk list, one chunk, the merge, the raw storage, in the list, stacked,
stacked-with-tail and zero-chunk forms.

Where the port is stricter than the reference it says so: the reference's
tuner and ``auto`` scoring count a ``SanitizerError`` as one more swallowed
``RuntimeError``; the port's ``note_swallowed`` re-raises it, so no site
carries on past a sanitizer trip.  No Pallas kernel is reached but through
the reference's ``pallas`` executor, which runs in interpret mode on the
CPU.  Tolerances: float32 rtol 2e-5, atol 1e-6.
"""

import collections
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analysis as janalysis
from repro.core import resilience as jres
from repro.core import split_types as jst
from repro.core import stage_exec as jse
from repro.core.graph import NodeRef as JNodeRef
from repro_torch.core import analysis
from repro_torch.core import mozart as tmozart
from repro_torch.core import plan_cache as tpc
from repro_torch.core import resilience
from repro_torch.core import split_types as st
from repro_torch.core import stage_exec as tse
from repro_torch.core.graph import NodeRef
from repro_torch.core.stage_exec import ChunkStream, SanitizerError

from sharded_scenarios import port_mesh
from test_torch_handoff import JAXNS, PORTNS

JAX_OF = {"cuda": "pallas"}
EXECUTORS = ("eager", "pipelined", "fused", "scan", "cuda", "sharded", "auto")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("MOZART_SANITIZE", raising=False)
    for r in (resilience, jres):
        r.clear_faults()
        r.clear_events()
    tpc.clear()
    yield
    for r in (resilience, jres):
        r.clear_faults()
        r.clear_events()
    tpc.clear()


# ---------------------------------------------------------------------------
# MZ301: use after release
# ---------------------------------------------------------------------------


def _jstream(n=6):
    t = jst.ArraySplit((n, 2), 0)
    x = jnp.arange(n * 2, dtype=jnp.float32).reshape(n, 2)
    h = n // 2
    chunks = [t.split(x, 0, h), t.split(x, h, n)]
    return jse.ChunkStream(chunks, [(0, h), (h, n)], t, jst.aval_of(x))


def _tstream(n=6):
    t = st.ArraySplit((n, 2), 0)
    x = torch.arange(n * 2, dtype=torch.float32).reshape(n, 2)
    h = n // 2
    chunks = [t.split(x, 0, h), t.split(x, h, n)]
    return ChunkStream(chunks, [(0, h), (h, n)], t, st.aval_of(x))


def _release(se, ref_cls, stream, orig):
    """The surface ``mark_stream_consumed`` uses: a stage whose input 0 is
    ``stream``, whose graph node holds ``orig``."""
    ctx = SimpleNamespace(graph=SimpleNamespace(nodes={11: SimpleNamespace(result=orig)}),
                          stats=collections.Counter())
    si = SimpleNamespace(value=ref_cls(11), split_type=stream.split_type)
    stage = SimpleNamespace(id=7, inputs={("x", 0): si}, ckey=lambda k: k)
    se.mark_stream_consumed(stage, {("x", 0): stream}, ctx, {("x", 0)})
    return ctx


DONOR = "stage 7 input ('x', 0)"


def test_use_after_release_raises_mz301_like_jax(monkeypatch):
    monkeypatch.setenv("MOZART_SANITIZE", "1")
    for se, ref_cls, make in ((jse, JNodeRef, _jstream), (tse, NodeRef, _tstream)):
        s, orig = make(), make()
        _release(se, ref_cls, s, orig)
        assert s.consumed and s.donor == DONOR
        with pytest.raises(se.SanitizerError, match=r"MZ301") as ei:
            list(s._chunks)
        assert DONOR in str(ei.value)
        with pytest.raises(se.SanitizerError, match=r"MZ301"):
            orig._chunks[0]                    # the graph-node alias is poisoned too
        with pytest.raises(RuntimeError, match=r"MZ301") as ei:
            s.materialize()
        assert DONOR in str(ei.value)
    # the port's every read path raises the sanitizer's error itself
    with pytest.raises(SanitizerError, match=r"MZ301"):
        s.materialize()
    assert s.stacked is None and s.tail is None and len(s._chunks) == 0
    assert repr(s) == f"ChunkStream(released, n=6, {s.split_type})"


def test_release_breadcrumb_only_under_the_sanitizer(monkeypatch):
    """A zero-byte ``donate`` event per released input, as the reference's
    ``note_materialized(0, kind="donate", where=donor)``; none without."""
    counters = tse.BoundaryCounters()
    for flag, want in (("0", []), ("1", [("interior:donate", DONOR, 0)])):
        monkeypatch.setenv("MOZART_SANITIZE", flag)
        counters.reset()
        with tse.counter_scope(counters):
            ctx = _release(tse, NodeRef, _tstream(), _tstream())
        assert counters.materialize_events() == want
        assert counters.bytes_materialized() == 0
        assert ctx.stats["streams_released"] == 1


def test_release_not_poisoned_when_sanitize_off(monkeypatch):
    """Sanitizer off: the reference keeps the donated chunks readable; the
    port releases them (``_chunks`` None, its behaviour before the
    sanitizer) and both backstops raise MZ301 on a merge."""
    monkeypatch.setenv("MOZART_SANITIZE", "0")
    js, jorig = _jstream(), _jstream()
    _release(jse, JNodeRef, js, jorig)
    assert js.consumed and len(js._chunks) == 2
    s, orig = _tstream(), _tstream()
    _release(tse, NodeRef, s, orig)
    assert s.consumed and orig.consumed
    assert s._chunks is None and orig._chunks is None
    for stream in (js, s, orig):
        with pytest.raises(RuntimeError, match=r"MZ301") as ei:
            stream.materialize()
        assert DONOR in str(ei.value)
        assert not isinstance(ei.value, (SanitizerError, jse.SanitizerError))
    assert repr(s) == f"ChunkStream(released, n=6, {s.split_type})"


# ---------------------------------------------------------------------------
# ChunkStream read paths on a released stream
# ---------------------------------------------------------------------------


def _form(form):
    """A live stream of each storage form (n = 6 rows of 2 unless empty)."""
    t = st.ArraySplit((6, 2), 0)
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    aval = st.aval_of(x)
    if form == "list":
        return ChunkStream([x[:3], x[3:]], [(0, 3), (3, 6)], t, aval)
    if form == "stacked":
        return ChunkStream.from_stacked(x.reshape(2, 3, 2), None, [(0, 3), (3, 6)], t, aval)
    if form == "stacked_tail":
        return ChunkStream.from_stacked(x[:4].reshape(2, 2, 2), x[4:],
                                        [(0, 2), (2, 4), (4, 6)], t, aval)
    if form == "sharded":                    # a one-rank mesh's DTensor
        from torch.distributed.tensor import DTensor
        from repro_torch.core.sharded import placements_for
        mesh = port_mesh()
        pl = placements_for(mesh, ("data",), 0)
        return ChunkStream.from_sharded(DTensor.from_local(x, mesh, pl, run_check=False),
                                        [(0, 6)], t, aval, (mesh, pl))
    e = torch.zeros((0, 2))
    return ChunkStream([], [(0, 0)], st.ArraySplit((0, 2), 0), st.aval_of(e))


READS = {
    "chunks": lambda s: s.chunks,
    "chunk": lambda s: s.chunk(0),
    "materialize": lambda s: s.materialize(),
    "terminal": lambda s: s.materialize(terminal=True),
    "raw_iter": lambda s: list(s._chunks),
    "raw_index": lambda s: s._chunks[0],
}
FORMS = ("list", "stacked", "stacked_tail", "sharded", "empty")


@pytest.mark.parametrize("read", sorted(READS))
@pytest.mark.parametrize("form", FORMS)
def test_released_stream_read_raises_mz301_in_every_branch(monkeypatch, form, read):
    """``chunks`` (list form and the stacked derivation), ``chunk`` (the
    stacked row, the tail, the zero-chunk empty value), ``materialize``
    (stacked merge, zero-chunk empty value, list merge) and the raw storage:
    each raises MZ301 naming the donor, never an empty or derived value."""
    monkeypatch.setenv("MOZART_SANITIZE", "1")
    s = _form(form)
    READS["chunk"](s)                            # a live read works
    s.release("stage 3 input ('in', 0)")
    with pytest.raises(SanitizerError, match=r"MZ301.*stage 3 input \('in', 0\)"):
        READS[read](s)
    assert not s.compatible(s.split_type)
    assert repr(s).startswith("ChunkStream(released")


@pytest.mark.parametrize("form", FORMS)
def test_released_stream_without_sanitizer_keeps_the_backstop(form):
    s = _form(form)
    s.release("stage 3 input ('in', 0)")
    assert s._chunks is None and s.stacked is None and s.tail is None and s.sharded is None
    for read in ("chunks", "chunk", "materialize"):
        with pytest.raises(RuntimeError, match=r"MZ301") as ei:
            READS[read](s)
        assert not isinstance(ei.value, SanitizerError)
    assert repr(s).startswith("ChunkStream(released")


def test_block_stage_outputs_skips_poisoned_storage(monkeypatch):
    """The tuner's wait reads raw storage: a poisoned list is no tensor."""
    monkeypatch.setenv("MOZART_SANITIZE", "1")
    s = _form("list")
    s.release("stage 0 input ('in', 0)")
    node = SimpleNamespace(id=1, result=s)
    tse._block_stage_outputs(SimpleNamespace(nodes=[node], escaping={1}))


def test_adapt_stream_of_a_poisoned_concat_stream_raises(monkeypatch):
    """``adapt_stream`` reads the raw chunk list."""
    monkeypatch.setenv("MOZART_SANITIZE", "1")
    x = torch.arange(6, dtype=torch.float32)
    s = ChunkStream([x[:3], x[3:]], [(0, 3), (3, 6)], st.ConcatSplit(), st.aval_of(x))
    s.release("stage 1 input ('x', 0)")
    with pytest.raises(SanitizerError, match="MZ301"):
        tse.adapt_stream(s, st.ArraySplit((6,), 0))


# ---------------------------------------------------------------------------
# MZ302: a stream that does not tile its consumer
# ---------------------------------------------------------------------------


def test_stream_tiling_violations_raise_mz302_like_jax():
    for se, stmod, make, ctor in (
            (jse, jst, _jstream, lambda s: jse.ChunkStream(
                list(s._chunks), [(0, 2), (3, 6)], s.split_type, s.aval)),
            (tse, st, _tstream, lambda s: ChunkStream(
                list(s._chunks), [(0, 2), (3, 6)], s.split_type, s.aval))):
        s = make(6)
        t = stmod.ArraySplit((6, 2), 0)
        se._check_stream_tiles(s, t, "edge")       # clean: no raise
        with pytest.raises(se.SanitizerError, match=r"MZ302") as ei:
            se._check_stream_tiles(ctor(s), t, "stage 1 input ('x', 0)")
        assert "do not tile" in str(ei.value)
        assert "stage 1 input ('x', 0)" in str(ei.value)
        with pytest.raises(se.SanitizerError, match=r"MZ302") as ei:
            se._check_stream_tiles(s, stmod.ArraySplit((8, 2), 0), "edge")
        assert "stream extent" in str(ei.value)
        # overlapping ranges are a hole too
        with pytest.raises(se.SanitizerError, match=r"MZ302"):
            se._check_stream_tiles(
                type(s)(list(s._chunks), [(0, 4), (3, 6)], s.split_type, s.aval), t, "e")


# ---------------------------------------------------------------------------
# MZ303: a scope that counts more than the global aggregate
# ---------------------------------------------------------------------------


def test_corrupt_scoped_counters_raise_mz303_like_jax(monkeypatch):
    monkeypatch.setenv("MOZART_SANITIZE", "1")
    for se in (jse, tse):
        c = se.BoundaryCounters()
        with pytest.raises(se.SanitizerError, match=r"MZ303") as ei:
            with se.counter_scope(c):
                c.interior += 4096             # scoped bump with no global event
        assert "interior" in str(ei.value)
        c = se.BoundaryCounters()
        with pytest.raises(se.SanitizerError, match=r"MZ303.*traces"):
            with se.counter_scope(c):
                c.traces += 1
        # honest attribution passes the cross-check
        c2 = se.BoundaryCounters()
        with se.counter_scope(c2):
            se.note_materialized(128)
            se.note_materialized(64, terminal=True)
            se.note_trace()
        assert (c2.interior, c2.terminal, c2.traces) == (128, 64, 1)
        # an exception inside the scope propagates untouched
        c3 = se.BoundaryCounters()
        with pytest.raises(ValueError, match="boom"):
            with se.counter_scope(c3):
                c3.interior += 1
                raise ValueError("boom")
    # sanitizer off: no cross-check
    monkeypatch.setenv("MOZART_SANITIZE", "0")
    c4 = tse.BoundaryCounters()
    with tse.counter_scope(c4):
        c4.interior += 4096
    assert c4.interior == 4096


# ---------------------------------------------------------------------------
# A sanitized handoff chain on every executor
# ---------------------------------------------------------------------------


def _chain(ns, executor):
    """The smoke/handoff chain at 4096 elements in chunks of 512: three
    evaluations, each stage the last user of the previous stream.  A
    ``cuda``/``pallas`` row's first evaluation runs on ``fused`` (a kernel
    stage merges its own outputs), as the reference's ``smoke/handoff``."""
    first = "fused" if executor in ("cuda", "pallas") else executor
    x = ns.arr(np.linspace(0.1, 2.0, 4096, dtype=np.float32))
    mesh = {"mesh": ns.mesh()} if executor == "sharded" else {}
    with ns.session(executor=first, handoff=True, batch_elements=512, **mesh) as ctx:
        cur = x
        for i in range(3):
            cur = ns.anp.multiply(ns.anp.add(cur, 1.0), 0.5)
            ns.mozart.evaluate()
            if i == 0 and first != executor:
                ns.mozart.configure(executor=executor)
        out = ns.np(cur)
    return out, ctx


@pytest.mark.parametrize("executor", EXECUTORS)
def test_sanitized_handoff_chain_equals_jax_and_unsanitized(monkeypatch, executor):
    monkeypatch.setenv("MOZART_SANITIZE", "0")
    plain, plain_ctx = _chain(PORTNS, executor)
    monkeypatch.setenv("MOZART_SANITIZE", "1")
    got, ctx = _chain(PORTNS, executor)
    jgot, jctx = _chain(JAXNS, JAX_OF.get(executor, executor))
    np.testing.assert_allclose(got, jgot, rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(got, plain)
    assert dict(ctx.stats) == dict(plain_ctx.stats)
    assert ctx.counters.bytes_materialized() == plain_ctx.counters.bytes_materialized()
    for k in ("streamed_outputs", "stream_ingests", "donated_chunks"):
        assert ctx.stats.get(k, 0) == jctx.stats.get(k, 0), k
    donates = [e for e in ctx.counters.materialize_events() if e[0] == "interior:donate"]
    assert len(donates) == ctx.stats.get("streams_released", 0)
    if executor in ("fused", "scan"):
        assert ctx.stats["streams_released"] > 0 and ctx.stats["stream_ingests"] > 0
    if executor == "cuda":
        assert ctx.stats["cuda_stages"] == 2 and ctx.stats.get("cuda_fallback_stages", 0) == 0
    assert resilience.stats["MZ402"] == 0 and resilience.stats["swallowed_errors"] == 0


def test_holed_stream_trips_mz302_inside_a_session(monkeypatch):
    """A stream whose ranges lose a chunk is refused at ingest, in a real
    session, and the trip is never demoted around."""
    monkeypatch.setenv("MOZART_SANITIZE", "1")
    real = tse.finish_stage

    def holed(stage, partials, ranges=None, ctx=None):
        real(stage, partials, ranges, ctx)
        for node in stage.nodes:
            if isinstance(node.result, ChunkStream):
                node.result.ranges[1] = (node.result.ranges[1][0] + 1, node.result.ranges[1][1])
    monkeypatch.setattr(tse, "finish_stage", holed)
    import repro_torch.core.executor as texec
    monkeypatch.setattr(texec, "finish_stage", holed)
    with pytest.raises(SanitizerError, match=r"MZ302.*do not tile"):
        _chain(PORTNS, "fused")
    assert resilience.stats["MZ402"] == 0


@pytest.mark.parametrize("producer,consumer", (("fused", "fused"), ("scan", "scan"),
                                               ("scan", "cuda")))
def test_read_after_release_inside_a_session_raises_mz301(monkeypatch, producer, consumer):
    """A stream released by a real stage (on ``cuda``: the scan carry the
    launch took as it is), then read again: the trip names the releasing
    stage."""
    monkeypatch.setenv("MOZART_SANITIZE", "1")
    x = PORTNS.arr(np.linspace(0.1, 2.0, 4096, dtype=np.float32))
    with PORTNS.session(executor=producer, handoff=True, batch_elements=512) as ctx:
        a = PORTNS.anp.multiply(PORTNS.anp.add(x, 1.0), 0.5)
        PORTNS.mozart.evaluate()
        stream = a._node.result
        assert isinstance(stream, ChunkStream)
        PORTNS.mozart.configure(executor=consumer)
        b = PORTNS.anp.add(a, 1.0)
        del a
        PORTNS.mozart.evaluate()
        assert stream.consumed and ctx.stats["streams_released"] == 1
        if consumer == "cuda":
            assert ctx.stats["cuda_ingest_carry"] == 1 and ctx.stats["cuda_stages"] == 1
        for read in READS.values():
            with pytest.raises(SanitizerError, match=r"MZ301.*stage \d+ input"):
                read(stream)
        np.testing.assert_allclose(PORTNS.np(b), np.linspace(0.1, 2.0, 4096) * 0.5 + 1.5,
                                   rtol=2e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The resilience layer: sanitizer trips are never demoted, swallowed or retried
# ---------------------------------------------------------------------------


class _Ctx:
    def __init__(self, **stats):
        self.stats = dict(stats)


@pytest.mark.parametrize("executor", (None,) + EXECUTORS)
def test_sanitizer_errors_are_never_demoted_around(executor):
    assert not jres._recoverable(jse.SanitizerError("bad merge"), _Ctx(), 0)
    assert not resilience._recoverable(SanitizerError("bad merge"), _Ctx(), 0, executor)
    # the same attempt with a plain RuntimeError is re-driven off cuda
    assert resilience._recoverable(RuntimeError("x"), _Ctx(), 0, executor) == (executor != "cuda")


@pytest.mark.parametrize("executor", EXECUTORS)
def test_sanitizer_trip_inside_a_stage_propagates_on_every_executor(monkeypatch, executor):
    """Raised inside every executor's stage body (``auto``: inside its
    candidates' sampled runs and its delegate), the trip leaves the session
    with no demotion, quarantine, MZ402 or swallow."""
    def trips(self, stage, concrete, ctx):
        raise SanitizerError("[MZ302] stage 0 input ('in', 0): planted")
    for name in ("eager", "pipelined", "fused", "scan", "cuda", "sharded"):
        monkeypatch.setattr(type(tse.get_executor(name)), "execute", trips)
    x = PORTNS.arr(np.linspace(0.1, 2.0, 4096, dtype=np.float32))
    mesh = {"mesh": port_mesh()} if executor == "sharded" else {}
    for _ in range(2):                        # auto measures on the first hit
        with pytest.raises(SanitizerError, match="planted"):
            with tmozart.session(executor=executor, device="cpu", **mesh) as ctx:
                float(PORTNS.anp.sum(PORTNS.anp.exp(x)).value)
        assert ctx.stats.get("exec_demotions", 0) == 0
        assert ctx.stats.get("swallowed_errors", 0) == 0
    assert resilience.stats["MZ402"] == 0 and resilience.stats["MZ404"] == 0
    assert resilience.stats["swallowed_errors"] == 0
    assert all(not e.quarantined for e in tpc.entries())


def test_tuner_and_auto_do_not_swallow_a_sanitizer_trip(monkeypatch):
    """The reference's tuner counts a failing sample's ``SanitizerError`` as
    one more swallowed ``RuntimeError``; the port's re-raises it, as a
    kernel fault, through ``note_swallowed``, in the tuner and in ``auto``'s
    candidate scoring."""
    jres.note_swallowed("tune_sample", jse.SanitizerError("[MZ303] x"))
    assert jres.stats["swallowed:tune_sample"] == 1
    with pytest.raises(SanitizerError):
        resilience.note_swallowed("tune_sample", SanitizerError("[MZ303] x"))
    assert resilience.stats["swallowed_errors"] == 0

    from repro_torch.core import cost_model
    from test_torch_plan_cache import TTINY
    x = PORTNS.arr(np.linspace(0.1, 2.0, 1 << 15, dtype=np.float32))
    real = tse.StageExecutor.sampled_time

    def trips(self, *a, **kw):
        raise SanitizerError("[MZ301] planted in a sample")
    for executor, kw in (("fused", dict(chip=TTINY)), ("auto", dict(batch_elements=512))):
        if executor == "auto":
            monkeypatch.setattr(cost_model, "analytic_seconds", lambda *a, **k: 1.0)
        monkeypatch.setattr(tse.StageExecutor, "sampled_time", real)
        with tmozart.session(executor=executor, device="cpu", **kw):
            float(PORTNS.anp.sum(PORTNS.anp.exp(x)).value)          # the miss
        monkeypatch.setattr(tse.StageExecutor, "sampled_time", trips)
        with pytest.raises(SanitizerError, match="planted"):
            with tmozart.session(executor=executor, device="cpu", **kw) as ctx:
                float(PORTNS.anp.sum(PORTNS.anp.exp(x)).value)      # the first hit samples
        assert ctx.stats.get("swallowed_errors", 0) == 0
        assert ctx.stats.get("exec_demotions", 0) == 0
        tpc.clear()
    assert resilience.stats["swallowed_errors"] == 0 and resilience.stats["MZ402"] == 0


def test_retry_helpers_do_not_retry_a_sanitizer_trip():
    calls = []

    def fn():
        calls.append(1)
        raise SanitizerError("[MZ303] x")
    with pytest.raises(SanitizerError):
        resilience.with_retries(fn, retries=3)
    assert len(calls) == 1
    restarts = []
    with pytest.raises(SanitizerError):
        resilience.run_with_restarts(
            lambda step: (restarts.append(step), 0), lambda state, start: fn(),
            fault_cfg=resilience.FaultConfig(max_restarts=3), latest_step=lambda: None)
    assert len(restarts) == 1 and resilience.stats["restarts"] == 0


# ---------------------------------------------------------------------------
# MZ4xx events as Diagnostics
# ---------------------------------------------------------------------------


def test_events_are_diagnostics_like_jax():
    for r in (jres, resilience):
        r.note_swallowed("unit_test", ValueError("nope"))
        r.record_event("MZ402", "stage 0: fused -> pipelined (InjectedFault)")
    jev, ev = jres.events(), resilience.events()
    assert all(isinstance(d, analysis.Diagnostic) for d in ev)
    assert all(isinstance(d, janalysis.Diagnostic) for d in jev)
    assert any(d.code == "MZ406" and "unit_test" in d.subject for d in ev)
    assert ([(d.code, d.severity, d.subject, d.message, d.where) for d in ev]
            == [(d.code, d.severity, d.subject, d.message, d.where) for d in jev])
    assert str(ev[-1]) == str(jev[-1])
    assert not hasattr(resilience, "Event")
