"""The port's ``scan`` executor and the stream-ingest paths of ``scan`` and
``cuda``, held against the JAX package on the CPU (``cuda`` runs the
kernel's plain version there, in the reference's ``pallas``'s place).

The JAX side runs with ``plan_cache=False, autotune=False``, the rewrite
pass on as the port's, and the port's ``handoff`` and ``batch_elements``.  Chunk, call and stage
counts and boundary bytes are held equal to JAX's ``scan`` (on the paper's
workloads in ``tests/test_torch_executors.py``; here on the handoff chain
and the delegation cases).  Tolerances: float32 rtol 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Along as JAlong, Unknown as JUnknown, splittable as jsplittable
from repro.core import annotated_numpy as janp
from repro.core import mozart as jmozart
from repro_torch.core import Along, Unknown, splittable
from repro_torch.core import annotated_numpy as tanp
from repro_torch.core import mozart as tmozart
from repro_torch.core.stage_exec import ChunkStream, available_executors
from repro_torch.optim import adamw
from repro_torch.optim import mozart_adamw as tmozart_adamw

from test_torch_kernels_card import STREAM_FORMS, stream_ingest_case

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
KEYS = ("chunks", "calls", "stages", "streamed_outputs", "stream_ingests",
        "stream_materialized", "handoff_rechunks", "donated_chunks")


def _eval_chain(anp, mozart, x, evals=3):
    cur = x
    for _ in range(evals):
        cur = anp.multiply(anp.add(cur, 1.0), 0.5)
        mozart.evaluate()
    return cur


def _stats(ctx):
    return {k: ctx.stats.get(k, 0) for k in KEYS}


def test_scan_is_registered_and_the_adamw_default():
    assert "scan" in available_executors()
    import inspect
    from repro.optim import mozart_adamw as jmozart_adamw
    for fn in (tmozart_adamw.mozart_adamw_update, jmozart_adamw.mozart_adamw_update):
        assert inspect.signature(fn).parameters["executor"].default == "scan"


def test_mozart_adamw_on_scan_matches_the_jnp_path():
    r = np.random.RandomState(0)
    params = {"b": torch.from_numpy(r.randn(16, 8).astype(np.float32)),
              "w": torch.from_numpy(r.randn(3000).astype(np.float32))}
    grads = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32))
             for k, v in params.items()}
    cfg = adamw.AdamWConfig()
    got_p, got_s, metrics = tmozart_adamw.mozart_adamw_update(
        params, grads, adamw.init(params), cfg, batch_elements=700)
    want_p, want_s, _ = adamw.update(params, grads, adamw.init(params), cfg, path="jnp")
    for k in params:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k].numpy(), rtol=3e-5, atol=3e-6)
        np.testing.assert_allclose(got_s.v[k].numpy(), want_s.v[k].numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert metrics["stats"]["stages"] == 2 and metrics["stats"]["calls"] == 2


class TestScanPallasIngest:
    """Interior boundaries hit zero on ``scan`` and ``cuda`` as on the chunk
    loops: ``scan`` reads incoming streams as rows of its carry, ``cuda``
    builds its launch buffer from them."""

    N, BATCH = 50_000, 8192

    def _chain(self, executor, handoff=True, port=True):
        x = np.linspace(0., 1., self.N, dtype=np.float32)
        if port:
            with tmozart.session(executor=executor, device="cpu", **PORT_CFG,
                                 batch_elements=self.BATCH, handoff=handoff) as ctx:
                out = _eval_chain(tanp, tmozart, torch.from_numpy(x)).value.numpy()
        else:
            with jmozart.session(executor=executor, batch_elements=self.BATCH,
                                 handoff=handoff, **JAX_CFG) as ctx:
                out = np.asarray(_eval_chain(janp, jmozart, jnp.asarray(x)))
        return out, ctx

    @pytest.mark.parametrize("executor", ["scan", "cuda"])
    def test_interior_zero(self, executor):
        out, ctx = self._chain(executor)
        jout, jctx = self._chain("pallas" if executor == "cuda" else executor, port=False)
        assert ctx.counters.bytes_interior() == jctx.counters.bytes_interior() == 0
        assert _stats(ctx) == _stats(jctx)
        off, _c = self._chain(executor, handoff=False)
        np.testing.assert_allclose(out, off, rtol=2e-5)
        np.testing.assert_allclose(out, jout, rtol=2e-5)

    def test_scan_streams_and_donates_carry(self):
        _o, ctx = self._chain("scan")
        _j, jctx = self._chain("scan", port=False)
        assert ctx.stats["streamed_outputs"] == 3
        assert ctx.stats["stream_ingests"] == 2
        assert ctx.stats["donated_chunks"] == jctx.stats["donated_chunks"] > 0
        # torch donates no buffer, so nothing is ever copied before one
        assert ctx.stats.get("donation_copies", 0) == 0
        # observation of the final output is TERMINAL, never interior
        assert ctx.counters.bytes_terminal() == jctx.counters.bytes_terminal() == self.N * 4
        # 50 000 = 6 x 8192 + a tail of 848: 7 chunks, one driver call
        assert ctx.stats["chunks"] == 3 * 7 and ctx.stats["calls"] == 3

    def test_scan_carry_passthrough_is_stacked(self):
        """A scan stage's streamed output keeps the carry layout; a scan
        consumer reads its rows without deriving the chunk list (no unstack
        event) and gives up the carry after its last use."""
        x = torch.linspace(0., 1., self.N)
        with tmozart.session(executor="scan", device="cpu", **PORT_CFG, batch_elements=self.BATCH) as ctx:
            a = tanp.multiply(tanp.add(x, 1.0), 0.5)
            tmozart.evaluate()
            res = ctx.graph.nodes[a._node.id].result
            assert isinstance(res, ChunkStream)
            assert res.stacked is not None and res._chunks is None
            assert tuple(res.stacked.shape) == (6, self.BATCH)
            assert tuple(res.tail.shape) == (self.N - 6 * self.BATCH,)
            e = tanp.exp(a)
            del a
            out = e.value
        assert not any("unstack" in k for k, _w, _n in ctx.counters.materialize_events())
        assert res.consumed and res.stacked is None
        torch.testing.assert_close(out, torch.exp((x + 1) * 0.5))

    def test_cuda_ingests_fused_stream(self):
        x = np.linspace(0., 1., self.N, dtype=np.float32)

        def once(port):
            if port:
                with tmozart.session(executor="fused", device="cpu", **PORT_CFG,
                                     batch_elements=self.BATCH) as ctx:
                    a = tanp.multiply(tanp.add(torch.from_numpy(x), 1.0), 0.5)
                    tmozart.evaluate()
                    tmozart.configure(executor="cuda")
                    return tanp.exp(a).value.numpy(), ctx
            with jmozart.session(executor="fused", batch_elements=self.BATCH,
                                 **JAX_CFG) as ctx:
                a = janp.multiply(janp.add(jnp.asarray(x), 1.0), 0.5)
                jmozart.evaluate()
                jmozart.configure(executor="pallas")
                return np.asarray(janp.exp(a)), ctx
        out, ctx = once(True)
        jout, jctx = once(False)
        assert ctx.counters.bytes_interior() == jctx.counters.bytes_interior() == 0
        assert ctx.stats["stream_ingests"] == jctx.stats["stream_ingests"] == 1
        assert ctx.stats.get("stream_materialized", 0) == 0
        assert ctx.stats["cuda_stages"] == jctx.stats["pallas_stages"] == 1
        assert ctx.stats["cuda_ingest_concat"] == 1
        np.testing.assert_allclose(out, jout, rtol=2e-5)

    @pytest.mark.parametrize("consumer", ["fused", "scan"])
    def test_misaligned_grid_rechunks_once(self, consumer):
        """A producer grid beyond the consumer's slack re-grids through
        ``SplitType.rechunk``: at most one copy, counted."""
        x = np.linspace(0., 1., 20_000, dtype=np.float32)

        def once(anp, mozart, arr, session, to_np):
            with session(executor="fused", batch_elements=6000) as ctx:
                a = anp.multiply(anp.add(arr(x), 1.0), 0.5)
                mozart.evaluate()
                mozart.configure(executor=consumer, batch_elements=1024)
                out = to_np(anp.exp(a))
            return out, ctx
        out, ctx = once(tanp, tmozart, lambda v: torch.from_numpy(v.copy()),
                        lambda **kw: tmozart.session(device="cpu", **PORT_CFG, **kw),
                        lambda f: f.value.numpy())
        jout, jctx = once(janp, jmozart, jnp.asarray,
                          lambda **kw: jmozart.session(**JAX_CFG, **kw), np.asarray)
        assert ctx.stats["handoff_rechunks"] == jctx.stats["handoff_rechunks"] == 1
        rechunk = [nb for k, _w, nb in ctx.counters.materialize_events()
                   if k == "interior:rechunk"]
        jrechunk = [nb for k, _w, nb in jctx.counters.materialize_events()
                    if k == "interior:rechunk"]
        assert 0 < sum(rechunk) <= sum(jrechunk) <= x.nbytes
        assert _stats(ctx)["chunks"] == _stats(jctx)["chunks"]
        np.testing.assert_allclose(out, jout, rtol=2e-5)
        np.testing.assert_allclose(out, np.exp((x + 1) * 0.5), rtol=2e-5)


@pytest.mark.parametrize("form", sorted(STREAM_FORMS))
def test_cuda_ingest_paths_on_the_plain_version(form):
    """Each stream form reaches the ``cuda`` stage by its own path (counted
    in ``ctx.stats``), never by a merge; on the CPU the stage runs the
    kernel's plain version (the card test launches the kernel)."""
    got, want, ctx = stream_ingest_case(form, "cpu")
    assert ctx.stats[STREAM_FORMS[form][4]] == 1
    paths = {k: v for k, v in ctx.stats.items() if k.startswith("cuda_ingest_")}
    assert sum(paths.values()) == 1
    assert ctx.stats["stream_ingests"] == 1 and ctx.stats.get("stream_materialized", 0) == 0
    assert ctx.stats["cuda_stages"] == 1 and ctx.stats.get("cuda_fallback_stages", 0) == 0
    assert ctx.stats.get("handoff_rechunks", 0) == (1 if form == "rechunk" else 0)
    assert ctx.counters.bytes_interior() == (0 if form != "rechunk" else sum(
        nb for k, _w, nb in ctx.counters.materialize_events() if k == "interior:rechunk"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=1e-6)


def test_adjacent_views_pass_the_first_chunk_base_pointer():
    from repro_torch.core.cuda_exec import _adjacent_views
    base = torch.arange(20, dtype=torch.float32)
    chunks = list(base[1:].split(4))
    view = _adjacent_views(chunks, 19)
    assert view.data_ptr() == chunks[0].data_ptr() and view.data_ptr() % 16 == 4
    torch.testing.assert_close(view, base[1:])
    assert _adjacent_views([base[:4], base[8:12]], 8) is None     # a gap
    assert _adjacent_views([base[:4], base[:4].clone()], 8) is None


# ---------------------------------------------------------------------------
# Delegation: the reference's own semantics
# ---------------------------------------------------------------------------


def _fresh_fns():
    def fresh(x):
        return x * 2.0
    return (jsplittable(x=JAlong(0), ret=JUnknown())(fresh),
            splittable(x=Along(0), ret=Unknown())(fresh))


_FRESH = _fresh_fns()

DELEGATION = {
    # compress is dynamic: the stage runs on ``pipelined``
    "dynamic": (lambda anp, x: anp.compress(anp.greater(x, 0.5), x), 1000, 256),
    # an empty split: ``fused`` runs one zero-size chunk
    "empty": (lambda anp, x: anp.exp(x), 0, 256),
    # an output split type with no axis (unknown): ``fused``
    "unknown_axis": (lambda anp, x: (_FRESH[0] if anp is janp else _FRESH[1])(x), 1000, 256),
    # a reduction rides the carry as one partial per row
    "reduce": (lambda anp, x: anp.sum(anp.exp(x)), 1000, 256),
}


@pytest.mark.parametrize("case", sorted(DELEGATION))
def test_scan_delegation_counts_equal_jax(case):
    fn, n, batch = DELEGATION[case]
    x = np.linspace(0., 1., n, dtype=np.float32)
    with tmozart.session(executor="scan", device="cpu", **PORT_CFG, batch_elements=batch) as ctx:
        got = fn(tanp, torch.from_numpy(x.copy())).value.numpy()
    with jmozart.session(executor="scan", batch_elements=batch, handoff=True,
                         **JAX_CFG) as jctx:
        want = np.asarray(fn(janp, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert _stats(ctx) == _stats(jctx)
    assert ctx.counters.bytes_interior() == jctx.counters.bytes_interior()
