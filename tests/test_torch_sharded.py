"""The ``sharded`` executor on several ranks, held against the JAX package.

Counterparts of ``tests/test_core_sharded.py`` (``sharded_scenarios.py``
holds the scenarios, written once for both packages).  The reference runs
in ONE subprocess per device count with forced host devices and Auto-axis
meshes (``jax.make_mesh`` gives Explicit axes from jax 0.9, under which two
of the reference's own sharded tests fail); the port runs in a ``gloo``
world of spawned ranks that meet through a ``FileStore`` under the test's
temporary directory, so parallel test workers never share a port.  Every
world has a timeout on joining the group and on its processes: ranks whose
collectives disagree hang rather than fail.

This file: the two-rank scenarios (a sharded stream into every consumer,
chunk-list ingest grids, empty inputs, a reduction per ``ReduceSplit`` op
and dtype, broadcast and ConcatSplit outputs, and the port's own: ranks
that agree on ``auto``'s pick and on the ladder's demotions).  ``test_torch_sharded_mesh.py``: the eight- and four-rank ones.

Compared: values within float32 rtol 2e-5 (bfloat16 2e-2, float16 1e-3,
whose reductions here are exact), and the counters exactly (``sharded_scenarios.STATS``, interior bytes and gather
events).  Every rank must give the same values and counters (SPMD).
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

import sharded_scenarios as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
#: seconds a rank waits on the group (a hung collective fails after it) and
#: a whole world or JAX subprocess may take
GROUP_TIMEOUT_S = 120
WORLD_TIMEOUT_S = 300
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 1e-3}
REDUCE_IDS = [f"{name}-{dtype}" for name, dtype in S.REDUCE_CASES]


def run_jax_side(n_devices: int, tmp) -> dict:
    """The reference's scenarios for ``n_devices`` in one subprocess."""
    out = tmp / f"jax{n_devices}.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run(
        [sys.executable, os.path.join(TESTS, "sharded_scenarios.py"), str(n_devices),
         str(out), str(tmp / f"jax{n_devices}_ckpt")],
        env=env, capture_output=True, text=True, timeout=WORLD_TIMEOUT_S)
    assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr}"
    with open(out, "rb") as f:
        return pickle.load(f)


def run_port_world(world: int, tmp) -> list[dict]:
    """The port's scenarios for ``world`` ranks; one result dict per rank."""
    import torch.multiprocessing as mp
    d = tmp / f"port{world}"
    d.mkdir()
    ctx = mp.start_processes(
        S.torch_rank,
        args=(world, str(d / "store"), str(d), str(d / "ckpt"), GROUP_TIMEOUT_S),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world}-rank world still running after "
                                   f"{WORLD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def assert_same(got, want, what: str, dtype: str = "float32") -> None:
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if g.dtype == bool or w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=1e-6, err_msg=what)


def check_case(ranks: list[dict], want: dict, path: tuple, dtype: str = "float32"):
    """Rank 0's values and counters against the reference's; every other
    rank's equal to rank 0's."""
    def at(d):
        for k in path:
            d = d[k]
        return d
    w = at(want)
    first = at(ranks[0])
    assert first["stats"] == w["stats"], (path, first["stats"], w["stats"])
    for k, v in w["values"].items():
        assert_same(first["values"][k], v, f"{path} {k}", dtype)
    for r, res in enumerate(ranks[1:], 1):
        other = at(res)
        assert other["stats"] == first["stats"], (path, r)
        for k, v in first["values"].items():
            assert_same(other["values"][k], v, f"{path} {k} rank {r}", dtype)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded2")
    return run_jax_side(2, tmp), run_port_world(2, tmp)


STREAM_CASES = [f"{c}/{b}/{h}" for c in ("fused", "scan", "cuda", "sharded")
                for b in (2048, 1000) for h in (True, False)
                if not (c == "sharded" and b != 2048)]


@pytest.mark.parametrize("case", STREAM_CASES)
def test_sharded_stream_to_each_consumer(two, case):
    """A sharded producer's stream into every consumer: the reference's
    values and counters; sharded -> sharded with handoff moves zero interior
    bytes and gathers nothing, every other consumer's gather is counted."""
    want, ranks = two
    check_case(ranks, want, ("stream_to_each_consumer", case))
    consumer, _batch, handoff = case.split("/")
    st = ranks[0]["stream_to_each_consumer"][case]["stats"]
    expect = np.linspace(0.0, 1.0, 4096, dtype=np.float32)
    for _ in range(2):
        expect = (expect + 1.0) * 0.5
    assert_same(ranks[0]["stream_to_each_consumer"][case]["values"]["out"], expect, case)
    if handoff == "True" and consumer == "sharded":
        assert st["interior"] == 0 and st["gathers"] == 0 and st["shard_passthrough"] >= 1
    if handoff == "True" and consumer != "sharded":
        assert st["stream_materialized"] >= 1 and st["gathers"] == 1


@pytest.mark.parametrize("batch", ["2048", "1000"])
def test_sharded_chunk_list_ingest_grids(two, batch):
    """A fused chunk list into a sharded stage: placed per shard with no
    rechunk on the shard grid, one ``rechunk`` on another grid."""
    want, ranks = two
    check_case(ranks, want, ("chunk_list_ingest_grids", batch))
    st = ranks[0]["chunk_list_ingest_grids"][batch]["stats"]
    assert st["shard_ingests"] == 1 and st["stream_materialized"] == 0
    assert st["handoff_rechunks"] == (0 if batch == "2048" else 1)


@pytest.mark.parametrize("order", ["sharded/fused", "fused/sharded"])
def test_sharded_stream_empty_inputs(two, order):
    want, ranks = two
    check_case(ranks, want, ("stream_empty_inputs", order))
    assert ranks[0]["stream_empty_inputs"][order]["values"]["out"].shape == (0,)


def check_reduction(world, name, dtype):
    """Each ReduceSplit op combines its per-rank partials across the group
    (all-reduce; mul an all-gather and a fold in shard order) and equals
    the reference's, dtype included, and the plain reduction of the input."""
    want, ranks = world
    key = f"{name}/{dtype}"
    check_case(ranks, want, ("reductions", key), dtype)
    got = ranks[0]["reductions"][key]
    assert got["dtype"] == want["reductions"][key]["dtype"]
    x = S.reduce_input(dtype)
    if dtype == "bfloat16":
        import torch
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    if dtype == "float16":
        x = x.astype(np.float32)
    plain = {"sum": np.sum, "max": np.max, "min": np.min, "prod": np.prod}[name](
        x.astype(np.int64) if dtype == "bool" and name in ("sum", "prod") else x)
    assert_same(np.asarray(got["values"]["r"], dtype=np.asarray(plain).dtype), plain,
                key, dtype)


@pytest.mark.parametrize("name,dtype", S.REDUCE_CASES, ids=REDUCE_IDS)
def test_sharded_reduction_per_op_and_dtype(two, name, dtype):
    check_reduction(two, name, dtype)


def test_broadcast_output_is_returned_on_every_rank_like_jax(two):
    """A broadcast-typed output of a two-shard stage is the same on every
    rank: returned as it is, the stage on ``sharded``, as the reference's."""
    want, ranks = two
    check_case(ranks, want, ("unsplit_outputs", "broadcast"))
    st = ranks[0]["unsplit_outputs"]["broadcast"]
    assert st["stats"]["sharded_stages"] == 1 and st["stats"]["exec_demotions"] == 0
    assert_same(st["values"]["out"], np.arange(8.0, dtype=np.float32) * 2.0, "broadcast")


def test_concat_output_is_refused_and_demoted_on_two_shards(two):
    """A ConcatSplit output's rows differ per rank: the port refuses the
    stage on ``sharded`` and the ladder runs it on ``scan``, every row
    there.  The reference's ``sharded`` returns rank 0's rows only (a
    reference quirk, asserted here as it is)."""
    want, ranks = two
    x = np.linspace(0.0, 1.0, 4096, dtype=np.float32) + 1.0
    oracle = np.repeat(x, 2)
    jax_side = want["unsplit_outputs"]["concat"]
    assert_same(jax_side["values"]["out"], np.repeat(x[:2048], 2), "reference: rank 0's rows")
    assert jax_side["stats"]["sharded_stages"] == 1
    for r, res in enumerate(ranks):
        got = res["unsplit_outputs"]["concat"]
        assert_same(got["values"]["out"], oracle, f"concat rank {r}")
        st = got["stats"]
        assert st["sharded_stages"] == 0, st
        assert st["exec_demotions"] == st["exec_demoted_to_scan"] == 1, st
        assert st == ranks[0]["unsplit_outputs"]["concat"]["stats"]


def test_auto_pick_agrees_across_ranks(two):
    """Two ranks whose analytic model and sample timings disagree run every
    stage of every call on the same executor and pin the same one: the
    fastest by its slowest rank (fused: 2 s against sharded's 5 s and
    scan's 3 s), from timings equal on both ranks; the values are right."""
    _want, ranks = two
    got = [r["auto_agreement"] for r in ranks]
    assert got[0]["picks"] == got[1]["picks"]
    assert got[0]["chosen"] == got[1]["chosen"] == {0: "fused"}
    assert got[0]["timings"] == got[1]["timings"]
    assert got[0]["timings"][0]["fused"] == 2.0 and got[0]["timings"][0]["sharded"] == 5.0
    assert got[0]["overrides"] == 0
    x = np.linspace(0.1, 2.0, 4096, dtype=np.float32)
    for res in got:
        for v in res["values"]["sum"]:
            np.testing.assert_allclose(v, np.exp(x.astype(np.float64)).sum(), rtol=2e-5)


def test_ladder_demotes_every_rank_when_one_fails(two):
    """``compile:fail:1`` on rank 1 only: both ranks quarantine ``cuda`` and
    demote once, together, to a ``sharded`` stage that runs (a one-rank
    demotion would leave rank 1 alone in the all-reduce)."""
    _want, ranks = two
    x = np.linspace(0.1, 2.0, 4096, dtype=np.float32)
    for res in ranks:
        got = res["ladder_agreement"]
        assert got["stats"] == {"exec_demotions": 1, "exec_demoted_to_sharded": 1,
                                "sharded_stages": 1}, got["stats"]
        assert got["quarantined"] == {0: ["cuda"]}
        np.testing.assert_allclose(got["values"]["sum"], np.exp(x.astype(np.float64)).sum(),
                                   rtol=2e-5)


def test_indivisible_element_count_demotes_like_jax(two):
    """4095 elements on 2 shards: ``sharded`` raises (PedanticError) and the
    ladder runs the stage on ``scan``, as the reference's."""
    want, ranks = two
    check_case(ranks, want, ("indivisible",))
    st = ranks[0]["indivisible"]["stats"]
    assert st["exec_demotions"] == st["exec_demoted_to_scan"] == 1
    assert st["sharded_stages"] == 0


# ---------------------------------------------------------------------------
# In this process: one rank
# ---------------------------------------------------------------------------


def test_host_mesh_defaults_to_the_card():
    """Without a card the default raises: a card session's mesh never lands
    on the CPU in silence."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        make_host_mesh()


def test_one_rank_mesh_helpers_and_set_mesh():
    from repro_torch.launch import mesh as tmesh
    m = S.port_mesh()
    assert tuple(m.mesh_dim_names) == ("data", "model") and tuple(m.shape) == (1, 1)
    assert (tmesh.data_axes_of(m), tmesh.dp_extent(m), tmesh.tp_extent(m)) == (("data",), 1, 1)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    assert tmesh.current_mesh() is None
    with tmesh.set_mesh(m) as cur:
        assert cur is m and tmesh.current_mesh() is m
    assert tmesh.current_mesh() is None


@pytest.mark.parametrize("inner", ["fused", "whole"])
def test_inner_executor_like_jax(inner):
    """``inner_executor="whole"`` runs each shard in one call, ``fused``
    chunk by chunk: the same values and counters as the reference's."""
    import jax.numpy as jnp
    import torch
    from repro.core import annotated_numpy as janp
    from repro.core import mozart as jmozart
    from repro_torch.core import annotated_numpy as tanp
    from repro_torch.core import mozart as tmozart
    x = np.linspace(0.1, 2.0, 4096, dtype=np.float32)
    kw = dict(executor="sharded", batch_elements=256, inner_executor=inner,
              plan_cache=False, autotune=False)
    with jmozart.session(mesh=S.jax_mesh(), **kw) as jctx:
        jv = np.asarray(janp.sum(janp.exp(jnp.asarray(x))))
    with tmozart.session(mesh=S.port_mesh(), device="cpu", **kw) as tctx:
        tv = tanp.sum(tanp.exp(torch.from_numpy(x))).value.numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    keys = ("sharded_stages", "stages", "chunks", "calls")
    assert {k: tctx.stats.get(k, 0) for k in keys} == {k: jctx.stats.get(k, 0) for k in keys}


def test_pytree_outputs_on_one_rank_like_jax():
    """A PytreeSplit stage on ``sharded`` (each leaf a DTensor) feeding a
    ``fused`` stage and observed: the reference's values and counters."""
    import jax.numpy as jnp
    import torch
    from repro.core import mozart as jmozart
    from repro.core import split_types as jst
    from repro.core import splittable as jsplittable
    from repro_torch.core import mozart as tmozart
    from repro_torch.core import split_types as tst
    from repro_torch.core import splittable as tsplittable

    def tree_step(s):
        return {"p": s["p"] * 0.5 + 1.0, "m": s["m"] + s["p"][:, None]}
    jstep = jsplittable(s=jst.Pytree(0), ret=jst.Pytree(0))(tree_step)
    tstep = tsplittable(s=tst.Pytree(0), ret=tst.Pytree(0))(tree_step)
    n = 1024
    state = {"p": np.arange(n, dtype=np.float32), "m": np.ones((n, 2), np.float32)}
    kw = dict(batch_elements=256, plan_cache=False, autotune=False)
    with jmozart.session(executor="sharded", mesh=S.jax_mesh(), **kw) as jctx:
        cur = jstep({k: jnp.asarray(v) for k, v in state.items()})
        jmozart.evaluate()
        jmozart.configure(executor="fused")
        want = {k: np.asarray(v) for k, v in jstep(cur).value.items()}
    with tmozart.session(executor="sharded", mesh=S.port_mesh(), device="cpu", **kw) as tctx:
        cur = tstep({k: torch.from_numpy(v.copy()) for k, v in state.items()})
        tmozart.evaluate()
        tmozart.configure(executor="fused")
        got = {k: v.numpy() for k, v in tstep(cur).value.items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5)
    keys = S.STATS + ("stages", "chunks")
    assert {k: tctx.stats.get(k, 0) for k in keys} == {k: jctx.stats.get(k, 0) for k in keys}
