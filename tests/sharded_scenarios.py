"""The multi-rank ``sharded`` scenarios, run by both packages.

The counterparts of ``tests/test_core_sharded.py``'s seven tests and of one
reduction per ``ReduceSplit`` op and dtype, written once against a
namespace of each side's modules: the JAX package in ONE subprocess per
device count (``run_jax``: ``XLA_FLAGS=--xla_force_host_platform_device_count=N``,
every mesh built with Auto axes, the behaviour the reference was written
for), and the port in a ``gloo`` world of N spawned ranks (``torch_rank``)
that meet through a ``FileStore``.  Each side writes, per scenario, the
values (numpy) and the counters the tests compare; each rank of the port
writes its own file.

This module imports neither JAX nor torch at import time: the spawned ranks
import it and must not load JAX.
"""

from __future__ import annotations

import os
import pickle
import sys
import types

import numpy as np

#: counters compared exactly between the packages
STATS = ("sharded_stages", "shard_passthrough", "shard_ingests",
         "handoff_rechunks", "stream_materialized", "streamed_outputs")

#: the reductions: annotated op -> ReduceSplit op, and the input dtypes
#: (every dtype the typed split-pipeline path takes: the partials travel
#: as int8, int16, uint8, uint32, float16 and the rest)
REDUCTIONS = {"sum": "add", "max": "max", "min": "min", "prod": "mul"}
REDUCE_DTYPES = ("float32", "int32", "bool", "bfloat16", "int8", "int16", "uint8",
                 "uint16", "uint32", "float16")
#: every pair: uint16 and uint32 max and min included (ROADMAP C13)
REDUCE_CASES = tuple((name, dtype) for dtype in REDUCE_DTYPES for name in REDUCTIONS)
REDUCE_N = 4096

#: device counts -> the scenarios that run there
SCENARIOS = {
    8: ("elementwise_and_reduce", "multipod_axes", "reductions", "mesh_helpers"),
    4: ("output_sharding", "elastic_restore"),
    2: ("stream_to_each_consumer", "chunk_list_ingest_grids",
        "stream_empty_inputs", "reductions", "indivisible", "unsplit_outputs"),
}
#: scenarios of the port alone: SPMD ranks agreeing where the reference has
#: one controller
PORT_SCENARIOS = {2: ("auto_agreement", "ladder_agreement")}


def jax_mesh(shape=(1,), axes=("data",)):
    """A reference mesh with Auto axes (jax 0.9's ``make_mesh`` default,
    Explicit, breaks two of the reference's own sharded tests)."""
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def port_mesh():
    """The port's one-rank CPU mesh (a one-rank ``gloo`` group in this
    process, started on first use)."""
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(device="cpu")


def _counters(ns, ctx) -> dict:
    out = {k: int(ctx.stats.get(k, 0)) for k in STATS}
    out["interior"] = int(ctx.counters.bytes_interior())
    out["gathers"] = sum(1 for e in ctx.counters.materialize_events()
                         if e[0].startswith("interior:gather"))
    return out


def elementwise_and_reduce(ns) -> dict:
    mesh = ns.mesh((8,), ("data",))
    x = ns.arr(np.arange(4096.0, dtype=np.float32))
    with ns.session(executor="sharded", mesh=mesh, batch_elements=64) as ctx:
        b = ns.anp.multiply(ns.anp.log1p(x), 3.0)
        s = ns.anp.sum(b)
        got, sgot = ns.tonp(b), float(ns.tonp(s))
    return {"values": {"b": got, "s": sgot}, "stats": _counters(ns, ctx)}


def output_sharding(ns) -> dict:
    mesh = ns.mesh((4,), ("data",))
    m = np.random.RandomState(0).randn(64, 8).astype(np.float32)
    with ns.session(executor="sharded", mesh=mesh) as ctx:
        y = ns.anp.matvec(ns.arr(m), ns.arr(np.ones(8, np.float32)))
        z = ns.anp.exp(y)
        ns.mozart.evaluate()
        shapes = ns.local_shapes(z)
        got = ns.tonp(z)
    return {"values": {"z": got}, "local_shapes": shapes, "stats": _counters(ns, ctx)}


def multipod_axes(ns) -> dict:
    mesh = ns.mesh((2, 4), ("pod", "data"))
    x = ns.arr(np.arange(1024.0, dtype=np.float32) / 128.0)
    with ns.session(executor="sharded", mesh=mesh, data_axes=("pod", "data")) as ctx:
        y = ns.anp.add(ns.anp.exp(x), 1.0)
        s = ns.anp.sum(y)
        got, sg = ns.tonp(y), float(ns.tonp(s))
    return {"values": {"y": got, "s": sg}, "stats": _counters(ns, ctx)}


def stream_to_each_consumer(ns) -> dict:
    """A sharded producer's stream into every consumer executor, at a batch
    equal to the shard grid and at one that leaves a 96-element tail, with
    handoff on and off."""
    mesh = ns.mesh((2,), ("data",))
    n = 4096
    x = ns.arr(np.linspace(0.0, 1.0, n, dtype=np.float32))
    out = {}
    for consumer in ("fused", "scan", "cuda", "sharded"):
        for batch in (2048, 1000):
            if consumer == "sharded" and batch != 2048:
                continue        # sharded grids come from the mesh
            for handoff in (True, False):
                ns.plan_cache.clear()
                with ns.session(executor="sharded", mesh=mesh, batch_elements=2048,
                                handoff=handoff) as ctx:
                    cur = ns.anp.multiply(ns.anp.add(x, 1.0), 0.5)
                    ns.mozart.evaluate()
                    ns.mozart.configure(executor=ns.executor(consumer),
                                        batch_elements=batch)
                    cur = ns.anp.multiply(ns.anp.add(cur, 1.0), 0.5)
                    got = ns.tonp(cur)
                out[f"{consumer}/{batch}/{handoff}"] = {
                    "values": {"out": got}, "stats": _counters(ns, ctx)}
    return out


def chunk_list_ingest_grids(ns) -> dict:
    """A fused producer's chunk list into a sharded consumer: a grid equal to
    the shard layout, and one that ``rechunk`` converts once."""
    mesh = ns.mesh((2,), ("data",))
    n = 4096
    x = ns.arr(np.linspace(0.0, 1.0, n, dtype=np.float32))
    out = {}
    for batch in (2048, 1000):
        ns.plan_cache.clear()
        with ns.session(executor="fused", mesh=mesh, batch_elements=batch) as ctx:
            cur = ns.anp.multiply(ns.anp.add(x, 1.0), 0.5)
            ns.mozart.evaluate()
            ns.mozart.configure(executor="sharded")
            cur = ns.anp.multiply(ns.anp.add(cur, 1.0), 0.5)
            got = ns.tonp(cur)
        out[str(batch)] = {"values": {"out": got}, "stats": _counters(ns, ctx)}
    return out


def stream_empty_inputs(ns) -> dict:
    mesh = ns.mesh((2,), ("data",))
    z = ns.arr(np.zeros((0,), np.float32))
    out = {}
    for first, second in (("sharded", "fused"), ("fused", "sharded")):
        ns.plan_cache.clear()
        with ns.session(executor=first, mesh=mesh, batch_elements=64) as ctx:
            cur = ns.anp.add(z, 1.0)
            ns.mozart.evaluate()
            ns.mozart.configure(executor=second)
            got = ns.tonp(ns.anp.multiply(cur, 2.0))
        out[f"{first}/{second}"] = {"values": {"out": got}, "stats": _counters(ns, ctx)}
    return out


def indivisible(ns) -> dict:
    """An element count the mesh extent does not divide: ``sharded`` raises
    and the ladder demotes the stage (to ``scan``), counted."""
    mesh = ns.mesh((2,), ("data",))
    x = ns.arr(np.linspace(0.0, 1.0, 4095, dtype=np.float32))
    with ns.session(executor="sharded", mesh=mesh, batch_elements=512) as ctx:
        got = ns.tonp(ns.anp.multiply(ns.anp.add(x, 1.0), 0.5))
    out = {"values": {"out": got}, "stats": _counters(ns, ctx)}
    out["stats"].update({k: int(ctx.stats.get(k, 0)) for k in
                         ("exec_demotions", "exec_demoted_to_scan")})
    return out


def _repeat2(x):
    return x.repeat_interleave(2) if hasattr(x, "repeat_interleave") else x.repeat(2)


def _scale_of(x, w):
    return w * 2.0


def unsplit_outputs(ns) -> dict:
    """Outputs with no split axis besides reductions on two shards: a
    broadcast output (the same on every rank) is returned as it is; a
    ConcatSplit output's rows differ per rank, so the port refuses it and
    the ladder runs the stage on ``scan`` (the reference returns rank 0's
    rows: a reference quirk)."""
    mesh = ns.mesh((2,), ("data",))
    x = ns.arr(np.linspace(0.0, 1.0, 4096, dtype=np.float32))
    w = ns.arr(np.arange(8.0, dtype=np.float32))
    scale = ns.splittable(x=ns.st.Along(0), w=ns.st.Broadcast(),
                          ret=ns.st.Broadcast())(_scale_of)
    rep2 = ns.splittable(x=ns.st.Along(0), ret=ns.st.Concat("rep2", 0))(_repeat2)
    out = {}
    for name, run in (("broadcast", lambda: scale(ns.anp.add(x, 1.0), w)),
                      ("concat", lambda: rep2(ns.anp.add(x, 1.0)))):
        ns.plan_cache.clear()
        with ns.session(executor="sharded", mesh=mesh, batch_elements=512) as ctx:
            got = ns.tonp(run())
        out[name] = {"values": {"out": got}, "stats": _counters(ns, ctx)}
        out[name]["stats"].update({k: int(ctx.stats.get(k, 0)) for k in
                                   ("exec_demotions", "exec_demoted_to_scan")})
    return out


def auto_agreement(ns) -> dict:
    """``auto`` on two ranks that see different costs: rank 1's analytic
    model reads a 1000x dispatch, and each rank's sample timings rank the
    candidates in another order (rank 0: sharded, fused, scan; rank 1:
    fused, scan, sharded).  Three calls (the miss, the first hit, which
    measures and pins, a warm replay): every rank runs each stage on the
    same executor and pins the same one."""
    import torch.distributed as dist
    from repro_torch import hardware
    from repro_torch.core import stage_exec
    rank = dist.get_rank()
    fake = ({"sharded": 1.0, "fused": 2.0, "scan": 3.0} if rank == 0
            else {"fused": 1.0, "scan": 3.0, "sharded": 5.0})
    mesh = ns.mesh((2,), ("data",))
    x = ns.arr(np.linspace(0.1, 2.0, 4096, dtype=np.float32))
    real_time, real_dispatch = (stage_exec.StageExecutor.sampled_time,
                                hardware.measured_dispatch_overhead_s)
    stage_exec.StageExecutor.sampled_time = (
        lambda self, *a, **k: fake.get(self.name, 10.0))
    if rank == 1:
        hardware.measured_dispatch_overhead_s = lambda device="cuda": 1e3 * real_dispatch(device)
    try:
        picks, values = [], []
        for _call in range(3):
            with ns.session(executor="auto", mesh=mesh) as ctx:
                values.append(ns.tonp(ns.anp.sum(ns.anp.exp(x))))
            picks.append({k: int(v) for k, v in ctx.stats.items()
                          if k.startswith("auto_pick_")})
    finally:
        stage_exec.StageExecutor.sampled_time = real_time
        hardware.measured_dispatch_overhead_s = real_dispatch
    (entry,) = ns.plan_cache.entries()
    return {"values": {"sum": values}, "picks": picks,
            "chosen": dict(entry.chosen_exec),
            "timings": {k: dict(v) for k, v in entry.exec_timings.items()},
            "overrides": int(ctx.stats.get("auto_mesh_overrides", 0))}


def ladder_agreement(ns) -> dict:
    """``compile:fail:1`` on rank 1 only, on ``cuda`` with a two-rank mesh:
    rank 0's ``cuda`` attempt ran, but both ranks demote, together, to a
    ``sharded`` stage that runs (its all-reduce made by both)."""
    import torch.distributed as dist
    mesh = ns.mesh((2,), ("data",))
    x = ns.arr(np.linspace(0.1, 2.0, 4096, dtype=np.float32))
    with ns.session(executor="cuda", mesh=mesh, batch_elements=512) as ctx:
        r = ns.anp.sum(ns.anp.exp(x))
        if dist.get_rank() == 1:
            with ns.mozart.inject_faults("compile:fail:1"):
                got = ns.tonp(r)
        else:
            got = ns.tonp(r)
    keys = ("exec_demotions", "exec_demoted_to_sharded", "sharded_stages")
    (entry,) = ns.plan_cache.entries()
    return {"values": {"sum": got}, "stats": {k: int(ctx.stats.get(k, 0)) for k in keys},
            "quarantined": {k: sorted(v) for k, v in entry.quarantined.items()}}


def mesh_helpers(ns) -> dict:
    """``make_host_mesh`` clamping and the axis helpers over 8 ranks."""
    out = {}
    for n_data, n_model in ((8, 1), (2, 4), (16, 1), (3, 5)):
        m = ns.host_mesh(n_data, n_model)
        out[f"host_{n_data}x{n_model}"] = ns.describe_mesh(m)
    out["pod_data"] = ns.describe_mesh(ns.mesh((2, 4), ("pod", "data")))
    return {"values": {}, "stats": {}, "meshes": out}


def reduce_input(dtype: str) -> np.ndarray:
    """Seeded inputs whose products stay finite and exact (within 32 bits
    unsigned): float32 and bfloat16 near 1, signed integers in {-1, 1}
    with five 2s (float16 also five halves: every sum and product is exact
    in half precision), unsigned ones 1 with twenty 2s and five 3s, random
    bools."""
    rs = np.random.RandomState(7)
    if dtype == "bool":
        return rs.rand(REDUCE_N) < 0.5
    if dtype in ("int8", "int16", "int32", "float16"):
        v = np.where(rs.rand(REDUCE_N) < 0.5, -1, 1).astype(dtype)
        v[rs.choice(REDUCE_N, 5, replace=False)] = 2
        if dtype == "float16":
            v[rs.choice(REDUCE_N, 5, replace=False)] = 0.5
        return v
    if dtype in ("uint8", "uint16", "uint32"):
        v = np.ones(REDUCE_N, dtype)
        v[rs.choice(REDUCE_N, 20, replace=False)] = 2
        v[rs.choice(REDUCE_N, 5, replace=False)] = 3
        return v
    return (1.0 + (rs.rand(REDUCE_N) - 0.5) * 1e-3).astype(np.float32)


def reductions(ns) -> dict:
    """One reduction per ReduceSplit op and input dtype on a mesh over every
    rank, in chunks of 512 per shard; bfloat16 inputs are the float32 ones
    rounded."""
    mesh = ns.mesh((ns.world(),), ("data",))
    out = {}
    for name, dtype in REDUCE_CASES:
        x = ns.arr(reduce_input(dtype), dtype)
        ns.plan_cache.clear()
        with ns.session(executor="sharded", mesh=mesh, batch_elements=512) as ctx:
            r = getattr(ns.anp, name)(x)
            got = ns.tonp(r)
        out[f"{name}/{dtype}"] = {"values": {"r": got}, "dtype": ns.dtype_name(r),
                                  "stats": _counters(ns, ctx)}
    return out


def elastic_restore(ns) -> dict:
    """Save on one layout, restore sharded onto a 4-rank mesh."""
    tree = {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
            "b": np.arange(8.0, dtype=np.float32)}
    return ns.restore_round_trip(tree, (4,), ("data",))


# ---------------------------------------------------------------------------
# The JAX side: one subprocess per device count
# ---------------------------------------------------------------------------


def _jax_ns(ckpt_dir: str):
    import warnings
    warnings.filterwarnings("ignore")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.ckpt import checkpoint as ckpt
    from repro.core import annotated_numpy as anp
    from repro.core import mozart, plan_cache, splittable
    from repro.core import split_types as st

    mesh = jax_mesh
    def tonp(v):
        a = np.asarray(v)
        return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a

    def local_shapes(fut):
        return sorted({tuple(s.data.shape) for s in fut.value.addressable_shards})

    def restore_round_trip(tree, shape, axes):
        ckpt.save(ckpt_dir, 3, {k: jnp.asarray(v) for k, v in tree.items()})
        m = mesh(shape, axes)
        sh = {"w": NamedSharding(m, P("data", None)), "b": NamedSharding(m, P())}
        avals = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in tree.items()}
        r = ckpt.restore(ckpt_dir, 3, avals, sh)
        return {"values": {k: np.asarray(v) for k, v in r.items()},
                "local_shapes": {k: sorted({tuple(s.data.shape)
                                            for s in v.addressable_shards})
                                 for k, v in r.items()},
                "n_shards": {k: len(v.addressable_shards) for k, v in r.items()}}

    from repro.launch import mesh as jmesh

    def describe_mesh(m):
        return (tuple(int(m.shape[a]) for a in m.axis_names), tuple(m.axis_names),
                jmesh.data_axes_of(m), jmesh.dp_extent(m),
                jmesh.tp_extent(m) if "model" in m.axis_names else 1)

    return types.SimpleNamespace(
        anp=anp, mozart=mozart, plan_cache=plan_cache, mesh=mesh, tonp=tonp,
        splittable=splittable, st=st, host_mesh=jmesh.make_host_mesh,
        describe_mesh=describe_mesh,
        world=lambda: len(jax.devices()),
        arr=lambda a, dtype=None: jnp.asarray(a, dtype=dtype),
        session=mozart.session, executor=lambda e: {"cuda": "pallas"}.get(e, e),
        local_shapes=local_shapes, dtype_name=lambda f: str(np.asarray(f).dtype),
        restore_round_trip=restore_round_trip)


def run_jax(n_devices: int, out_path: str, ckpt_dir: str) -> None:
    ns = _jax_ns(ckpt_dir)
    results = {}
    for name in SCENARIOS[n_devices]:
        ns.plan_cache.clear()
        results[name] = globals()[name](ns)
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# The port's side: a gloo world of spawned ranks
# ---------------------------------------------------------------------------


def _torch_ns(ckpt_dir: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart, plan_cache, splittable
    from repro_torch.core import split_types as st
    from repro_torch.core.stage_exec import ChunkStream
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.mesh import make_mesh

    def describe_mesh(m):
        return (tuple(int(s) for s in m.shape), tuple(m.mesh_dim_names),
                tmesh.data_axes_of(m), tmesh.dp_extent(m), tmesh.tp_extent(m))

    def mesh(shape, axes):
        return make_mesh(shape, axes, device="cpu")

    def arr(a, dtype=None):
        t = torch.from_numpy(np.array(a))
        return t.to(getattr(torch, dtype)) if dtype == "bfloat16" else t

    def tonp(v):
        t = v.value if hasattr(v, "_node") else v
        if isinstance(t, torch.Tensor):
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return np.asarray(t)

    def local_shapes(fut):
        res = fut._node.result
        d = res.sharded if isinstance(res, ChunkStream) else res
        return sorted({tuple(d.to_local().shape)})

    def dtype_name(fut):
        d = fut.value.dtype
        return "bfloat16" if d == torch.bfloat16 else str(tonp(fut).dtype)

    def restore_round_trip(tree, shape, axes):
        if dist.get_rank() == 0:
            ckpt.save(ckpt_dir, 3, {k: torch.from_numpy(v) for k, v in tree.items()})
        dist.barrier()
        m = mesh(shape, axes)
        sh = {"w": (m, (Shard(0),)), "b": (m, (Replicate(),))}
        target = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
                  for k, v in tree.items()}
        r = ckpt.restore(ckpt_dir, 3, target, sh)
        return {"values": {k: v.full_tensor().numpy() for k, v in r.items()},
                "local_shapes": {k: [tuple(v.to_local().shape)] for k, v in r.items()},
                "n_shards": {k: int(m.size()) for k in r}}

    return types.SimpleNamespace(
        anp=anp, mozart=mozart, plan_cache=plan_cache, mesh=mesh, tonp=tonp,
        splittable=splittable, st=st,
        host_mesh=lambda d, m: tmesh.make_host_mesh(d, m, device="cpu"),
        describe_mesh=describe_mesh, world=dist.get_world_size,
        arr=arr, session=lambda **kw: mozart.session(device="cpu", **kw),
        executor=lambda e: e, local_shapes=local_shapes, dtype_name=dtype_name,
        restore_round_trip=restore_round_trip)


def torch_rank(rank: int, world: int, store_path: str, out_dir: str,
               ckpt_dir: str, timeout_s: float) -> None:
    """One rank of the port's world: join the group, run the scenarios of
    this world size, write ``rank<r>.pkl``."""
    from datetime import timedelta

    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        ns = _torch_ns(ckpt_dir)
        results = {}
        for name in SCENARIOS[world] + PORT_SCENARIOS.get(world, ()):
            ns.plan_cache.clear()
            results[name] = globals()[name](ns)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":          # the JAX side: n_devices out_path ckpt_dir
    run_jax(int(sys.argv[1]), sys.argv[2], sys.argv[3])
