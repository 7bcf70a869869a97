"""Mesh execution of Mozart stages: splits become ranks.

The counterpart of ``src/repro/core/sharded.py``.  The paper parallelizes
chunks over the threads of one CPU; here the *first* level of splitting maps
onto the ranks of a ``torch.distributed`` mesh (``launch/mesh.py``) and the
associative merge becomes either "already sharded" (concat-style merges,
whose output is a ``DTensor``) or a collective (``ReduceSplit``: an
all-reduce, or an all-gather and an ordered fold for ``mul``).  Within each
rank the stage still runs the fast-memory chunk loop, so both memory tiers
are handled by the same annotation.

The reference is single-controller: one process holds a global array and
``shard_map`` runs the local function per device.  The port is SPMD: every
rank runs the same program on the same inputs, slices its own range of the
stage's split axis and runs the per-shard chunk loop on plain local tensors
(never on DTensors, whose ops may insert collectives unasked).  A
concat-split output is a ``DTensor`` with ``Shard(axis)`` on each data mesh
dimension and ``Replicate()`` on the others; reading it whole
(``gather_whole``) is one all-gather over the data axes (one flattened
group, row-major, for several data axes) that every rank makes.

The per-shard loop is the ``fused`` chain (``chain_plan``/``run_plan``), the
reference's inner loop of jnp ops: no split-pipeline kernel runs here.  The
driver is pinned into the plan-cache entry (``pinned_exec``, keyed also on
the mesh's ranks); the inner chunk size takes part in auto-tuning, with
sample slices rounded to the mesh extent so they stay shardable.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.core import split_types as st
from repro_torch.core.planner import Stage
from repro_torch.core.stage_exec import (
    ChunkStream,
    PedanticError,
    SAMPLE_CHUNKS,
    StageExecutor,
    batch_ranges,
    candidate_batches,
    chain_plan,
    effective_elements,
    get_executor,
    has_dynamic,
    is_dtensor,
    note_materialized,
    note_trace,
    pinned_exec,
    register_executor,
    run_plan,
    split_axis_of,
    stage_num_elements,
    whole_value,
)


@register_executor("sharded")
class ShardedExecutor(StageExecutor):
    """Splits = mesh shards; the per-rank chunk loop handles fast memory."""

    tunable = True           # tunes the INNER per-shard chunk loop
    # Handed-off streams enter without a merge: a chunk list is regrouped
    # onto the shard grid (``rechunk`` at most once) and this rank keeps its
    # chunk; a SHARDED-form stream from an earlier sharded stage passes its
    # local shard straight through (zero interior bytes, no gather).
    stream_capable = True
    shard_capable = True

    def execute(self, stage: Stage, concrete: dict[tuple, Any], ctx) -> None:
        execute_stage_sharded(stage, concrete, ctx, self)

    # -- tuner integration ---------------------------------------------------
    def tuning_candidates(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                          est: int, n: int) -> list[int]:
        # The tuned quantity is the PER-SHARD chunk size: bracket the §5.2
        # estimate within one local shard's element count.
        n_local = max(1, n // max(mesh_extent(ctx), 1))
        return candidate_batches(est, n_local)

    def sample_elems(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                     batch: int, n: int) -> int:
        # Sample slices must stay divisible by the mesh extent: give every
        # shard SAMPLE_CHUNKS chunks and round to a multiple of the extent.
        if n <= 0:
            return 0
        m = max(mesh_extent(ctx), 1)
        s = min(n, SAMPLE_CHUNKS * batch * m)
        return max(m, (s // m) * m)


# ---------------------------------------------------------------------------
# Mesh geometry
# ---------------------------------------------------------------------------


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def data_extent(mesh, axes: tuple[str, ...]) -> int:
    m = 1
    for a in axes:
        m *= axis_size(mesh, a)
    return m


def mesh_extent(ctx) -> int:
    """The data-axis extent of the context's mesh (1 without a mesh)."""
    mesh = getattr(ctx, "mesh", None)
    return 1 if mesh is None else data_extent(mesh, tuple(ctx.data_axes))


def _row_major(coord, dims: list[int], mesh) -> int:
    idx = 0
    for d in dims:
        idx = idx * int(mesh.shape[d]) + int(coord[d])
    return idx


def data_group(mesh, dims: tuple[int, ...]):
    """The process group over the mesh dimensions ``dims`` (one flattened
    group for several) and the shard index of each of its ranks, row-major
    over ``dims`` as the reference's ``P(("pod", "data"))``.  The groups
    are the ``DeviceMesh``'s own (``get_group``, ``_flatten``), cached by
    the mesh; every rank calls this in the same order (SPMD)."""
    names = [mesh.mesh_dim_names[d] for d in dims]
    if len(dims) == 1:
        group = mesh.get_group(dims[0])
    else:
        group = mesh[tuple(names)]._flatten("_".join(names)).get_group()
    grid = mesh.mesh
    order = [_row_major((grid == g).nonzero()[0].tolist(), list(dims), mesh)
             for g in dist.get_process_group_ranks(group)]
    return group, order


def mesh_group(ctx):
    """The group over every rank of the context's mesh, or None where the
    mesh (if any) has one rank: where every rank must take the same
    decision (``agree``)."""
    mesh = getattr(ctx, "mesh", None)
    if mesh is None or mesh.size() == 1:
        return None
    return data_group(mesh, tuple(range(mesh.ndim)))[0]


def agree(group, obj) -> list:
    """Every rank's ``obj`` in group-rank order (one ``all_gather_object``):
    SPMD ranks decide alike from the same list."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _data_dims(mesh, axes: tuple[str, ...]) -> tuple[int, ...]:
    return tuple(mesh.mesh_dim_names.index(a) for a in axes)


def shard_index(mesh, axes: tuple[str, ...]) -> int:
    """This rank's shard: its row-major position over the data axes."""
    return _row_major(mesh.get_coordinate(), list(_data_dims(mesh, axes)), mesh)


def placements_for(mesh, axes: tuple[str, ...], axis: int) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(axis) if name in axes else Replicate()
                 for name in mesh.mesh_dim_names)


# ---------------------------------------------------------------------------
# Collectives (every rank of the group calls them, in the same order)
# ---------------------------------------------------------------------------

#: what a partial travels as where the backends cannot carry its dtype
#: (neither NCCL nor gloo has int16, uint16 or uint32; they differ on bool
#: reductions): a wider type that holds every value, so a gather is exact
#: and add, max and min give the value modulo 2**k on the cast back.
#: ``annotation.canonicalize`` leaves no uint64.
WIRE = {torch.bool: torch.uint8, torch.int16: torch.int32, torch.uint16: torch.int32,
         torch.uint32: torch.int64}


def _all_gather(value: torch.Tensor, group, order: list[int]) -> list:
    """Every shard's ``value``, in shard order."""
    wire = WIRE.get(value.dtype)
    if wire is not None:
        return [p.to(value.dtype) for p in _all_gather(value.to(wire), group, order)]
    flat = value.contiguous()
    parts = [torch.empty_like(flat) for _ in order]
    dist.all_gather(parts, flat, group=group)
    by_shard = [None] * len(order)
    for j, p in zip(order, parts):
        by_shard[j] = p
    return by_shard


_REDUCE_OPS = {"add": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def psum_like(t: st.ReduceSplit, value, group, order: list[int]):
    """Combine one partial per shard with the split type's operator: an
    all-reduce for add/max/min; for mul (no product collective) an
    all-gather and a fold in shard order, as the reference's
    ``_psum_like``.  One rank makes the same collective (a copy), so the
    path is the same at every extent."""
    if not isinstance(value, torch.Tensor):
        return pytree.tree_map(lambda l: psum_like(t, l, group, order), value)
    if t.op_name == "mul":
        return t.merge(_all_gather(value, group, order))
    op = _REDUCE_OPS.get(t.op_name)
    if op is None:
        raise ValueError(t.op_name)
    wire = WIRE.get(value.dtype)
    buf = (value.to(wire) if wire is not None
           else value.clone(memory_format=torch.contiguous_format))
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(value.dtype)


def gather_whole(dt) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` sharded by this executor: one
    all-gather over its shard dimensions, concatenated in shard order (the
    local tensor itself where there is one shard)."""
    local = dt.to_local()
    mesh, placements = dt.device_mesh, dt.placements
    dims = tuple(i for i, p in enumerate(placements) if p.is_shard())
    if not dims or all(int(mesh.shape[d]) == 1 for d in dims):
        return local
    group, order = data_group(mesh, dims)
    return torch.cat(_all_gather(local, group, order), dim=placements[dims[0]].dim)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def _build_sharded_driver(stage: Stage, in_ckeys: list[tuple],
                          in_split_types: list, esc_pos: list[int],
                          out_types_by_pos: dict, n_local: int, batch: int,
                          whole: bool) -> Callable:
    """The per-rank driver: the chunk loop over this rank's shard, then each
    output's merge and, for ``ReduceSplit`` outputs, the cross-shard
    combine over ``group``."""
    note_trace()
    plan = chain_plan(stage)

    def local_fn(vals: list, group, order: list[int]) -> list:
        env = dict(zip(in_ckeys, vals))
        if whole or batch >= n_local:
            run_plan(plan, env)
            chunk_outs = {p: [env[("n", p)]] for p in esc_pos}
        else:
            chunk_outs = {p: [] for p in esc_pos}
            for s, e in batch_ranges(n_local, batch):
                cenv = {ck: (t.split(env[ck], s, e) if t is not None else env[ck])
                        for ck, t in zip(in_ckeys, in_split_types)}
                run_plan(plan, cenv)
                for p in esc_pos:
                    chunk_outs[p].append(cenv[("n", p)])
        outs = []
        for p in esc_pos:
            t = out_types_by_pos[p]
            merged = t.merge(chunk_outs[p])
            if isinstance(t, st.ReduceSplit):
                merged = psum_like(t, merged, group, order)
            outs.append(merged)
        return outs

    return local_fn


def _ingest_streams(stage: Stage, concrete: dict[tuple, Any], ctx, mesh,
                    axes, n: int, n_local: int,
                    shard_ranges: list[tuple[int, int]], me: int, ho) -> set:
    """Put this rank's shard of each handed-off ChunkStream input in place,
    without merging; returns the keys whose value is now the local shard.
    What ``_stream_shard`` cannot place materializes, counted by
    ``ChunkStream.materialize`` and in ``stream_materialized``."""
    local: set = set()
    for i, (key, si) in enumerate(stage.inputs.items()):
        v = concrete.get(key)
        if not isinstance(v, ChunkStream):
            continue
        shard = _stream_shard(stage, ctx, v, si.split_type, i, mesh, axes, n,
                              n_local, shard_ranges, me, ho)
        if shard is None:
            concrete[key] = v.materialize()
            ctx.stats["stream_materialized"] += 1
        else:
            concrete[key] = shard
            local.add(key)
    return local


def _stream_shard(stage: Stage, ctx, v: ChunkStream, t: st.SplitType, i: int,
                  mesh, axes, n: int, n_local: int,
                  shard_ranges: list[tuple[int, int]], me: int, ho):
    """This rank's shard of stream ``v`` (input ``i``), or None.

    Two paths, in order of preference: a SHARDED-form stream whose layout
    matches the target (same mesh and placements, shard-grid ranges) passes
    its local shard through (zero interior bytes, no gather); a chunk-list
    or stacked stream is regrouped onto the shard grid (``rechunk`` at most
    once, counted) and this rank keeps its chunk.  None for what the shard
    grid cannot express (pytree leaves, zero-element grids, another
    layout)."""
    ax = split_axis_of(t)
    leaves = pytree.tree_leaves(v.aval)
    if (ax is None or n_local <= 0 or len(leaves) != 1
            or v.n != n or len(leaves[0].shape) <= ax):
        return None
    if v.sharded is not None:
        if (ho is None or i not in ho.shard_in
                or v.sharding != (mesh, placements_for(mesh, axes, ax))
                or list(v.ranges) != shard_ranges):
            return None
        ctx.stats["shard_passthrough"] += 1
        return v.sharded.to_local()
    chunks = list(v.chunks)
    if list(v.ranges) != shard_ranges:
        if len(chunks) != len(v.ranges):
            return None
        chunks, copied = t.rechunk(chunks, list(v.ranges), shard_ranges)
        if copied:
            note_materialized(copied, kind="rechunk",
                              where=f"stage {stage.id} shard ingest input {i}")
        ctx.stats["handoff_rechunks"] += 1
    if me >= len(chunks):
        return None
    ctx.stats["shard_ingests"] += 1
    return chunks[me]


def _local_input(v: Any, t: st.SplitType, mesh, axes, lo: int, hi: int,
                 n_shards: int) -> Any:
    """This rank's range ``[lo, hi)`` of a whole input (a ``DTensor`` laid
    out on this mesh gives its local shard without moving)."""
    ax = split_axis_of(t)
    if (t.splittable and ax is not None and is_dtensor(v) and v.device_mesh == mesh
            and tuple(v.placements) == placements_for(mesh, axes, ax)):
        return v.to_local()
    v = whole_value(v)
    return v if not t.splittable or n_shards == 1 else t.split(v, lo, hi)


def execute_stage_sharded(stage: Stage, concrete: dict[tuple, Any], ctx,
                          executor: StageExecutor | None = None) -> None:
    mesh = getattr(ctx, "mesh", None)
    if mesh is None:
        raise ValueError("sharded executor requires mozart.session(mesh=...)")
    if has_dynamic(stage):
        # Fresh rows of a dynamic-shape function have no shard layout (the
        # reference cannot trace them under shard_map either): the ladder
        # demotes the stage, counted.
        raise NotImplementedError(
            f"sharded: stage {stage.id} holds dynamic-shape functions")
    axes = tuple(ctx.data_axes)
    n_shards = data_extent(mesh, axes)
    if n_shards > 1:
        for nid in stage.escaping:
            t = stage.out_types[nid]
            if (split_axis_of(t) is None
                    and not isinstance(t, (st.ReduceSplit, st.ScalarSplit))):
                # A broadcast output is the same on every rank; a reduction
                # is combined.  Any other output's rows differ per rank
                # (fresh rows of a ConcatSplit or an unknown): refuse before
                # any work, and the ladder demotes (the reference returns
                # rank 0's rows).
                raise NotImplementedError(
                    f"sharded: a {t} output cannot be combined across "
                    f"{n_shards} shards")

    n = effective_elements(ctx, stage_num_elements(stage, concrete, ctx.pedantic))
    if n % n_shards != 0:
        raise PedanticError(
            f"stage element count {n} not divisible by mesh data extent {n_shards}")
    n_local = n // n_shards
    shard_ranges = [(i * n_local, (i + 1) * n_local) for i in range(n_shards)]
    me = shard_index(mesh, axes)
    lo, hi = shard_ranges[me]
    plan_ho = getattr(ctx, "_handoff", None)
    ho = plan_ho.get(stage.id) if plan_ho else None
    concrete = dict(concrete)
    local = _ingest_streams(stage, concrete, ctx, mesh, axes, n, n_local,
                            shard_ranges, me, ho)
    executor = executor or get_executor("sharded")
    # Inner per-shard chunk size: explicit override > auto-tuner pin > §5.2.
    batch = executor.choose_batch(stage, concrete, ctx, max(n_local, 1))
    whole = ctx.inner_executor == "whole"

    in_keys = list(stage.inputs)
    vals = [concrete[k] if k in local else
            _local_input(concrete[k], stage.inputs[k].split_type, mesh, axes,
                         lo, hi, n_shards)
            for k in in_keys]
    in_ckeys = [stage.ckey(k) for k in in_keys]
    in_split_types = [stage.inputs[k].split_type
                      if stage.inputs[k].split_type.splittable else None
                      for k in in_keys]
    out_ids = sorted(stage.escaping)
    esc_pos = [stage.pos[nid] for nid in out_ids]
    out_types_by_pos = {stage.pos[nid]: stage.out_types[nid] for nid in out_ids}

    # The collectives run over the ranks the mesh names: two meshes of one
    # shape over other ranks pin separate drivers.
    mesh_ranks = tuple(int(r) for r in mesh.mesh.flatten().tolist())
    driver = pinned_exec(
        stage, ctx, "sharded",
        (tuple(esc_pos), batch, n_local, whole, mesh_ranks, axes),
        lambda: _build_sharded_driver(stage, in_ckeys, in_split_types, esc_pos,
                                      out_types_by_pos, n_local, batch, whole))
    group, order = data_group(mesh, _data_dims(mesh, axes))
    results = driver(vals, group, order)
    ctx.stats["sharded_stages"] += 1

    from torch.distributed.tensor import DTensor
    by_pos = dict(zip(esc_pos, results))
    for node in stage.nodes:
        p = stage.pos[node.id]
        if p in by_pos:
            res = by_pos[p]
            t = out_types_by_pos[p]
            ax = split_axis_of(t)
            if ax is not None:
                placements = placements_for(mesh, axes, ax)
                res = pytree.tree_map(
                    lambda l: DTensor.from_local(l, mesh, placements,
                                                 run_check=False), res)
            if (ho is not None and p in ho.stream_out and n_shards > 1
                    and n_local > 0 and ax is not None and is_dtensor(res)):
                # A mesh-resident stream: a downstream sharded stage passes
                # this rank's shard through with zero interior bytes and no
                # gather; any other consumer gathers it (counted).
                node.result = ChunkStream.from_sharded(
                    res, shard_ranges, t, node.out_aval, (mesh, placements))
                ctx.stats["streamed_outputs"] += 1
            else:
                node.result = res
        node.done = True
