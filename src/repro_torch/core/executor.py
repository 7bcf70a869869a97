"""Built-in Mozart executor strategies (paper §5.2) as ``StageExecutor``s.

Per stage: (1) discover runtime parameters — the batch size is chosen so one
batch of *every* live pipeline value fits in fast memory (L2 on the H100 and
on the paper's CPUs); (2) split inputs and drive each batch through the
whole function chain; (3) merge partial results associatively.

* ``"eager"``      — no splitting: each function runs whole.  This is the
                     un-annotated library baseline.
* ``"pipelined"``  — paper-faithful: a Python driver loop calls each
                     black-box function on one chunk at a time.
* ``"fused"``      — the whole per-chunk chain runs in ONE driver call per
                     chunk (PyTorch runs it eagerly; there is no jit).
* ``"scan"``       — equal-size chunks as rows of a ``(n_chunks, batch)``
                     carry (a view of a contiguous input), driven by ONE
                     driver call that runs the chain row by row into a
                     preallocated output carry; the ragged tail runs
                     separately.  The reference compiles this loop with
                     ``lax.map``; torch has no counterpart, so the port holds
                     the reference's chunk, call and stage counts and
                     boundary bytes, not its mechanism.

Every chunking executor ingests handed-off ``ChunkStream`` inputs without a
merge (``core/handoff.py``).  The fused and scan drivers are pinned into the
plan-cache entry (``stage_exec.pinned_exec``), so a warm call builds none;
each build counts as a trace (``note_trace``).  The chunk loop halves its
batch on memory exhaustion, at most ``resilience.MAX_OOM_HALVINGS`` times,
and each drive crosses the ``chunk`` fault boundary.  The ``"cuda"``
executor (the split-pipeline kernel) lives in ``core/cuda_exec.py``,
``"sharded"`` (a ``torch.distributed`` mesh) in ``core/sharded.py``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import resilience
from repro_torch.core.planner import Stage
from repro_torch.core.stage_exec import (
    ChunkStream,
    PedanticError,
    StageExecutor,
    batch_ranges,
    chain_plan,
    chunk_env_for,
    donatable_input_keys,
    effective_elements,
    finish_stage,
    get_executor,
    has_dynamic,
    mark_stream_consumed,
    note_trace,
    pinned_exec,
    regrid_stream,
    register_executor,
    run_chain,
    run_plan,
    split_axis_of,
    stage_num_elements,
    undonatable_stream_keys,
)

__all__ = [
    "PedanticError", "EagerExecutor", "PipelinedExecutor", "FusedExecutor",
    "ScanExecutor",
]


@register_executor("eager")
class EagerExecutor(StageExecutor):
    """The un-annotated library baseline: every function runs whole."""

    stream_capable = False       # whole-value strategy: streams materialize

    def execute(self, stage: Stage, concrete: dict[tuple, Any], ctx) -> None:
        env = {stage.ckey(key): v for key, v in concrete.items()}
        run_chain(stage, env)
        for node in stage.nodes:
            node.result = env[stage.out_key(node)]
            node.done = True
            ctx.stats["calls"] += 1


def _build_fused_driver(stage: Stage, esc: tuple[int, ...]) -> Callable:
    note_trace()
    plan = chain_plan(stage)

    def fused_driver(env):
        run_plan(plan, env)
        return {p: env[("n", p)] for p in esc}

    return fused_driver


class ChunkedExecutor(StageExecutor):
    """Shared Python-driver chunk loop; ``mode`` picks the per-chunk style.

    Stream inputs (producer chunk lists) are iterated without re-slicing;
    a dead stream's buffers are released after the stage consumed them."""

    tunable = True
    stream_capable = True
    mode = "pipelined"

    #: a producer grid whose chunks are up to this factor over the consumer's
    #: own batch estimate is adopted as-is: the §5.2 estimate leaves
    #: fast-memory headroom, and adopting the grid costs zero copies while
    #: re-gridding costs one per chunk.  Beyond it the stream is re-gridded.
    GRID_SLACK = 2.0

    def _ingest_streams(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                        n: int, batch: int):
        """Align every stream input onto ONE chunk grid: the first stream's
        grid when its chunks fit this stage's budget (within
        ``GRID_SLACK``), else this stage's own; any stream on another grid
        converts via ``SplitType.rechunk``."""
        streams = [(k, v) for k, v in concrete.items()
                   if isinstance(v, ChunkStream)]
        if not streams:
            return concrete, batch_ranges(n, batch)
        base = streams[0][1]
        grid = base.ranges
        ub = base.uniform_batch()
        if ub is not None and ub > batch * self.GRID_SLACK and n > 0:
            grid = batch_ranges(n, batch)
        if not grid:
            grid = batch_ranges(n, batch)  # zero-chunk stream: degenerate grid
        out = dict(concrete)
        for k, v in streams:
            if v.ranges != grid:
                out[k] = regrid_stream(stage, ctx, k, v, grid)
        return out, grid

    def execute(self, stage: Stage, concrete: dict[tuple, Any], ctx) -> None:
        mode = self.mode
        if has_dynamic(stage):
            mode = "pipelined"           # dynamic-shape fns run call by call
        n = effective_elements(ctx, stage_num_elements(stage, concrete, ctx.pedantic))
        batch = self.choose_batch(stage, concrete, ctx, n)
        # Chunk-granular OOM policy: on resource exhaustion halve the batch
        # and re-drive, at most MAX_OOM_HALVINGS times and only while no
        # stream was released (a released buffer is never re-read).  The
        # surviving size is re-pinned so warm calls start from it.
        halvings = 0
        while True:
            released = ctx.stats.get("streams_released", 0)
            try:
                self._drive(stage, concrete, ctx, mode, n, batch)
                break
            except resilience.PROBE_ERRORS as e:
                if (not resilience.is_resource_exhausted(e) or batch <= 1
                        or halvings >= resilience.MAX_OOM_HALVINGS
                        or released != ctx.stats.get("streams_released", 0)):
                    raise
                halvings += 1
                batch = max(1, batch // 2)
                ctx.stats["chunk_oom_halvings"] += 1
                resilience.record_event(
                    "MZ403", f"stage {stage.id}: {type(e).__name__}, "
                             f"batch halved to {batch}")
        if halvings:
            entry = getattr(ctx, "_plan_entry", None)
            if entry is not None:
                entry.pin(stage.id, batch)   # survive into warm calls

    def _drive(self, stage: Stage, concrete: dict[tuple, Any], ctx,
               mode: str, n: int, batch: int) -> None:
        concrete, ranges = self._ingest_streams(stage, concrete, ctx, n, batch)
        ctx.stats["chunks"] += len(ranges)

        esc = tuple(stage.escape_positions())
        fused_fn = None
        donate: tuple = ()
        if mode == "fused":
            fused_fn = pinned_exec(stage, ctx, "fused", (esc,),
                                   lambda: _build_fused_driver(stage, esc))
            # Donation decisions as the reference's fused driver takes them.
            donate = donatable_input_keys(stage, ctx)
        unsafe = undonatable_stream_keys(stage, concrete, ctx, donate) if donate else set()
        partials: dict[int, list[Any]] = {p: [] for p in esc}
        for i, (s, e) in enumerate(ranges):
            resilience.maybe_fail("chunk", f"stage {stage.id} chunk [{s},{e})")
            env = chunk_env_for(stage, concrete, s, e, ctx.pedantic, chunk_index=i)
            if fused_fn is None:
                run_chain(stage, env)
                ctx.stats["calls"] += len(stage.nodes)
                outs = {p: env[("n", p)] for p in esc}
            else:
                outs = fused_fn(env)
                ctx.stats["calls"] += 1
                ctx.stats["donated_chunks"] += len(donate)
            for p, v in outs.items():
                partials[p].append(v)
            if ctx.log:
                print(f"[mozart] stage {stage.id} chunk [{s},{e}) done")
        mark_stream_consumed(stage, concrete, ctx, set(donate) - unsafe)
        finish_stage(stage, partials, ranges, ctx)


@register_executor("pipelined")
class PipelinedExecutor(ChunkedExecutor):
    """Paper-faithful driver: separate black-box calls per chunk."""

    mode = "pipelined"


@register_executor("fused")
class FusedExecutor(ChunkedExecutor):
    """Whole per-chunk chain in one driver call."""

    mode = "fused"


def _build_scan_driver(stage: Stage, esc: tuple[int, ...],
                       split_axes: dict[tuple, int],
                       out_axes: dict[int, int | None]) -> Callable:
    """The scan driver: ONE call that runs the stage's chain over every row
    of the input carries and writes each output row into a preallocated
    output carry (allocated from the first row's shapes and dtypes)."""
    note_trace()
    plan = chain_plan(stage)

    def row(rows, i: int, ax: int):
        if isinstance(rows, list):        # a chunk list: chunk i as it is
            return rows[i]
        if isinstance(rows, torch.Tensor):
            return rows[i].movedim(0, ax) if ax else rows[i]
        return pytree.tree_map(lambda l: l[i].movedim(0, ax) if ax else l[i], rows)

    def put(carry, o, i: int) -> None:
        if isinstance(o, torch.Tensor):
            carry[i].copy_(o)
        else:
            pytree.tree_map(lambda c, l: c[i].copy_(l), carry, o)

    def driver(split_rows: dict, bcast_env: dict, n_chunks: int) -> dict:
        carry: dict[int, Any] = {}
        for i in range(n_chunks):
            env = dict(bcast_env)
            for key, rows in split_rows.items():
                env[key] = row(rows, i, split_axes[key])
            run_plan(plan, env)
            for p in esc:
                ax = out_axes[p]
                o = env[("n", p)]
                if ax:
                    o = pytree.tree_map(lambda l, ax=ax: l.movedim(ax, 0), o)
                if i == 0:
                    carry[p] = pytree.tree_map(
                        lambda l: l.new_empty((n_chunks,) + tuple(l.shape)), o)
                put(carry[p], o, i)
        return carry

    return driver


@register_executor("scan")
class ScanExecutor(StageExecutor):
    """Equal-size chunks as rows of a ``(n_chunks, batch)`` carry, driven by
    one driver call; the ragged tail chunk runs separately.

    Chunk handoff: the producer's own carry passes through untouched when
    the grids agree (scan -> scan), a chunk list is read chunk by chunk
    (no gather: a chunk IS a row), and disagreeing grids convert through
    ``SplitType.rechunk`` first; ``materialize()`` is never called on
    ingest.  Streamed outputs keep the carry layout
    (``ChunkStream.from_stacked``).  Delegates as the reference does:
    dynamic stages to ``pipelined``; empty stages and stages with a split
    axis it cannot stack along to ``fused``."""

    tunable = True
    stream_capable = True

    #: same grid-adoption slack as the chunk-loop drivers.
    GRID_SLACK = 2.0

    def _ingest_streams(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                        n: int, batch: int) -> tuple[dict[tuple, Any], int]:
        """Align stream inputs onto ONE regular grid; returns the batch.  A
        stream whose grid already is ``batch_ranges(n, ub)`` (within
        ``GRID_SLACK`` of the estimate) fixes the batch; anything else
        rechunks, at most one copy."""
        streams = [(k, v) for k, v in concrete.items()
                   if isinstance(v, ChunkStream)]
        if not streams or n <= 0:
            return concrete, batch
        base = streams[0][1]
        ub = base.uniform_batch()
        if (ub and ub <= batch * self.GRID_SLACK
                and base.ranges == batch_ranges(n, ub)):
            batch = ub                     # adopt the producer's grid as-is
        grid = batch_ranges(n, batch)
        out = dict(concrete)
        for k, v in streams:
            if v.ranges != grid:
                out[k] = regrid_stream(stage, ctx, k, v, grid)
        return out, batch

    def execute(self, stage: Stage, concrete: dict[tuple, Any], ctx) -> None:
        if has_dynamic(stage):
            return get_executor("pipelined").execute(stage, concrete, ctx)
        n = effective_elements(ctx, stage_num_elements(stage, concrete, ctx.pedantic))
        if n == 0:
            # Empty split: no rows; the fused driver runs one zero-size chunk.
            return get_executor("fused").execute(stage, concrete, ctx)
        batch = self.choose_batch(stage, concrete, ctx, n)
        concrete, batch = self._ingest_streams(stage, concrete, ctx, n, batch)
        n_main = (n // batch) * batch
        n_chunks = n_main // batch

        # Outputs and inputs must have a known split axis to be stacked.
        for nid in stage.escaping:
            t = stage.out_types[nid]
            if split_axis_of(t) is None and t.splittable:
                return get_executor("fused").execute(stage, concrete, ctx)
        split_keys = [k for k, si in stage.inputs.items() if si.split_type.splittable]
        if not split_keys or any(
                split_axis_of(stage.inputs[k].split_type) is None for k in split_keys):
            return get_executor("fused").execute(stage, concrete, ctx)

        def rows_of(key):
            ax = split_axis_of(stage.inputs[key].split_type)
            v = concrete[key]
            if isinstance(v, ChunkStream):
                if v.stacked is not None and v._chunks is None \
                        and v.uniform_batch() == batch:
                    return v.stacked         # scan -> scan: the carry itself
                return [v.chunk(i) for i in range(n_chunks)]

            def stack_leaf(leaf):
                lead = leaf.movedim(ax, 0) if ax else leaf
                return lead[:n_main].reshape((n_chunks, batch) + tuple(lead.shape[1:]))
            return pytree.tree_map(stack_leaf, v)

        split_rows = {stage.ckey(k): rows_of(k) for k in split_keys}
        bcast_env = {stage.ckey(k): concrete[k] for k, si in stage.inputs.items()
                     if not si.split_type.splittable}
        esc = tuple(stage.escape_positions())
        split_axes = {stage.ckey(k): split_axis_of(stage.inputs[k].split_type)
                      for k in split_keys}
        out_axes = {stage.pos[nid]: split_axis_of(stage.out_types[nid])
                    for nid in stage.escaping}

        # Donation decisions as the reference's scan driver takes them.
        donate = tuple(k for k in donatable_input_keys(stage, ctx)
                       if k in split_rows) if n_chunks else ()
        unsafe = undonatable_stream_keys(stage, concrete, ctx, donate) \
            if donate else set()
        driver = pinned_exec(
            stage, ctx, "scan", (esc,),
            lambda: _build_scan_driver(stage, esc, split_axes, out_axes))
        carry = {}
        if n_chunks:
            resilience.maybe_fail("chunk", f"stage {stage.id} scan driver")
            carry = driver(split_rows, bcast_env, n_chunks)
        ctx.stats["donated_chunks"] += len(donate)
        ctx.stats["chunks"] += n_chunks + (1 if n_main < n else 0)
        ctx.stats["calls"] += 1

        plan_ho = getattr(ctx, "_handoff", None)
        ho = plan_ho.get(stage.id) if plan_ho else None
        ranges = batch_ranges(n, batch)

        tail_env = None
        if n_main < n:  # ragged tail
            tail_env = chunk_env_for(stage, concrete, n_main, n, ctx.pedantic,
                                     chunk_index=n_chunks)
            run_chain(stage, tail_env)

        partials: dict[int, list[Any]] = {}
        for nid in stage.escaping:
            p = stage.pos[nid]
            t = stage.out_types[nid]
            ax = split_axis_of(t)
            node = next(nd for nd in stage.nodes if nd.id == nid)
            tail_piece = tail_env[("n", p)] if tail_env is not None else None
            if (ho is not None and p in ho.stream_out and ax is not None
                    and n_chunks and len(ranges) > 1):
                # Streamed output: the carry stays as it is.
                node.result = ChunkStream.from_stacked(
                    carry[p], tail_piece, ranges, t, node.out_aval)
                node.done = True
                ctx.stats["streamed_outputs"] += 1
                continue
            pieces: list[Any] = []
            if n_chunks:
                so = carry[p]
                if ax is not None:
                    def unstack(l, ax=ax):
                        flat = l.reshape((n_chunks * batch,) + tuple(l.shape[2:]))
                        return flat.movedim(0, ax) if ax else flat
                    pieces.append(pytree.tree_map(unstack, so))
                else:  # ReduceSplit etc.: one partial per row
                    pieces.extend(pytree.tree_map(lambda l, i=i: l[i], so)
                                  for i in range(n_chunks))
            if tail_piece is not None:
                pieces.append(tail_piece)
            partials[p] = pieces
        # Every dead stream input was read in place: release its buffers.
        mark_stream_consumed(stage, concrete, ctx, set(donate) - unsafe)
        finish_stage(stage, partials, ctx=ctx)
