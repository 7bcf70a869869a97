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

The ``"cuda"`` executor (the split-pipeline kernel) lives in
``core/cuda_exec.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.planner import Stage
from repro_torch.core.stage_exec import (
    PedanticError,
    StageExecutor,
    batch_ranges,
    chain_plan,
    chunk_env_for,
    effective_elements,
    finish_stage,
    has_dynamic,
    register_executor,
    run_chain,
    run_plan,
    stage_num_elements,
)

__all__ = [
    "PedanticError", "EagerExecutor", "PipelinedExecutor", "FusedExecutor",
]


@register_executor("eager")
class EagerExecutor(StageExecutor):
    """The un-annotated library baseline: every function runs whole."""

    def execute(self, stage: Stage, concrete: dict[tuple, Any], ctx) -> None:
        env = {stage.ckey(key): v for key, v in concrete.items()}
        run_chain(stage, env)
        for node in stage.nodes:
            node.result = env[stage.out_key(node)]
            node.done = True
            ctx.stats["calls"] += 1


def _build_fused_driver(stage: Stage, esc: tuple[int, ...]) -> Callable:
    plan = chain_plan(stage)

    def fused_driver(env):
        run_plan(plan, env)
        return {p: env[("n", p)] for p in esc}

    return fused_driver


class ChunkedExecutor(StageExecutor):
    """Shared Python-driver chunk loop; ``mode`` picks the per-chunk style."""

    mode = "pipelined"

    def execute(self, stage: Stage, concrete: dict[tuple, Any], ctx) -> None:
        mode = self.mode
        if has_dynamic(stage):
            mode = "pipelined"           # dynamic-shape fns run call by call
        n = effective_elements(ctx, stage_num_elements(stage, concrete, ctx.pedantic))
        batch = self.choose_batch(stage, concrete, ctx, n)
        ranges = batch_ranges(n, batch)
        ctx.stats["chunks"] += len(ranges)

        esc = tuple(stage.escape_positions())
        fused_fn = _build_fused_driver(stage, esc) if mode == "fused" else None
        partials: dict[int, list[Any]] = {p: [] for p in esc}
        for s, e in ranges:
            env = chunk_env_for(stage, concrete, s, e, ctx.pedantic)
            if fused_fn is None:
                run_chain(stage, env)
                ctx.stats["calls"] += len(stage.nodes)
                outs = {p: env[("n", p)] for p in esc}
            else:
                outs = fused_fn(env)
                ctx.stats["calls"] += 1
            for p, v in outs.items():
                partials[p].append(v)
            if ctx.log:
                print(f"[mozart] stage {stage.id} chunk [{s},{e}) done")
        finish_stage(stage, partials)


@register_executor("pipelined")
class PipelinedExecutor(ChunkedExecutor):
    """Paper-faithful driver: separate black-box calls per chunk."""

    mode = "pipelined"


@register_executor("fused")
class FusedExecutor(ChunkedExecutor):
    """Whole per-chunk chain in one driver call."""

    mode = "fused"
