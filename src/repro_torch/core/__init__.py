"""repro_torch.core — Split Annotations (Mozart) in PyTorch.

Public API:
    mozart.session / configure / evaluate      — runtime scope
    mozart.pipeline / Pipeline                 — AOT lower / compile / call
    mozart.inject_faults                       — deterministic fault plans
    plan_cache / cost_model / pipeline         — plan cache, executor="auto"
    rewrite / resilience                       — static rewrite pass (MZ5xx),
                                                 degradation ladder (MZ4xx)
    mozart.verify / verify / Report            — the annotation linter and
                                                 dataflow analyzer (MZ1xx/2xx)
    splittable / annotate                      — attach SAs to functions
    split types & specs                        — Along, Broadcast(_), Generic,
                                                 Unknown, Reduce, Pytree, Custom
"""

from repro_torch.core import runtime as mozart
from repro_torch.core import cost_model, pipeline, plan_cache, resilience, rewrite
from repro_torch.core.analysis import CODES, Diagnostic, Report, verify
from repro_torch.core.annotation import SA, AnnotatedFn, annotate, splittable
from repro_torch.core.future import Future
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.split_types import (
    BROADCAST,
    Along,
    ArraySplit,
    Broadcast,
    Concat,
    ConcatSplit,
    Custom,
    Generic,
    GenericVar,
    Pytree,
    PytreeSplit,
    Reduce,
    ReduceSplit,
    RuntimeInfo,
    ScalarSplit,
    SplitSpec,
    SplitType,
    TypeEnv,
    UnificationError,
    Unknown,
    UnknownSplit,
    default_split_type,
    _,
)
from repro_torch.core.stage_exec import (
    ChunkStream,
    StageExecutor,
    available_executors,
    bytes_interior,
    bytes_materialized,
    get_executor,
    register_executor,
)

__all__ = [
    "mozart", "plan_cache", "cost_model", "pipeline", "resilience", "rewrite", "SA", "AnnotatedFn", "annotate", "splittable", "Future",
    "Pipeline",
    "BROADCAST", "Along", "ArraySplit", "Broadcast", "Concat", "ConcatSplit",
    "Custom", "Generic", "GenericVar", "Pytree", "PytreeSplit", "Reduce",
    "ReduceSplit", "RuntimeInfo", "ScalarSplit", "SplitSpec", "SplitType",
    "TypeEnv", "UnificationError", "Unknown", "UnknownSplit",
    "default_split_type", "_",
    "ChunkStream", "StageExecutor", "available_executors", "bytes_interior",
    "bytes_materialized", "get_executor", "register_executor",
    "CODES", "Diagnostic", "Report", "verify",
]
