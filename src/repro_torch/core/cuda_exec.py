"""Lower a planned Mozart stage onto the split-pipeline CUDA kernel.

The counterpart of ``src/repro/core/pallas_exec.py``.  Eligibility (checked,
with a counted fallback to the fused executor):
  * every node is annotated ``elementwise=True``, or is a whole-array
    reduction whose output type is ``ReduceSplit`` (sum/max/min/prod);
  * every splittable stage input is a 1-D ``ArraySplit`` along axis 0;
  * broadcast inputs are scalars ();
  * reductions are only consumed outside the stage (they produce partials);
  * the lowering below succeeds: every value is float32 or bool and every
    traced operation has an opcode.

The Pallas kernel called each library function on a VMEM tile.  A CUDA
kernel cannot call Python, so each elementwise node's raw library function
(``node.fn.fn``, unmodified) is traced once with ``torch.fx`` and the
stage's chain becomes a straight-line ``Program``: opcode, destination
slot, source operands.  A source is a split input, a broadcast scalar
(passed at run time, never baked in), an immediate constant of the function
body, or an earlier result: the previous instruction's result, kept in
registers, when nothing else reads it, else a slot allocated by liveness
(``program.assemble``).  A reduction node
reduces its *pre-reduction* operand with its ``ReduceSplit`` op, which comes
from the split type, not from the function body.
"""

from __future__ import annotations

import numbers
import operator
import weakref
from typing import Any

import torch
import torch.fx

from repro_torch.core import split_types as st
from repro_torch.core.graph import NodeRef
from repro_torch.core.planner import Stage, _value_key
from repro_torch.core.stage_exec import (
    SAMPLE_CHUNKS,
    ChunkStream,
    StageExecutor,
    batch_ranges,
    candidate_batches,
    donatable_input_keys,
    effective_elements,
    get_executor,
    mark_stream_consumed,
    note_trace,
    pinned_exec,
    regrid_stream,
    register_executor,
    stage_num_elements,
    undonatable_stream_keys,
)
from repro_torch.kernels import split_pipeline as sp
from repro_torch.kernels.program import ARITY, BOOL_RESULT, OP, Program, assemble
from repro_torch.kernels.split_pipeline import fits_kernel

#: traced call targets -> opcode.  fx records the callables themselves:
#: ``torch.special.erf`` traces as ``torch._C._special.special_erf`` and
#: ``2.0 * x`` as ``operator.mul``.
_FUNCTION_OPS: dict[Any, str] = {
    torch.exp: "EXP", torch.log: "LOG", torch.log1p: "LOG1P",
    torch.sqrt: "SQRT", torch.erf: "ERF", torch.special.erf: "ERF",
    torch._C._special.special_erf: "ERF", torch.negative: "NEG",
    torch.neg: "NEG", torch.abs: "ABS", torch.sin: "SIN", torch.cos: "COS",
    torch.tanh: "TANH", torch.sign: "SIGN", torch.arcsin: "ASIN",
    torch.asin: "ASIN", torch.arccos: "ACOS", torch.acos: "ACOS",
    torch.expm1: "EXPM1", torch.square: "SQUARE", torch.reciprocal: "RECIP",
    torch.floor: "FLOOR", torch.isnan: "ISNAN", torch.logical_not: "NOT",
    torch.add: "ADD", torch.subtract: "SUB", torch.sub: "SUB",
    torch.multiply: "MUL", torch.mul: "MUL", torch.divide: "DIV",
    torch.div: "DIV", torch.true_divide: "DIV", torch.pow: "POW",
    torch.maximum: "MAX", torch.minimum: "MIN", torch.greater: "GT",
    torch.gt: "GT", torch.less: "LT", torch.lt: "LT",
    torch.greater_equal: "GE", torch.ge: "GE", torch.less_equal: "LE",
    torch.le: "LE", torch.eq: "EQ", torch.ne: "NE", torch.not_equal: "NE",
    torch.logical_and: "AND", torch.logical_or: "OR", torch.atan2: "ATAN2",
    torch.arctan2: "ATAN2", torch.remainder: "MOD", torch.where: "WHERE",
    operator.add: "ADD", operator.sub: "SUB", operator.mul: "MUL",
    operator.truediv: "DIV", operator.pow: "POW", operator.neg: "NEG",
    operator.abs: "ABS", operator.gt: "GT", operator.lt: "LT",
    operator.ge: "GE", operator.le: "LE", operator.eq: "EQ", operator.ne: "NE",
    operator.mod: "MOD",
}

#: traced tensor-method names -> opcode (``x.exp()``, ``x.add(y)``, ...).
_METHOD_OPS: dict[str, str] = {
    "exp": "EXP", "log": "LOG", "log1p": "LOG1P", "sqrt": "SQRT", "erf": "ERF",
    "neg": "NEG", "abs": "ABS", "sin": "SIN", "cos": "COS", "tanh": "TANH",
    "sign": "SIGN", "asin": "ASIN", "acos": "ACOS", "expm1": "EXPM1",
    "square": "SQUARE", "reciprocal": "RECIP", "floor": "FLOOR",
    "isnan": "ISNAN", "logical_not": "NOT", "bool": "BOOL", "add": "ADD",
    "sub": "SUB", "mul": "MUL", "div": "DIV", "pow": "POW",
    "maximum": "MAX", "minimum": "MIN", "gt": "GT", "lt": "LT", "ge": "GE",
    "le": "LE", "eq": "EQ", "ne": "NE", "logical_and": "AND",
    "logical_or": "OR", "atan2": "ATAN2", "remainder": "MOD",
}

_KERNEL_DTYPES = (torch.float32, torch.bool)


class LoweringError(Exception):
    """The stage cannot become a kernel program (the reason says why)."""


# Traced graph per raw library function, as ``AnnotatedFn._aval_cache``
# caches avals: a failed trace is cached as its LoweringError.
_traced: "weakref.WeakKeyDictionary[Any, Any]" = weakref.WeakKeyDictionary()


def traced_graph(fn) -> torch.fx.Graph:
    hit = _traced.get(fn)
    if hit is None:
        note_trace()
        try:
            hit = torch.fx.symbolic_trace(fn).graph
        except Exception as e:  # noqa: BLE001 — any untraceable body is ineligible
            hit = LoweringError(f"{getattr(fn, '__name__', fn)} does not "
                                f"trace: {type(e).__name__}: {e}")
        _traced[fn] = hit
    if isinstance(hit, LoweringError):
        raise hit
    return hit


def _opcode_of(fx_node: torch.fx.Node) -> str:
    if fx_node.op == "call_function":
        name = _FUNCTION_OPS.get(fx_node.target)
    elif fx_node.op == "call_method":
        name = _METHOD_OPS.get(fx_node.target)
    else:
        name = None
    if name is None:
        raise LoweringError(f"no opcode for {fx_node.op} {fx_node.target!r}")
    if fx_node.kwargs:
        raise LoweringError(f"{fx_node.target!r} called with keyword "
                            f"arguments {dict(fx_node.kwargs)}")
    if len(fx_node.args) != ARITY[name]:
        raise LoweringError(f"{fx_node.target!r} with {len(fx_node.args)} "
                            f"arguments (opcode {name} takes {ARITY[name]})")
    return name


class _Builder:
    """SSA instructions over virtual registers; sources are ``("in", i)``,
    ``("sc", i)`` (broadcast i, or immediate ``n_bcast + j``) or
    ``("v", reg)``.  Tracks for every source whether it is a bool and
    whether it varies along the split axis."""

    def __init__(self, n_bcast: int):
        self.n_bcast = n_bcast
        self.instrs: list[tuple[str, int, tuple]] = []
        self.imms: list[float] = []
        self.is_bool: dict[tuple, bool] = {}
        self.is_vec: dict[tuple, bool] = {}

    def imm(self, value: Any) -> tuple:
        if not isinstance(value, numbers.Real):
            raise LoweringError(f"constant {value!r} is not a number")
        src = ("sc", self.n_bcast + len(self.imms))
        self.imms.append(float(value))
        self.is_bool[src] = isinstance(value, bool)
        self.is_vec[src] = False
        return src

    def emit(self, name: str, srcs: tuple) -> tuple:
        if name == "ADD" and all(self.is_bool[s] for s in srcs):
            name = "OR"                 # torch: bool + bool is logical or
        if name == "MOD" and any(self.is_bool[s] for s in srcs):
            # jnp.mod promotes bool to int32; in the kernel's float encoding
            # x mod False is NaN, which would be stored as True.
            raise LoweringError("MOD of a bool operand")
        dst = ("v", len(self.instrs))
        self.instrs.append((name, dst[1], srcs))
        self.is_vec[dst] = any(self.is_vec[s] for s in srcs)
        keeps_bool = name in ("COPY", "ABS", "FLOOR", "SQUARE", "MUL", "MAX", "MIN",
                              "POW")
        self.is_bool[dst] = name in BOOL_RESULT or (
            name == "WHERE" and self.is_bool[srcs[1]] and self.is_bool[srcs[2]]
        ) or (keeps_bool and all(self.is_bool[s] for s in srcs))
        return dst


def _lower_node(b: _Builder, node, env: dict[tuple, tuple], stage: Stage) -> tuple:
    """Append one elementwise node's traced body; returns its result source."""
    graph = traced_graph(node.fn.fn)
    vals: dict[torch.fx.Node, tuple] = {}
    for fx_node in graph.nodes:
        if fx_node.op == "placeholder":
            name = fx_node.target
            if name not in node.bound:
                raise LoweringError(f"{node.fn.name}: parameter {name!r}")
            v = node.bound[name]
            vals[fx_node] = (b.imm(v) if name in node.fn.sa.static
                             else env[stage.ckey(_value_key(v))])
        elif fx_node.op == "output":
            res = fx_node.args[0]
            if not isinstance(res, torch.fx.Node):
                raise LoweringError(f"{node.fn.name} returns {res!r}")
            return vals[res]
        else:
            name = _opcode_of(fx_node)
            srcs = tuple(vals[a] if isinstance(a, torch.fx.Node) else b.imm(a)
                         for a in fx_node.args)
            vals[fx_node] = b.emit(name, srcs)
    raise LoweringError(f"{node.fn.name}: traced graph has no output")


def _live_code(b: _Builder, out_srcs: list[tuple]) -> tuple[list, list]:
    """Dead-code-eliminate; returns the kept instructions and the outputs
    over SSA sources (``("v", j)`` is kept instruction j), for
    ``program.assemble``."""
    live = {s for s in out_srcs if s[0] == "v"}
    keep = []
    for name, reg, srcs in reversed(b.instrs):
        if ("v", reg) in live:
            keep.append((name, reg, srcs))
            live.update(s for s in srcs if s[0] == "v")
    keep.reverse()
    pos = {reg: j for j, (_name, reg, _srcs) in enumerate(keep)}

    def src(s: tuple) -> tuple:
        return ("v", pos[s[1]]) if s[0] == "v" else s

    code = [(OP[name], [src(s) for s in srcs]) for name, _reg, srcs in keep]
    return code, [src(s) for s in out_srcs]


def lower_stage(stage: Stage, concrete: dict[tuple, Any], ctx) -> tuple[Program, list]:
    """The stage as a kernel ``Program`` plus its ``out_kinds``; raises
    ``LoweringError``.  The result (or the error) is pinned into the plan
    entry by stage position and the positions of the outputs that escape
    this call (``pinned_exec``), so a warm call of a cached plan runs no
    ``torch.fx`` trace and no lowering; an uncacheable plan keeps it on the
    Stage."""

    def build():
        note_trace()
        try:
            return _lower(stage, concrete)
        except LoweringError as e:
            return e

    result = pinned_exec(stage, ctx, "cuda", (tuple(stage.escape_positions()),), build)
    if isinstance(result, LoweringError):
        raise result
    return result


def _lower(stage: Stage, concrete: dict[tuple, Any]) -> tuple[Program, list]:
    split_keys = [k for k, si in stage.inputs.items() if si.split_type.splittable]
    bcast_keys = [k for k, si in stage.inputs.items() if not si.split_type.splittable]
    b = _Builder(len(bcast_keys))
    env: dict[tuple, tuple] = {}
    for i, k in enumerate(split_keys):
        dtype = concrete[k].dtype
        if dtype not in _KERNEL_DTYPES:
            raise LoweringError(f"split input {i} has dtype {dtype}")
        env[stage.ckey(k)] = src = ("in", i)
        b.is_bool[src], b.is_vec[src] = dtype == torch.bool, True
    for i, k in enumerate(bcast_keys):
        v = concrete[k]
        env[stage.ckey(k)] = src = ("sc", i)
        b.is_bool[src] = (isinstance(v, bool) or
                          getattr(v, "dtype", None) == torch.bool)
        b.is_vec[src] = False

    reduce_src: dict[int, tuple] = {}
    for node in stage.nodes:
        aval = node.out_aval
        if isinstance(stage.out_types[node.id], st.ReduceSplit):
            if aval.dtype != torch.float32:
                raise LoweringError(f"{node.fn.name} reduces to {aval.dtype}")
            # The kernel applies the masked reduction itself: it needs the
            # PRE-reduction operand (the first non-static argument).
            first = next(v for name, v in node.bound.items()
                         if name not in node.fn.sa.static)
            reduce_src[node.id] = env[stage.ckey(_value_key(first))]
            continue
        if aval.dtype not in _KERNEL_DTYPES:
            raise LoweringError(f"{node.fn.name} yields {aval.dtype}")
        env[stage.out_key(node)] = _lower_node(b, node, env, stage)

    out_kinds, out_srcs, out_bool = [], [], []
    for nid in sorted(stage.escaping):
        node = next(nd for nd in stage.nodes if nd.id == nid)
        if nid in reduce_src:
            t = stage.out_types[nid]
            out_kinds.append(("reduce", t.op_name))
            src = reduce_src[nid]
        else:
            out_kinds.append(("concat", ""))
            src = env[stage.out_key(node)]
            if len(node.out_aval.shape) != 1:
                raise LoweringError(f"{node.fn.name} output of shape "
                                    f"{tuple(node.out_aval.shape)}")
        if not b.is_vec[src]:
            raise LoweringError(f"{node.fn.name}: output does not vary along "
                                "the split axis")
        out_srcs.append(src)
        out_bool.append(node.out_aval.dtype == torch.bool
                        and out_kinds[-1][0] == "concat")

    code, outs = _live_code(b, out_srcs)
    program = assemble(code, list(zip(outs, out_bool)), n_split=len(split_keys),
                       n_bcast=len(bcast_keys), imms=b.imms)
    why = fits_kernel(program)
    if why is not None:
        raise LoweringError(why)
    return program, out_kinds


def _eligible(stage: Stage, concrete: dict[tuple, Any]) -> bool:
    for node in stage.nodes:
        t = stage.out_types[node.id]
        if node.fn.sa.elementwise:
            continue
        if isinstance(t, st.ReduceSplit):
            continue
        return False
    for key, si in stage.inputs.items():
        v = concrete[key]
        if si.split_type.splittable:
            if not isinstance(si.split_type, st.ArraySplit):
                return False
            if si.split_type.axis != 0 or len(si.split_type.shape) != 1:
                return False
        else:
            if tuple(getattr(v, "shape", ())) not in ((), (1,)):
                return False
    # reductions must not feed later nodes inside this stage
    for node in stage.nodes:
        if isinstance(stage.out_types[node.id], st.ReduceSplit):
            for other in stage.nodes:
                for v in other.bound.values():
                    if isinstance(v, NodeRef) and v.node_id == node.id:
                        return False
    return True


def _adjacent_views(chunks: list, n: int) -> torch.Tensor | None:
    """The chunks as ONE length-``n`` view when they are 1-D contiguous
    views of one storage laid end to end (the first chunk's base pointer
    spans them all), else None."""
    c0 = chunks[0]
    if not all(isinstance(c, torch.Tensor) and c.dim() == 1 and c.is_contiguous()
               and c.dtype == c0.dtype and c.device == c0.device for c in chunks):
        return None
    storage, ptr, item = c0.untyped_storage().data_ptr(), c0.data_ptr(), c0.element_size()
    for c in chunks:
        if c.untyped_storage().data_ptr() != storage or c.data_ptr() != ptr:
            return None
        ptr += c.numel() * item
    if sum(c.numel() for c in chunks) != n:
        return None
    return c0.as_strided((n,), (1,), c0.storage_offset())


def _launch_buffer(stage: Stage, concrete: dict[tuple, Any], key: tuple, n: int,
                   ctx) -> tuple[torch.Tensor, bool]:
    """Split input ``key`` as a contiguous length-``n`` launch buffer; returns
    ``(buffer, fresh)``, ``fresh`` when the buffer was assembled here.

    A ``ChunkStream`` is never merged (the counterpart of the reference's
    ``pallas_exec._to_launch_layout``); its path is counted in ``ctx.stats``:
    ``cuda_ingest_views`` (adjacent views of one storage: the first chunk's
    base pointer, zero copies), ``cuda_ingest_carry`` (a scan carry with no
    tail, as it is), ``cuda_ingest_carry_tail`` (a carry with a tail,
    concatenated once) and ``cuda_ingest_concat`` (any other chunk list,
    concatenated once; a grid other than this stage's batch grid goes
    through ``SplitType.rechunk`` first, counted in ``handoff_rechunks``)."""
    v = concrete[key]
    if not isinstance(v, ChunkStream):
        buf = v.narrow(0, 0, n)
        return (buf, False) if buf.is_contiguous() else (buf.contiguous(), True)
    if (v.stacked is not None and v._chunks is None
            and isinstance(v.stacked, torch.Tensor) and v.stacked.dim() == 2
            and v.stacked.is_contiguous()):
        main = v.stacked.reshape(-1)
        if v.tail is None:
            ctx.stats["cuda_ingest_carry"] += 1
            return main, False
        ctx.stats["cuda_ingest_carry_tail"] += 1
        return torch.cat([main, v.tail]), True
    chunks = v.chunks
    view = _adjacent_views(chunks, n)
    if view is not None:
        ctx.stats["cuda_ingest_views"] += 1
        return view, False
    grid = batch_ranges(n, get_executor("cuda").chunk_batch(stage, concrete, ctx, n))
    if v.ranges != grid:
        chunks = regrid_stream(stage, ctx, key, v, grid).chunks
    ctx.stats["cuda_ingest_concat"] += 1
    return torch.cat(chunks), True


def _prepare(stage: Stage, concrete: dict[tuple, Any], ctx):
    """``((program, split_inputs, bcast_inputs, out_kinds), fresh)`` for one
    stage, or None when the stage does not go to the kernel; ``fresh[i]``
    says split input i was assembled here."""
    if not _eligible(stage, concrete):
        return None
    split_keys = [k for k, si in stage.inputs.items() if si.split_type.splittable]
    bcast_keys = [k for k, si in stage.inputs.items() if not si.split_type.splittable]
    if not split_keys:
        return None
    n = effective_elements(ctx, stage_num_elements(stage, concrete, ctx.pedantic))
    if n == 0:
        return None                    # empty split: no grid to launch
    try:
        program, out_kinds = lower_stage(stage, concrete, ctx)
    except LoweringError as e:
        if ctx.log:
            print(f"[mozart] stage {stage.id} stays off the kernel: {e}")
        return None
    bufs = [_launch_buffer(stage, concrete, k, n, ctx) for k in split_keys]
    bcasts = [concrete[k] for k in bcast_keys]
    return (program, [b for b, _f in bufs], bcasts, out_kinds), [f for _b, f in bufs]


def prepare_launch(stage: Stage, concrete: dict[tuple, Any], ctx):
    """``(program, split_inputs, bcast_inputs, out_kinds)`` for one stage,
    or None when the stage does not go to the kernel."""
    prepared = _prepare(stage, concrete, ctx)
    return None if prepared is None else prepared[0]


def tiles_up_to(batch: int) -> tuple[int, ...]:
    """The kernel's tiles a chunk of ``batch`` elements may launch with:
    every tile not above it (the smallest tile when every tile is)."""
    return tuple(t for t in sp.TILES if t <= batch) or (min(sp.TILES),)


def _device_index(dev: torch.device) -> int | None:
    """The card's index for its occupancy calculator; None (the estimate)
    for a CPU tensor."""
    return dev.index if dev.type == "cuda" else None


def try_execute_stage_cuda(stage: Stage, concrete: dict[tuple, Any], ctx,
                           executor: "CudaExecutor | None" = None) -> bool:
    prepared = _prepare(stage, concrete, ctx)
    if prepared is None:
        return False
    (program, split_inputs, bcasts, out_kinds), fresh = prepared
    executor = executor or get_executor("cuda")
    geom = executor.launch_geometry(stage, ctx, program, out_kinds, split_inputs[0].device)
    # Donation decisions as the reference's pallas driver takes them: every
    # donation point counts; a dead stream passed through as it is (views,
    # a carry) gives up its buffers after the launch.
    split_keys = [k for k, si in stage.inputs.items() if si.split_type.splittable]
    donate = set(donatable_input_keys(stage, ctx))
    positions = [i for i, k in enumerate(split_keys) if stage.ckey(k) in donate]
    unsafe = undonatable_stream_keys(stage, concrete, ctx, tuple(donate)) if positions else set()
    consumed = {stage.ckey(split_keys[i]) for i in positions
                if not fresh[i] and stage.ckey(split_keys[i]) not in unsafe
                and isinstance(concrete[split_keys[i]], ChunkStream)}
    ctx.stats["donated_chunks"] += len(positions)
    results = sp._launch(program, split_inputs, bcasts, out_kinds, geom=geom)
    mark_stream_consumed(stage, concrete, ctx, consumed)
    for nid, res in zip(sorted(stage.escaping), results):
        node = next(nd for nd in stage.nodes if nd.id == nid)
        node.result = res
    for node in stage.nodes:
        node.done = True
    ctx.stats["cuda_stages"] += 1
    return True


#: least elements one timed sample of a kernel stage covers: a launch
#: covers the whole stage, so its host cost is fixed, and a sample must be
#: large enough for the device time to show through it.
SAMPLE_MIN_ELEMS = 1 << 24


@register_executor("cuda")
class CudaExecutor(StageExecutor):
    """Lower eligible elementwise stages onto the split-pipeline CUDA kernel;
    a stage that ``_eligible`` or the lowering rejects runs on the fused
    driver and is counted in ``ctx.stats["cuda_fallback_stages"]``.  A build
    or launch failure raises.  Stream inputs are ingested without a merge
    (``_launch_buffer``); outputs are whole tensors, as the reference's
    ``pallas`` stage merges its own.

    Tuning (the counterpart of ``pallas``'s block-shape tuning): the
    candidates are the §5.2 bracket rounded to the tiles the kernel
    launches, deduplicated; the winner is pinned as the stage's batch, and
    every launch of a cached plan records the tile it used in
    ``PlanEntry.block_shape[stage.id] = (1, tile)``."""

    tunable = True
    stream_capable = True

    def execute(self, stage: Stage, concrete: dict[tuple, Any], ctx) -> None:
        if not try_execute_stage_cuda(stage, concrete, ctx, self):
            ctx.stats["cuda_fallback_stages"] += 1
            get_executor("fused").execute(stage, concrete, ctx)

    def chunk_batch(self, stage: Stage, concrete: dict[tuple, Any], ctx, n: int) -> int:
        """The chunk grid a stream is regridded onto before it is
        concatenated into a launch buffer: the context's ``batch_elements``
        or the §5.2 estimate, never the pinned tile."""
        return max(1, min(ctx.batch_elements or self.estimate_batch(stage, concrete, ctx, n), n))

    def launch_geometry(self, stage: Stage, ctx, program: Program, out_kinds: list,
                        device: torch.device) -> "sp.Geometry":
        """The tile and ring depth of this launch: the kernel's rule over the
        tiles a chunk of the tuner's candidate (or of the size it pinned) may
        hold, else over every tile.  A launch of a cached plan records its
        tile in ``entry.block_shape``."""
        entry = getattr(ctx, "_plan_entry", None)
        override = getattr(ctx, "_batch_override", None)
        cap = override
        if cap is None and entry is not None:
            cap = entry.tuned_batch.get(stage.id)
        tiles = sp.TILES if cap is None else tiles_up_to(cap)
        geom = sp.program_geometry(program, out_kinds, _device_index(device), tiles)
        if entry is not None and override is None:
            entry.pin_block_shape(stage.id, (1, geom.tile))
        return geom

    def tuning_candidates(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                          est: int, n: int) -> list[int]:
        """The §5.2 bracket rounded to the tile each candidate launches with
        (the rule over the tiles a chunk of that size may hold) and
        deduplicated: two candidates on one tile would time the same launch
        twice.  A stage that stays off the kernel tunes the fused driver's
        bracket."""
        split = [concrete[k] for k, si in stage.inputs.items() if si.split_type.splittable]
        if n <= 0 or not split or not _eligible(stage, concrete):
            return candidate_batches(est, n)
        try:
            program, out_kinds = lower_stage(stage, concrete, ctx)
        except LoweringError:
            return candidate_batches(est, n)
        device = _device_index(ctx.device)         # split inputs may be streams
        return sorted({sp.program_geometry(program, out_kinds, device, tiles_up_to(c)).tile
                       for c in candidate_batches(est, n)})

    def sample_elems(self, stage: Stage, concrete: dict[tuple, Any], ctx,
                     batch: int, n: int) -> int:
        """One launch covers the whole sample, so the sample is at least
        ``SAMPLE_MIN_ELEMS`` elements and ``SAMPLE_CHUNKS`` of the stage's
        §5.2 chunks, however small the tile being timed."""
        chunk = max(batch, self.chunk_batch(stage, concrete, ctx, max(n, 1)))
        return min(n, max(SAMPLE_CHUNKS * chunk, SAMPLE_MIN_ELEMS)) if n > 0 else 0
