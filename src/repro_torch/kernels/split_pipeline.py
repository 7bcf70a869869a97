"""Split-pipeline kernel wrapper: a Mozart stage as ONE CUDA kernel launch.

The counterpart of ``src/repro/kernels/split_pipeline.py``.  The stage's
chain arrives lowered to a ``Program`` (``core/cuda_exec.py``); the fixed
kernel in ``csrc/split_pipeline.cu`` interprets it tile by tile so that
intermediates never reach device memory, writes the concat outputs, and
writes one partial per CTA for each reduction, which this wrapper combines
after the launch.

Two pure rules, callable on CPU and meta tensors, shape a launch:
``geometry`` picks the tile size and the depth of the input ring from the
program's rows, and ``load_paths`` says which tiles the kernel copies with
TMA bulk copies and which with plain loads.  The grid is
min(tiles, SMs x CTAs per SM), the latter from the CUDA occupancy
calculator for the launch's shared memory.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/build.py``), bound with ``ctypes`` (plain C entry points) and
launched on PyTorch's current stream.  A tensor on the CPU takes the plain
version (``kernels/ref.py``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch import hardware
from repro_torch.kernels import build as kernel_build
from repro_torch.kernels.program import (
    KIND_FWD,
    KIND_INPUT,
    KIND_SCALAR,
    KIND_SLOT,
    NO_STORE,
    OPCODES,
    Program,
    decode,
)
from repro_torch.kernels.ref import split_pipeline_ref

# Mirrors of the kernel's limits (csrc/split_pipeline.cu).
VEC = 8
MAX_IN = 16
MAX_OUT = 16
MAX_SCALARS = 64
MAX_INSTR = 256
MAX_ROWS = 56
MAX_STAGES = 3
SMEM_PER_BLOCK = 232448       # H100: dynamic shared memory one CTA may use
SMEM_PER_SM = 233472          # H100: shared memory of one SM
SMEM_RESERVED = 1024          # per CTA, taken by the system
THREADS_PER_SM = 2048
#: tile sizes and ring depths the ``geometry`` rule weighs.
TILES = (2048, 1024, 512)
STAGES = tuple(range(1, MAX_STAGES + 1))

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "split_pipeline.cu"

_OUT_KIND = {("concat", False): 0, ("concat", True): 1, ("reduce", "add"): 2,
             ("reduce", "mul"): 3, ("reduce", "max"): 4, ("reduce", "min"): 5}
_COMBINE = {"add": torch.sum, "mul": torch.prod, "max": torch.amax,
            "min": torch.amin}


class _Instr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_uint8), ("dst", ctypes.c_uint8),
                ("a", ctypes.c_uint16), ("b", ctypes.c_uint16),
                ("c", ctypes.c_uint16)]


class _Params(ctypes.Structure):
    """Byte-for-byte mirror of ``Params`` in the CUDA source."""

    _fields_ = [
        ("n", ctypes.c_int64),
        ("inp", ctypes.c_void_p * MAX_IN),
        ("out", ctypes.c_void_p * MAX_OUT),
        ("n_in", ctypes.c_int), ("n_slots", ctypes.c_int),
        ("n_scalars", ctypes.c_int), ("n_instr", ctypes.c_int),
        ("n_out", ctypes.c_int), ("tile", ctypes.c_int),
        ("stages", ctypes.c_int), ("grid", ctypes.c_int),
        ("aligned", ctypes.c_int), ("smem", ctypes.c_int),
        ("in_bool", ctypes.c_uint8 * MAX_IN),
        ("out_kind", ctypes.c_uint8 * MAX_OUT),
        ("out_src", ctypes.c_uint16 * MAX_OUT),
        ("scalars", ctypes.c_float * MAX_SCALARS),
        ("code", _Instr * MAX_INSTR),
    ]


def fits_kernel(program: Program) -> str | None:
    """Why the kernel cannot run ``program`` (None when it can)."""
    if not 1 <= program.n_split <= MAX_IN:
        return f"{program.n_split} split inputs (kernel takes 1..{MAX_IN})"
    if len(program.outputs) > MAX_OUT:
        return f"{len(program.outputs)} outputs (max {MAX_OUT})"
    if program.n_scalars > MAX_SCALARS:
        return f"{program.n_scalars} scalars (max {MAX_SCALARS})"
    if len(program.code) > MAX_INSTR:
        return f"{len(program.code)} instructions (max {MAX_INSTR})"
    if program.n_split + program.stored_slots > MAX_ROWS:
        return (f"{program.n_split} inputs + {program.stored_slots} stored slots exceed "
                f"{MAX_ROWS} shared-memory rows")
    return None


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


class Geometry(NamedTuple):
    tile: int        # elements per tile (TILE / VEC threads per CTA)
    stages: int      # depth of the input ring
    smem: int        # dynamic shared memory per CTA, bytes


def _align128(x: int) -> int:
    return (x + 127) & ~127


def smem_bytes(tile: int, stages: int, n_in: int, stored: int, n_scalars: int,
               n_instr: int, n_out: int, any_reduce: bool) -> int:
    """The kernel's shared-memory layout (``layout`` in the CUDA source):
    ring mbarriers, 16 bytes per scalar and per decoded instruction (plus a
    spare one), decoded outputs, per-thread reduction accumulators, then
    ``stages * n_in`` ring rows and ``stored`` slot rows of ``4 * tile``
    bytes."""
    outs = 16 * MAX_STAGES + 16 * n_scalars + 16 * (n_instr + 1)
    red = _align128(outs + 8 * MAX_OUT)
    ring = _align128(red + (4 * (n_out * (tile // VEC) + 32) if any_reduce else 0))
    return ring + 4 * tile * (stages * n_in + stored)


def estimated_ctas_per_sm(tile: int, smem: int) -> int:
    """CTAs per SM that shared memory and threads allow (registers, which
    only the card's occupancy calculator knows, left out)."""
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED), THREADS_PER_SM // (tile // VEC), 32)


def geometry(n_in: int, stored: int, n_scalars: int, n_instr: int, n_out: int,
             any_reduce: bool,
             ctas_per_sm: Callable[[int, int], int] = estimated_ctas_per_sm,
             tiles: Sequence[int] = TILES) -> Geometry:
    """Tile size and ring depth for a program with ``n_in`` split inputs and
    ``stored`` stored slots.  Of every (tile, stages) in ``TILES`` x
    ``STAGES`` whose shared memory fits a CTA, take the one with the most
    warps resident per SM (``ctas_per_sm(tile, smem)`` x tile / (VEC x
    32)); on a tie the one with at least three CTAs per SM (with a one-stage
    ring, the other CTAs on the SM hide a CTA's loads), then the larger
    tile, then the deeper ring.  The interpreter is bound by issue and
    latency, so resident warps come first (``chip_smoke.py`` times every
    alternative; PERF.md has the numbers).  Every program ``fits_kernel``
    accepts fits: 16 inputs and 40 slots take 1024 x 1 (or 512-element tiles
    when the decoded program and reductions leave no room).  ``tiles``
    narrows the tile sizes weighed (the plan cache's tuner pins one)."""
    best = None
    for tile in tiles:
        for stages in STAGES:
            smem = smem_bytes(tile, stages, n_in, stored, n_scalars, n_instr, n_out, any_reduce)
            if smem > SMEM_PER_BLOCK:
                continue
            ctas = ctas_per_sm(tile, smem)
            key = (ctas * tile // (VEC * 32), min(ctas, 3), tile, stages)
            if best is None or key > best[0]:
                best = (key, Geometry(tile, stages, smem))
    if best is None or best[0][0] == 0:
        raise ValueError(f"{n_in} inputs and {stored} slots fit no CTA")
    return best[1]


def _geometry_args(program: Program, out_kinds: Sequence[tuple[str, str]]) -> tuple:
    return (program.n_split, program.stored_slots, program.n_scalars, len(program.code),
            len(program.outputs), any(k == "reduce" for k, _op in out_kinds))


def program_geometry(program: Program, out_kinds: Sequence[tuple[str, str]],
                     device: int | None = None,
                     tiles: Sequence[int] = TILES) -> Geometry:
    """``geometry`` of ``program`` over ``tiles``: with the card's occupancy
    calculator for a device index, with ``estimated_ctas_per_sm`` for None."""
    return _device_geometry(_geometry_args(program, out_kinds), device, tuple(tiles))


@functools.lru_cache(maxsize=256)
def _device_geometry(args: tuple, device: int | None, tiles: tuple) -> Geometry:
    if device is None:
        return geometry(*args, tiles=tiles)
    return geometry(*args, ctas_per_sm=lambda tile, smem: _ctas_per_sm(tile, smem, device),
                    tiles=tiles)


def sized(program: Program, out_kinds: Sequence[tuple[str, str]], tile: int,
          stages: int) -> Geometry:
    """``program`` at another tile size and ring depth than the rule's."""
    args = _geometry_args(program, out_kinds)
    return Geometry(tile, stages, smem_bytes(tile, stages, *args))


def load_paths(split_inputs: Sequence[torch.Tensor], tile: int) -> dict[str, int]:
    """How many tiles of a launch the kernel copies by TMA bulk copy
    (``"bulk"``) and how many by plain loads (``"plain"``).  A bulk copy
    needs a 16-byte aligned source and a size that is a multiple of 16: so
    every whole tile takes it when every input's base is 16-byte aligned
    (a float32 tile is 4 * tile bytes, a bool tile tile bytes), and the
    ragged last tile, or every tile of a launch with an unaligned base,
    takes plain loads.  Reads only lengths and addresses, so CPU and meta
    tensors answer as CUDA ones would."""
    n = int(split_inputs[0].shape[0])
    tiles, whole = -(-n // tile), n // tile
    if _aligned(split_inputs):
        return {"bulk": whole, "plain": tiles - whole}
    return {"bulk": 0, "plain": tiles}


def _aligned(split_inputs: Sequence[torch.Tensor]) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in split_inputs)


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------


def _configure(lib: ctypes.CDLL) -> None:
    lib.split_pipeline_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.split_pipeline_launch.restype = ctypes.c_int
    lib.split_pipeline_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.split_pipeline_occupancy.restype = ctypes.c_int
    lib.split_pipeline_error_string.argtypes = [ctypes.c_int]
    lib.split_pipeline_error_string.restype = ctypes.c_char_p
    for name in ("split_pipeline_params_size",
                 "split_pipeline_num_opcodes", "split_pipeline_vec"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    abi = (lib.split_pipeline_params_size(),
           lib.split_pipeline_num_opcodes(), lib.split_pipeline_vec())
    want = (ctypes.sizeof(_Params), len(OPCODES), VEC)
    if abi != want:
        raise kernel_build.KernelError(f"split_pipeline ABI mismatch: kernel "
                           f"{abi} vs wrapper {want}")


def _load() -> ctypes.CDLL:
    return kernel_build.load(SOURCE, _configure)


@functools.lru_cache(maxsize=64)
def _ctas_per_sm(tile: int, smem: int, device: int) -> int:
    lib = _load()
    ctas = lib.split_pipeline_occupancy(tile, smem, device)
    if ctas <= 0:
        msg = lib.split_pipeline_error_string(-ctas).decode() if ctas else "no CTA fits"
        raise kernel_build.KernelError(f"split_pipeline occupancy ({tile}, {smem} B): {msg}")
    return ctas


@functools.lru_cache(maxsize=16)
def _sm_count(device: int) -> int:
    return hardware.chip_for(torch.device("cuda", device)).num_sms


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------


def _check_program(program: Program) -> None:
    """Every operand names a value the kernel has; raises otherwise."""
    stored = program.stored_slots

    def check(x: int, where: str, pc: int) -> None:
        kind, idx = decode(x)
        ok = {KIND_INPUT: idx < program.n_split, KIND_SCALAR: idx < program.n_scalars,
              KIND_SLOT: idx < stored, KIND_FWD: pc > 0}[kind]
        if not ok:
            raise ValueError(f"{where}: operand {x:#06x} names nothing the kernel holds")

    for i, (op, dst, a, b, c) in enumerate(program.code):
        if not 0 <= op < len(OPCODES) or not (dst & NO_STORE or dst < stored):
            raise ValueError(f"bad instruction {i}: {(op, dst, a, b, c)}")
        for x in (a, b, c)[:OPCODES[op][1]]:
            check(x, f"instruction {i}", i)
    for j, (src, _is_bool) in enumerate(program.outputs):
        check(src, f"output {j}", len(program.code))


@functools.lru_cache(maxsize=128)
def _template(program: Program) -> bytes:
    """The launch-invariant part of the kernel's parameter block."""
    _check_program(program)
    p = _Params()
    p.n_in = program.n_split
    p.n_slots = program.stored_slots
    p.n_scalars = program.n_scalars
    p.n_instr = len(program.code)
    for i, (op, dst, a, b, c) in enumerate(program.code):
        p.code[i] = _Instr(op, dst, a, b, c)
    for i, v in enumerate(program.imms):
        p.scalars[program.n_bcast + i] = float(v)
    return bytes(p)


def _check_inputs(split_inputs: Sequence[torch.Tensor]) -> torch.device:
    dev = split_inputs[0].device
    n = split_inputs[0].shape[0] if split_inputs[0].dim() == 1 else -1
    for x in split_inputs:
        if x.device != dev:
            raise ValueError(f"split inputs on {x.device} and {dev}")
        if x.dim() != 1 or x.shape[0] != n:
            raise ValueError("split inputs must be 1-D of one length; got "
                             f"{[tuple(t.shape) for t in split_inputs]}")
        if x.dtype not in (torch.float32, torch.bool):
            raise TypeError(f"split input dtype {x.dtype}: the kernel takes "
                            "float32 and bool")
    return dev


def _scalar(v: Any) -> float:
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"broadcast input of shape {tuple(v.shape)}")
        return float(v.reshape(()))      # host read (syncs a CUDA scalar)
    return float(v)


def split_pipeline(program: Program, split_inputs: Sequence[torch.Tensor],
                   bcast_inputs: Sequence[Any],
                   out_kinds: Sequence[tuple[str, str]]) -> list[torch.Tensor]:
    """Run one lowered stage.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``split_pipeline.launches`` counts launches,
    ``split_pipeline.tile_paths`` the tiles per load path).

    Returns, per output, the concat result (length n, float32 or bool) or
    the reduction as a 0-d float32 tensor."""
    return _launch(program, split_inputs, bcast_inputs, out_kinds)


def _launch(program: Program, split_inputs: Sequence[torch.Tensor],
            bcast_inputs: Sequence[Any], out_kinds: Sequence[tuple[str, str]],
            geom: Geometry | None = None) -> list[torch.Tensor]:
    """``split_pipeline``, with ``geom`` overriding the ``geometry`` rule on
    a CUDA tensor (for measuring the rule's alternatives; never by
    default)."""
    if not split_inputs:
        raise ValueError("split_pipeline needs at least one split input")
    dev = _check_inputs(split_inputs)
    if len(bcast_inputs) != program.n_bcast or len(out_kinds) != len(program.outputs):
        raise ValueError("program does not match its inputs/outputs")
    if dev.type == "cpu":
        return split_pipeline_ref(program, split_inputs, bcast_inputs, out_kinds)
    if dev.type != "cuda":
        raise ValueError(f"split_pipeline runs on cuda or cpu, not {dev}")
    why = fits_kernel(program)
    if why is not None:
        raise ValueError(f"program does not fit the kernel: {why}")
    if any(not x.is_contiguous() for x in split_inputs):
        raise ValueError("split inputs must be contiguous")
    n = int(split_inputs[0].shape[0])
    if n == 0:
        raise ValueError("split_pipeline has nothing to launch for n == 0")

    lib = _load()
    g = geom or program_geometry(program, out_kinds, dev.index)
    paths = load_paths(split_inputs, g.tile)
    grid = min(-(-n // g.tile), _sm_count(dev.index) * _ctas_per_sm(g.tile, g.smem, dev.index))
    p = _Params.from_buffer_copy(_template(program))
    p.n, p.tile, p.stages, p.grid, p.smem = n, g.tile, g.stages, grid, g.smem
    p.aligned = _aligned(split_inputs)
    for i, x in enumerate(split_inputs):
        p.inp[i] = x.data_ptr()
        p.in_bool[i] = x.dtype == torch.bool
    for i, v in enumerate(bcast_inputs):
        p.scalars[i] = _scalar(v)
    outs = []
    for j, ((kind, op), (src, is_bool)) in enumerate(zip(out_kinds, program.outputs)):
        if kind == "reduce":
            buf = torch.empty(grid, dtype=torch.float32, device=dev)
            p.out_kind[j] = _OUT_KIND[("reduce", op)]
        else:
            buf = torch.empty(n, dtype=torch.bool if is_bool else torch.float32,
                              device=dev)
            p.out_kind[j] = _OUT_KIND[("concat", bool(is_bool))]
        p.out[j] = buf.data_ptr()
        p.out_src[j] = src
        outs.append(buf)
    p.n_out = len(outs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.split_pipeline_launch(ctypes.addressof(p), dev.index, stream)
    if rc != 0:
        msg = lib.split_pipeline_error_string(rc).decode()
        raise kernel_build.KernelError(f"split_pipeline launch failed: {msg} ({rc})")
    split_pipeline.launches += 1
    for path, tiles in paths.items():
        split_pipeline.tile_paths[path] += tiles
    return [_COMBINE[op](buf) if kind == "reduce" else buf
            for (kind, op), buf in zip(out_kinds, outs)]


def reset_counts() -> None:
    """Set the launch count and the per-path tile counts to 0."""
    split_pipeline.launches = 0
    split_pipeline.tile_paths = {"bulk": 0, "plain": 0}


#: kernel launches since the last reset, and tiles per load path.
reset_counts()
