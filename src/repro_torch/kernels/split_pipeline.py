"""Split-pipeline kernel wrapper: a Mozart stage as ONE CUDA kernel launch.

The counterpart of ``src/repro/kernels/split_pipeline.py``.  The stage's
chain arrives lowered to a ``Program`` (``core/cuda_exec.py``); the fixed
kernel in ``csrc/split_pipeline.cu`` interprets it tile by tile so that
intermediates never reach device memory, writes the concat outputs, and
writes one partial per CTA for each reduction, which this wrapper combines
after the launch.

The kernel takes every dtype of ``program.DTYPES`` (bool, int8/16/32,
uint8/16/32, float16, bfloat16, float32): inputs are read and outputs
written at their own width, and every value is a 32-bit word in between
(``program.py``).  Two pure rules, callable on CPU and meta tensors, shape
a launch: ``geometry`` picks the tile size and the depth of the input ring
from the program's rows (an input's ring row holds its tile at its own
width; a slot row is 32-bit words), and ``load_paths`` says which tiles the
kernel copies with TMA bulk copies and which with plain loads.  The grid is
min(tiles, SMs x CTAs per SM), the latter from the CUDA occupancy
calculator for the launch's shared memory.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/build.py``), bound with ``ctypes`` (plain C entry points) and
launched on PyTorch's current stream.  A tensor on the CPU takes the plain
version (``kernels/ref.py``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
from pathlib import Path
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch import hardware
from repro_torch.kernels import build as kernel_build
from repro_torch.kernels import program as P
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
from repro_torch.kernels.ref import reduce_words, scalar_word, split_pipeline_ref

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
#: version of the parameter block and the typed program (``ABI_VERSION`` in
#: the CUDA source): 2 since the kernel takes every dtype of ``DTYPES``.
ABI_VERSION = 2

_OUT_KIND = {("concat", False): 0, ("concat", True): 1, ("reduce", "add"): 2,
             ("reduce", "mul"): 3, ("reduce", "max"): 4, ("reduce", "min"): 5}
_COMBINE = {"add": torch.sum, "mul": torch.prod, "max": torch.amax,
            "min": torch.amin}


class _Instr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_uint8), ("dst", ctypes.c_uint8),
                ("a", ctypes.c_uint16), ("b", ctypes.c_uint16),
                ("c", ctypes.c_uint16),
                ("sdt", ctypes.c_uint8), ("dt", ctypes.c_uint8)]   # dtype codes


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
        ("in_dtype", ctypes.c_uint8 * MAX_IN),
        ("out_kind", ctypes.c_uint8 * MAX_OUT),
        ("out_dtype", ctypes.c_uint8 * MAX_OUT),
        ("out_src", ctypes.c_uint16 * MAX_OUT),
        ("scalars", ctypes.c_uint32 * MAX_SCALARS),    # 32-bit words
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
               n_instr: int, n_out: int, any_reduce: bool,
               in_bytes: int | None = None) -> int:
    """The kernel's shared-memory layout (``layout`` in the CUDA source):
    ring mbarriers, 16 bytes per scalar and per decoded instruction (plus a
    spare one), decoded outputs, per-thread reduction accumulators, then
    ``stages`` ring stages of one row per input at its width (``in_bytes *
    tile`` bytes a stage: the inputs' element sizes summed, 4 per input by
    default) and ``stored`` slot rows of ``4 * tile`` bytes."""
    outs = 16 * MAX_STAGES + 16 * n_scalars + 16 * (n_instr + 1)
    red = _align128(outs + 8 * MAX_OUT)
    ring = _align128(red + (4 * (n_out * (tile // VEC) + 32) if any_reduce else 0))
    return ring + tile * (stages * (4 * n_in if in_bytes is None else in_bytes) + 4 * stored)


def estimated_ctas_per_sm(tile: int, smem: int) -> int:
    """CTAs per SM that shared memory and threads allow (registers, which
    only the card's occupancy calculator knows, left out)."""
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED), THREADS_PER_SM // (tile // VEC), 32)


def geometry(n_in: int, stored: int, n_scalars: int, n_instr: int, n_out: int,
             any_reduce: bool,
             ctas_per_sm: Callable[[int, int], int] = estimated_ctas_per_sm,
             tiles: Sequence[int] = TILES, in_bytes: int | None = None) -> Geometry:
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
    narrows the tile sizes weighed (the plan cache's tuner pins one);
    ``in_bytes`` is the inputs' element sizes summed (4 per input by
    default)."""
    best = None
    for tile in tiles:
        for stages in STAGES:
            smem = smem_bytes(tile, stages, n_in, stored, n_scalars, n_instr, n_out, any_reduce,
                              in_bytes)
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


def _in_rows(program: Program) -> tuple[int | None, bool]:
    """(the inputs' element sizes summed, whether one is 1 or 2 bytes: the
    kernel's NARROW variant) when the program names its input dtypes;
    (None, False) for a float32 program of the first version (4 bytes per
    input, at most: a bool input takes 1)."""
    if not program.in_dtypes:
        return None, False
    return (sum(P.ITEMSIZE[c] for c in program.in_dtypes),
            any(P.ITEMSIZE[c] != 4 for c in program.in_dtypes))


def program_geometry(program: Program, out_kinds: Sequence[tuple[str, str]],
                     device: int | None = None,
                     tiles: Sequence[int] = TILES) -> Geometry:
    """``geometry`` of ``program`` over ``tiles``: with the card's occupancy
    calculator for a device index, with ``estimated_ctas_per_sm`` for None."""
    return _device_geometry(_geometry_args(program, out_kinds), device, tuple(tiles),
                            _in_rows(program))


@functools.lru_cache(maxsize=256)
def _device_geometry(args: tuple, device: int | None, tiles: tuple,
                     rows: tuple = (None, False)) -> Geometry:
    in_bytes, narrow = rows
    if device is None:
        return geometry(*args, tiles=tiles, in_bytes=in_bytes)
    return geometry(*args, ctas_per_sm=lambda tile, smem: _ctas_per_sm(tile, smem, device,
                                                                       narrow),
                    tiles=tiles, in_bytes=in_bytes)


def sized(program: Program, out_kinds: Sequence[tuple[str, str]], tile: int,
          stages: int) -> Geometry:
    """``program`` at another tile size and ring depth than the rule's."""
    args = _geometry_args(program, out_kinds)
    return Geometry(tile, stages, smem_bytes(tile, stages, *args, _in_rows(program)[0]))


def load_paths(split_inputs: Sequence[torch.Tensor], tile: int) -> dict[str, int]:
    """How many tiles of a launch the kernel copies by TMA bulk copy
    (``"bulk"``) and how many by plain loads (``"plain"``).  A bulk copy
    needs a 16-byte aligned source and a size that is a multiple of 16: so
    every whole tile takes it when every input's base is 16-byte aligned
    (a tile is itemsize * tile bytes: 1, 2 or 4 * tile, a multiple of 16
    for every tile size), and the
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
    lib.split_pipeline_occupancy.argtypes = [ctypes.c_int] * 4
    lib.split_pipeline_occupancy.restype = ctypes.c_int
    lib.split_pipeline_error_string.argtypes = [ctypes.c_int]
    lib.split_pipeline_error_string.restype = ctypes.c_char_p
    for name in ("split_pipeline_params_size", "split_pipeline_num_opcodes",
                 "split_pipeline_vec", "split_pipeline_abi_version",
                 "split_pipeline_num_dtypes"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    abi = (lib.split_pipeline_params_size(), lib.split_pipeline_num_opcodes(),
           lib.split_pipeline_vec(), lib.split_pipeline_abi_version(),
           lib.split_pipeline_num_dtypes())
    want = (ctypes.sizeof(_Params), len(OPCODES), VEC, ABI_VERSION, len(P.DTYPES))
    if abi != want:
        raise kernel_build.KernelError(f"split_pipeline ABI mismatch: kernel "
                           f"{abi} vs wrapper {want}")


def _load() -> ctypes.CDLL:
    return kernel_build.load(SOURCE, _configure)


@functools.lru_cache(maxsize=64)
def _ctas_per_sm(tile: int, smem: int, device: int, narrow: bool = False) -> int:
    """CTAs per SM from the card's occupancy calculator, for the kernel's
    variant (``narrow``: the one for programs with a 1- or 2-byte input)."""
    lib = _load()
    ctas = lib.split_pipeline_occupancy(tile, smem, device, int(narrow))
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
    """Every operand names a value the kernel has, and every dtype code is
    one it takes (an opcode of ``FLOAT_ONLY`` computing in the float
    class); raises otherwise."""
    stored = program.stored_slots
    types = program.instr_types
    n_dt = len(P.DTYPES)
    if len(types) != len(program.code) or len(program.scalar_types) != program.n_scalars \
            or len(program.output_types) != len(program.outputs) \
            or (program.in_dtypes and len(program.in_dtypes) != program.n_split):
        raise ValueError("program dtypes do not match its instructions, scalars, "
                         "inputs or outputs")
    for code in (*program.in_dtypes, *program.scalar_types, *program.output_types,
                 *(c for t in types for c in t)):
        if not 0 <= code < n_dt:
            raise ValueError(f"dtype code {code} (the kernel takes 0..{n_dt - 1})")
    for i, (op, *_rest) in enumerate(program.code):
        if 0 <= op < len(OPCODES) and OPCODES[op][0] in P.FLOAT_ONLY \
                and P.CLASS[types[i][0]] != P.FLOAT:
            raise ValueError(f"instruction {i}: {OPCODES[op][0]} computes in "
                             f"{P.DTYPES[types[i][0]]}")

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
    for i, ((op, dst, a, b, c), (sdt, dt)) in enumerate(zip(program.code,
                                                             program.instr_types)):
        p.code[i] = _Instr(op, dst, a, b, c, sdt, dt)
    codes = program.scalar_types
    for i, v in enumerate(program.imms):
        p.scalars[program.n_bcast + i] = _bits(scalar_word(v, codes[program.n_bcast + i]),
                                               codes[program.n_bcast + i])
    for j, code in enumerate(program.in_dtypes):
        p.in_dtype[j] = code
    for j, code in enumerate(program.output_types):
        p.out_dtype[j] = code
    return bytes(p)


def _bits(word: float | int, code: int) -> int:
    """A scalar word (``ref.scalar_word``) as the kernel's 32 bits."""
    if P.CLASS[code] == P.FLOAT:
        return struct.unpack("<I", struct.pack("<f", word))[0]
    return word & 0xFFFFFFFF


def _check_inputs(split_inputs: Sequence[torch.Tensor]) -> torch.device:
    dev = split_inputs[0].device
    n = split_inputs[0].shape[0] if split_inputs[0].dim() == 1 else -1
    for x in split_inputs:
        if x.device != dev:
            raise ValueError(f"split inputs on {x.device} and {dev}")
        if x.dim() != 1 or x.shape[0] != n:
            raise ValueError("split inputs must be 1-D of one length; got "
                             f"{[tuple(t.shape) for t in split_inputs]}")
        if x.dtype not in P.CODE:
            raise TypeError(f"split input dtype {x.dtype}: the kernel takes "
                            f"{', '.join(str(d).replace('torch.', '') for d in P.DTYPES)}")
    return dev


def _in_codes(program: Program, split_inputs: Sequence[torch.Tensor]) -> tuple[int, ...]:
    """The inputs' dtype codes: the program's, which the tensors must have
    (a program without input dtypes takes float32 and bool inputs)."""
    got = tuple(P.CODE[x.dtype] for x in split_inputs)
    want = program.in_dtypes
    if want and got != want:
        raise TypeError(f"split inputs of dtypes {[str(x.dtype) for x in split_inputs]} "
                        f"for a program lowered for {[str(P.DTYPES[c]) for c in want]}")
    if not want and any(c not in (P.F32, P.BOOL) for c in got):
        raise TypeError("a program without input dtypes takes float32 and bool inputs")
    return got


def _scalar(v: Any, code: int) -> int:
    if isinstance(v, torch.Tensor) and v.numel() != 1:
        raise ValueError(f"broadcast input of shape {tuple(v.shape)}")
    return _bits(scalar_word(v, code), code)


def split_pipeline(program: Program, split_inputs: Sequence[torch.Tensor],
                   bcast_inputs: Sequence[Any],
                   out_kinds: Sequence[tuple[str, str]]) -> list[torch.Tensor]:
    """Run one lowered stage.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``split_pipeline.launches`` counts launches,
    ``split_pipeline.tile_paths`` the tiles per load path).

    Returns, per output, the concat result (length n, of the output's
    dtype) or the reduction as a 0-d tensor of its accumulator dtype."""
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
    in_codes = _in_codes(program, split_inputs)
    if dev.type == "cpu":
        return split_pipeline_ref(program, split_inputs, bcast_inputs, out_kinds)
    if not program.in_dtypes:          # the layout (widened bool rows) needs them
        program = dataclasses.replace(program, in_dtypes=in_codes)
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
    grid = min(-(-n // g.tile), _sm_count(dev.index) * _ctas_per_sm(g.tile, g.smem, dev.index,
                                                                    _in_rows(program)[1]))
    p = _Params.from_buffer_copy(_template(program))
    p.n, p.tile, p.stages, p.grid, p.smem = n, g.tile, g.stages, grid, g.smem
    p.aligned = _aligned(split_inputs)
    for i, x in enumerate(split_inputs):
        p.inp[i] = x.data_ptr()
        p.in_dtype[i] = in_codes[i]
    codes = program.scalar_types
    for i, (kind, v) in enumerate(program.scalar_sources()):
        if kind == "bcast":
            p.scalars[i] = _scalar(bcast_inputs[v], codes[i])
    outs = []
    for j, ((kind, op), (src, is_bool), code) in enumerate(zip(out_kinds, program.outputs,
                                                              program.output_types)):
        if kind == "reduce":
            # one 32-bit partial per CTA: float32, or an integer's bits
            buf = torch.empty(grid, dtype=torch.float32 if P.CLASS[code] == P.FLOAT
                              else torch.int32, device=dev)
            p.out_kind[j] = _OUT_KIND[("reduce", op)]
        else:
            buf = torch.empty(n, dtype=P.DTYPES[code], device=dev)
            p.out_kind[j] = _OUT_KIND[("concat", code == P.BOOL)]
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
    return [_combine(buf, op, code) if kind == "reduce" else buf
            for (kind, op), buf, code in zip(out_kinds, outs, program.output_types)]


def _combine(partials: torch.Tensor, op: str, code: int) -> torch.Tensor:
    """The per-CTA partials of a reduction as its 0-d result of dtype
    ``code`` (unsigned partials zero-extended from their bits first)."""
    if P.CLASS[code] == P.UNSIGNED:
        partials = partials.to(torch.int64) & 0xFFFFFFFF
    return reduce_words(partials, op, code)


def reset_counts() -> None:
    """Set the launch count and the per-path tile counts to 0."""
    split_pipeline.launches = 0
    split_pipeline.tile_paths = {"bulk": 0, "plain": 0}


#: kernel launches since the last reset, and tiles per load path.
reset_counts()
