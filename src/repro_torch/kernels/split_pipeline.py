"""Split-pipeline kernel wrapper: a Mozart stage as ONE CUDA kernel launch.

The counterpart of ``src/repro/kernels/split_pipeline.py``.  The stage's
chain arrives lowered to a ``Program`` (``core/cuda_exec.py``); the fixed
kernel in ``csrc/split_pipeline.cu`` interprets it on shared-memory tiles so
that intermediates never reach device memory, writes the concat outputs,
and writes one partial per block for each reduction, which this wrapper
combines after the launch.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/build.py``), bound with ``ctypes`` (plain C entry points) and
launched on PyTorch's current stream.  A tensor on the CPU takes the plain
version (``kernels/ref.py``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Any, Sequence

import torch

from repro_torch.kernels import build as kernel_build
from repro_torch.kernels.program import OPCODES, Program
from repro_torch.kernels.ref import split_pipeline_ref

# Mirrors of the kernel's limits (csrc/split_pipeline.cu).
TILE = 1024
MAX_IN = 16
MAX_OUT = 16
MAX_SCALARS = 64
MAX_INSTR = 256
MAX_ROWS = 56

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
        ("n_out", ctypes.c_int), ("pad_", ctypes.c_int),
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
    if program.n_split + program.n_slots > MAX_ROWS:
        return (f"{program.n_split} inputs + {program.n_slots} slots exceed "
                f"{MAX_ROWS} shared-memory rows")
    return None


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------


def _configure(lib: ctypes.CDLL) -> None:
    lib.split_pipeline_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.split_pipeline_launch.restype = ctypes.c_int
    lib.split_pipeline_error_string.argtypes = [ctypes.c_int]
    lib.split_pipeline_error_string.restype = ctypes.c_char_p
    for name in ("split_pipeline_params_size",
                 "split_pipeline_num_opcodes", "split_pipeline_tile"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    abi = (lib.split_pipeline_params_size(),
           lib.split_pipeline_num_opcodes(), lib.split_pipeline_tile())
    want = (ctypes.sizeof(_Params), len(OPCODES), TILE)
    if abi != want:
        raise RuntimeError(f"split_pipeline ABI mismatch: kernel "
                           f"{abi} vs wrapper {want}")


def _load() -> ctypes.CDLL:
    return kernel_build.load(SOURCE, _configure)


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=128)
def _template(program: Program) -> bytes:
    """The launch-invariant part of the kernel's parameter block."""
    p = _Params()
    p.n_in = program.n_split
    p.n_slots = program.n_slots
    p.n_scalars = program.n_scalars
    p.n_instr = len(program.code)
    for i, (op, dst, a, b, c) in enumerate(program.code):
        if not 0 <= op < len(OPCODES) or not 0 <= dst < program.n_slots:
            raise ValueError(f"bad instruction {i}: {(op, dst, a, b, c)}")
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
    tensors launch the kernel (``split_pipeline.launches`` counts launches).

    Returns, per output, the concat result (length n, float32 or bool) or
    the reduction as a 0-d float32 tensor."""
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
    grid = -(-n // TILE)
    p = _Params.from_buffer_copy(_template(program))
    p.n = n
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
        raise RuntimeError(f"split_pipeline launch failed: {msg} ({rc})")
    split_pipeline.launches += 1
    return [_COMBINE[op](buf) if kind == "reduce" else buf
            for (kind, op), buf in zip(out_kinds, outs)]


#: kernel launches since the last reset (``split_pipeline.launches = 0``).
split_pipeline.launches = 0
