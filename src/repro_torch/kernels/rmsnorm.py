"""Fused RMSNorm kernel wrapper: mean square, rsqrt and scale of every row as
ONE CUDA kernel launch.

The counterpart of ``src/repro/kernels/rmsnorm.py``.  The kernel
(``csrc/rmsnorm.cu``) reads each row of x (float32 or bfloat16) once, takes
its mean square in float32, and writes ``(x * rsqrt(ms + eps)) * w`` in x's
dtype; w is float32 or bfloat16.  One warp per row, eight rows per CTA,
16-byte loads and stores, so rows need no padding (the reference pads them
to whole row blocks); a row that is not 16-byte aligned (an offset view, an
odd width) takes the kernel's scalar loop.

Built with ``nvcc`` for ``sm_90a`` at first use (``kernels/build.py``),
bound with ``ctypes`` and launched on PyTorch's current stream.  A tensor on
the CPU takes the plain version (``kernels/ref.py::rmsnorm_ref``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build as kernel_build
from repro_torch.kernels.ref import rmsnorm_ref

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rmsnorm.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _configure(lib: ctypes.CDLL) -> None:
    lib.rmsnorm_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, *([ctypes.c_void_p] * 3), ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_launch.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of x (..., d) with weight w (d,).  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (``rmsnorm.launches`` counts launches)."""
    if x.dim() == 0 or w.shape != x.shape[-1:]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: w must be (d,)")
    if w.device != x.device:
        raise ValueError(f"w lies on {w.device}, x on {x.device}")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"x {x.dtype} / w {w.dtype}: the kernel takes float32 or bfloat16")
    d = x.shape[-1]
    n = math.prod(x.shape[:-1])
    x2 = x.reshape(n, d).contiguous()
    out = torch.empty_like(x2)
    if out.numel() == 0:
        return out.reshape(x.shape)
    if n >= 1 << 31:
        raise ValueError(f"{n} rows exceed the kernel's grid")
    w = w.contiguous()
    lib = kernel_build.load(SOURCE, _configure)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.rmsnorm_launch(_DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], x2.data_ptr(),
                            w.data_ptr(), out.data_ptr(), n, d, float(eps),
                            x.device.index, stream)
    if rc != 0:
        msg = lib.rmsnorm_error_string(rc).decode()
        raise kernel_build.KernelError(f"rmsnorm launch failed: {msg} ({rc})")
    rmsnorm.launches += 1
    return out.reshape(x.shape)


#: kernel launches since the last reset (``rmsnorm.launches = 0``).
rmsnorm.launches = 0
