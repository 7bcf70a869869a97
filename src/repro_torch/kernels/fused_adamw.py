"""Fused AdamW kernel wrapper: one AdamW step over a flat parameter leaf as
ONE CUDA kernel launch.

The counterpart of ``src/repro/kernels/fused_adamw.py``.  The kernel
(``csrc/fused_adamw.cu``) reads p and g (float32 or bfloat16) and float32 m
and v once, writes p in p's dtype and float32 m and v into fresh buffers,
and masks the ragged tail itself (the reference pads the leaf to whole
64 Ki tiles).  lr, b1, b2, c1, c2 and gscale travel as one (8,) float32
tensor on the leaf's device (``scalar_row``), read by the kernel through a
pointer, so a training step makes no host read of them.

Built with ``nvcc`` for ``sm_90a`` at first use (``kernels/build.py``),
bound with ``ctypes`` and launched on PyTorch's current stream.  A tensor on
the CPU takes the plain version (``kernels/ref.py::adamw_ref``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as kernel_build
from repro_torch.kernels.ref import adamw_ref

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_adamw.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VECTOR_ALIGN = {torch.float32: 16, torch.bfloat16: 8}   # 4 elements


def scalar_row(lr, b1: float, b2: float, step, grad_scale=1.0) -> torch.Tensor:
    """The kernel's (8,) float32 scalar row ``lr, b1, b2, c1, c2, gscale, 0,
    0`` on ``step``'s device, with ``c1 = 1/(1 - b1**step)`` and ``c2 = 1/(1
    - b2**step)`` computed in float32 from the integer step (as the
    reference wrapper does).  ``lr`` and ``grad_scale`` may be device
    tensors; nothing is read back to the host."""
    step = torch.as_tensor(step)
    dev = step.device
    s = step.to(torch.float32)
    c1 = 1.0 / (1.0 - b1 ** s)
    c2 = 1.0 / (1.0 - b2 ** s)

    def f32(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float32).reshape(())
        return torch.full((), x, dtype=torch.float32, device=dev)

    return torch.stack([f32(lr), f32(b1), f32(b2), c1.reshape(()),
                        c2.reshape(()), f32(grad_scale), f32(0.0), f32(0.0)])


def _configure(lib: ctypes.CDLL) -> None:
    lib.fused_adamw_launch.argtypes = [
        ctypes.c_int, *([ctypes.c_void_p] * 8), ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.fused_adamw_launch.restype = ctypes.c_int
    lib.fused_adamw_error_string.argtypes = [ctypes.c_int]
    lib.fused_adamw_error_string.restype = ctypes.c_char_p


def _load() -> ctypes.CDLL:
    return kernel_build.load(SOURCE, _configure)


def _check(p, g, m, v, sc) -> None:
    n = p.shape[0] if p.dim() == 1 else -1
    for name, x in (("p", p), ("g", g), ("m", m), ("v", v)):
        if x.dim() != 1 or x.shape[0] != n:
            raise ValueError("p, g, m, v must be 1-D of one length; got "
                             f"{[tuple(t.shape) for t in (p, g, m, v)]}")
        if x.device != p.device:
            raise ValueError(f"{name} lies on {x.device}, p on {p.device}")
    if p.dtype not in _DTYPE_CODE or g.dtype != p.dtype:
        raise TypeError(f"p {p.dtype} / g {g.dtype}: the kernel takes float32 "
                        "or bfloat16 p with g of the same dtype")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"m {m.dtype} / v {v.dtype} must be float32")
    if sc.shape != (8,) or sc.dtype != torch.float32 or sc.device != p.device:
        raise ValueError(f"scalar row {tuple(sc.shape)} {sc.dtype} on "
                         f"{sc.device}: need (8,) float32 on {p.device}")


def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, sc: torch.Tensor, *, eps: float,
                wd: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AdamW step over flat (N,) p, g, m, v with the ``scalar_row`` sc.
    Returns new (p, m, v); the inputs are not modified.  CPU tensors take
    the plain version; CUDA tensors launch the kernel
    (``fused_adamw.launches`` counts launches)."""
    _check(p, g, m, v, sc)
    if p.device.type == "cpu":
        return adamw_ref(p, g, m, v, sc, eps=eps, wd=wd)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw runs on cuda or cpu, not {p.device}")
    if not all(x.is_contiguous() for x in (p, g, m, v, sc)):
        raise ValueError("fused_adamw inputs must be contiguous")
    n = int(p.shape[0])
    po, mo, vo = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
    if n == 0:
        return po, mo, vo
    bufs = (p, g, m, v, po, mo, vo)
    vectorized = all(x.data_ptr() % _VECTOR_ALIGN[x.dtype] == 0 for x in bufs)
    lib = _load()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rc = lib.fused_adamw_launch(
        _DTYPE_CODE[p.dtype], p.data_ptr(), g.data_ptr(), m.data_ptr(),
        v.data_ptr(), sc.data_ptr(), po.data_ptr(), mo.data_ptr(), vo.data_ptr(),
        n, int(vectorized), float(eps), float(wd), p.device.index, stream)
    if rc != 0:
        msg = lib.fused_adamw_error_string(rc).decode()
        raise kernel_build.KernelError(f"fused_adamw launch failed: {msg} ({rc})")
    fused_adamw.launches += 1
    return po, mo, vo


#: kernel launches since the last reset (``fused_adamw.launches = 0``).
fused_adamw.launches = 0
