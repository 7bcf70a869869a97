"""Flash-attention kernel wrapper: blocked online-softmax attention with
GQA/MQA, causal and sliding-window masks as ONE CUDA kernel launch.

The counterpart of ``src/repro/kernels/flash_attention.py``.  The kernel
(``csrc/flash_attention.cu``) reads q (B, Hq, Sq, D) and k, v (B, Hkv, Sk,
D) in float32 or bfloat16 through their strides (the last dimension must be
contiguous, so the model's head-split views need no copy), keeps the
(m, l, acc) state in float32 and writes a fresh contiguous output in q's
dtype.  It masks ragged Sq and Sk itself (the reference asserts that they
divide its blocks) and takes head dims up to 256.

The kernel has two variants (see the note in the source).  ``tc`` runs both
products on the tensor cores (``wgmma``, bfloat16 in, float32 sums) with a
TMA ring of K/V tiles; ``simt`` runs them on the CUDA cores in float32 and
is exact to float32 rounding.  One rule, ``_variant``, picks the variant.
``_attention(..., variant="simt")``, which the public function does not
expose, forces the CUDA-core variant on inputs the rule sends to ``tc``, so
that the two can be timed on the same inputs.

Built with ``nvcc`` for ``sm_90a`` at first use (``kernels/build.py``),
bound with ``ctypes`` and launched on PyTorch's current stream.  A tensor on
the CPU takes the plain version (``kernels/ref.py::attention_ref``); a CUDA
tensor launches a variant of the kernel or raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as kernel_build
from repro_torch.kernels.ref import attention_ref

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _configure(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = [
        ctypes.c_int, *([ctypes.c_void_p] * 4), *([ctypes.c_int] * 6),
        *([ctypes.c_longlong] * 9), ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_tc_launch.argtypes = lib.flash_attention_launch.argtypes[1:]
    lib.flash_attention_tc_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, Hq, Sq, D) and k, v one (B, Hkv, Sk, D); got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] == 0 or Hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and head "
                         "dim must match and Hq be a multiple of Hkv")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} lies on {x.device}, q on {q.device}")


def _variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel variant that takes these inputs: ``"tc"`` (tensor cores)
    when q, k and v are bfloat16, the head dim D is a multiple of 16 (whole
    k16 steps of the products) and at most 256, Sk >= 1, and TMA can
    describe every tensor: a 16-byte aligned base and, for each dimension
    longer than 1 but the last (which is contiguous), a stride that is a
    multiple of 8 elements (16 bytes); ``"simt"`` (CUDA cores, float32
    products) otherwise.  Reads only dtypes, shapes, strides and addresses,
    so CPU and meta tensors answer as CUDA ones would."""
    D, Sk = q.shape[3], k.shape[2]
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)) or D % 16 or D > MAX_HEAD_DIM \
            or Sk < 1:
        return "simt"
    for x in (q, k, v):
        if x.data_ptr() % 16:
            return "simt"
        if any(n > 1 and st % 8 for n, st in zip(x.shape[:3], x.stride()[:3])):
            return "simt"
    return "tc"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Softmax attention of q over k, v with kv head = q head // (Hq / Hkv):
    ``softmax(q k^T * sm_scale, masked) v`` (``sm_scale`` defaults to
    D**-0.5; ``window`` keeps keys with k > q - window).  Returns (B, Hq, Sq,
    D) in q's dtype.  CPU tensors take the plain version; CUDA tensors launch
    the variant ``_variant`` picks.  ``flash_attention.launches`` counts all
    launches, ``flash_attention.variant_launches`` each variant's."""
    return _attention(q, k, v, causal=causal, window=window, sm_scale=sm_scale)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
               window: int | None = None, sm_scale: float | None = None,
               variant: str | None = None) -> torch.Tensor:
    """``flash_attention``, with ``variant="simt"`` forcing the CUDA-core
    variant on a CUDA tensor (for timing it beside ``tc``; never by
    default)."""
    _check(q, k, v)
    if variant not in (None, "simt"):
        raise ValueError(f"variant must be None or 'simt', not {variant!r}")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: the kernel takes "
                        "float32 or bfloat16, all of one dtype")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    if any(x.stride(3) != 1 for x in (q, k, v) if x.numel()):
        raise ValueError("the last dimension of q, k and v must be contiguous")
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    chosen = variant or _variant(q, k, v)
    lib = kernel_build.load(SOURCE, _configure)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window is not None), int(window or 0), float(sm_scale),
            q.device.index, stream)
    if chosen == "tc":
        rc = lib.flash_attention_tc_launch(*args)
    else:
        rc = lib.flash_attention_launch(_DTYPE_CODE[q.dtype], *args)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise kernel_build.KernelError(f"flash_attention ({chosen}) launch failed: {msg} ({rc})")
    flash_attention.launches += 1
    flash_attention.variant_launches[chosen] += 1
    return out


def reset_counts() -> None:
    """Set the total and the per-variant launch counts to 0."""
    flash_attention.launches = 0
    flash_attention.variant_launches = {"tc": 0, "simt": 0}


#: kernel launches since the last reset, in all and per variant.
reset_counts()
