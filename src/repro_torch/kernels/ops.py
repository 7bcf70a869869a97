"""Public wrappers of the port's kernels under the reference's names and
keyword arguments: the counterpart of ``src/repro/kernels/ops.py``.

CUDA tensors launch the hand-written kernels; CPU tensors take their plain
versions (the port has no interpret mode).  ``block_q``, ``block_k``,
``block`` and ``row_block`` are the reference's tiling hints: accepted, and
they change no value (each kernel picks its own tiles).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_adamw as _adamw
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels.split_pipeline import split_pipeline

__all__ = ["flash_attention", "fused_adamw", "rmsnorm", "split_pipeline"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    sm_scale: float | None = None, block_q: int = 256,
                    block_k: int = 256) -> torch.Tensor:
    """Blocked softmax attention, q (B, Hq, Sq, D) over k, v (B, Hkv, Sk, D)."""
    del block_q, block_k                  # tiling hints: the kernel's tiles are fixed
    return _flash.flash_attention(q, k, v, causal=causal, window=window, sm_scale=sm_scale)


def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
                lr, b1: float, b2: float, eps: float, wd: float, step,
                grad_scale=1.0, block: int = 64 * 1024):
    """One AdamW step on a flat (N,) leaf; ``step`` is the 1-based count.
    Returns new (p, m, v)."""
    del block                             # tiling hint
    step = torch.as_tensor(step, device=p.device)
    sc = _adamw.scalar_row(lr, b1, b2, step, grad_scale)
    return _adamw.fused_adamw(p, g, m, v, sc, eps=eps, wd=wd)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            row_block: int = 256) -> torch.Tensor:
    """RMSNorm over the last axis of x (..., d) with weight w (d,)."""
    del row_block                         # tiling hint: the kernel runs one row per CTA
    return _rmsnorm.rmsnorm(x, w, eps=eps)
