"""Gradient compression with error feedback (int8 quantization): the
counterpart of ``src/repro/optim/compress.py``.

For cross-pod data parallelism the gradient all-reduce crosses the slow
inter-pod links; 4x compression (float32 -> int8 blocks of ``BLOCK`` with a
float32 scale per block) cuts that term of the roofline directly.  Error
feedback keeps the residual so the compression error does not bias
convergence (it is re-added next step).  As the reference does, this models
the numerics and counts the bytes; ``launch/train.py`` does not call it.

Gradients and residuals are dicts of tensors (flat ``{name: tensor}`` as
``optim.adamw`` uses, or nested).  ``torch.round`` rounds half to even, as
``jnp.round`` does, so codes, scales and residuals equal the reference's
bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

BLOCK = 2048


class CompressState(NamedTuple):
    residual: Any          # like grads, float32


def _map(fn: Callable, *trees):
    if hasattr(trees[0], "items"):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list[torch.Tensor]:
    if hasattr(tree, "items"):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def init(grads_like) -> CompressState:
    return CompressState(residual=_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def _f32(v: float, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


def _quantize(x: torch.Tensor):
    """(N,) float32 -> (int8 codes (blocks, BLOCK), float32 scales (blocks, 1))."""
    n = x.shape[0]
    pad = (-n) % BLOCK
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(-1, BLOCK)
    # a divisor on the tensor's device: CUDA turns a division by a Python
    # number into a product with its reciprocal, which rounds otherwise
    scale = torch.amax(torch.abs(xp), dim=1, keepdim=True) / _f32(127.0, x.device)
    safe = torch.where(scale == 0, 1.0, scale)
    codes = torch.clamp(torch.round(xp / safe), -127, 127).to(torch.int8)
    return codes, scale


def _dequantize(codes: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return (codes.to(torch.float32) * scale).reshape(-1)[:n]


def compress_decompress(g: torch.Tensor, residual: torch.Tensor):
    """One error-feedback round trip for a single tensor.  Returns (the
    decompressed gradient actually applied, float32; the new residual)."""
    flat = g.to(torch.float32).reshape(-1) + residual.reshape(-1)
    codes, scale = _quantize(flat)
    deq = _dequantize(codes, scale, flat.shape[0])
    return deq.reshape(g.shape), (flat - deq).reshape(g.shape)


def apply(grads, state: CompressState):
    """Compress and decompress every leaf (the all-reduce would move the
    int8 codes): ``(new grads, CompressState(new residuals))``."""
    outs = _map(compress_decompress, grads, state.residual)
    pick = lambda i: _map(lambda o: o[i], outs) if hasattr(outs, "items") else outs[i]
    return pick(0), CompressState(residual=pick(1))


def compressed_bytes(grads) -> int:
    total = 0
    for g in _leaves(grads):
        n = g.numel()
        total += n + -(-n // BLOCK) * 4          # int8 codes + float32 scales
    return total
