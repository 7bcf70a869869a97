"""Shared building blocks: norms, embeddings, rotary position encodings.

The counterpart of ``src/repro/models/layers.py``: standard RoPE and
Qwen2-VL's multimodal M-RoPE, and the vocabulary-parallel embedding
lookup of tensor parallelism.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.models import tensor_parallel
from repro_torch.models.config import ModelConfig


#: elements drawn at once by ``normal``: a leaf past this is drawn in slices
#: along its first axis, so the float32 temporary stays at most 256 MB
#: (granite-34b's stacked MLP leaf would otherwise need a 53 GB one).
DRAW_ELEMENTS = 1 << 26

_draw_hook = None


@contextlib.contextmanager
def drawing(hook):
    """Install ``hook`` for the ``with`` block: every ``normal`` call
    inside returns ``hook(shape, draw)``, where ``draw(cut)`` makes the leaf
    as ``normal`` would, or with ``cut = (dim, index, size)`` only its
    ``torch.chunk(leaf, size, dim)[index]``, from the same draws in the same
    order (``weights.init_slices``).  One init at a time: the hook is
    process-wide."""
    global _draw_hook
    prev, _draw_hook = _draw_hook, hook
    try:
        yield
    finally:
        _draw_hook = prev


def normal(shape: tuple[int, ...], scale: float, dtype: torch.dtype,
           generator: torch.Generator | None, device: torch.device | str) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32, then cast (as the JAX init does),
    into a leaf allocated once in ``dtype``; a leaf of more than
    ``DRAW_ELEMENTS`` is drawn in slices of its first axis.  On the ``meta``
    device only shape and dtype are made.  Under ``drawing`` the hook
    decides what is kept."""
    def draw(cut=None):
        return _draw(tuple(shape), scale, dtype, generator, device, cut)
    return draw() if _draw_hook is None else _draw_hook(tuple(shape), draw)


def _draw(shape, scale, dtype, generator, device, cut) -> torch.Tensor:
    """``normal``'s leaf, or its chunk ``cut = (dim, index, size)``: every
    first-axis piece is drawn whole, so the generator advances as for the
    whole leaf, and only the chunk's part of it is kept."""
    dim, lo, hi = 0, 0, shape[0] if shape else 1
    if cut is not None:
        dim, index, size = cut
        step = -(-shape[dim] // size)                 # torch.chunk's cut
        lo = min(index * step, shape[dim])
        hi = min(lo + step, shape[dim])
    kept = list(shape)
    if shape:
        kept[dim] = hi - lo
    out = torch.empty(kept, dtype=dtype, device=device)
    if out.device.type == "meta" or math.prod(shape) == 0:
        return out
    if not shape:
        return out.copy_(torch.randn((), generator=generator, dtype=torch.float32,
                                        device=device).mul_(scale))
    row = max(math.prod(shape[1:]), 1)
    step = max(DRAW_ELEMENTS // row, 1)
    for i in range(0, shape[0], step):
        n = min(step, shape[0] - i)
        x = torch.randn((n, *shape[1:]), generator=generator, dtype=torch.float32,
                        device=device).mul_(scale)
        if dim:
            out[i:i + n].copy_(x.narrow(dim, lo, hi - lo))
        elif max(i, lo) < min(i + n, hi):
            a, b = max(i, lo), min(i + n, hi)
            out[a - lo:b - lo].copy_(x[a - i:b - i])
        del x                              # before the next piece is drawn
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(ms + eps)) * w.to(torch.float32)).to(x.dtype)


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings.  Under tensor parallelism (a ``"model"`` slice
    of the table's rows, ``models.tensor_parallel``) each rank looks up the
    tokens its rows hold, zeros elsewhere, and the float32 rows are summed
    over the group: exact, as one rank holds each token."""
    mg = tensor_parallel.current()
    if mg is not None and embedding.shape[0] != cfg.padded_vocab:
        rows = embedding.shape[0]
        ids = tokens - mg.index * rows
        mine = (ids >= 0) & (ids < rows)
        part = embedding[torch.where(mine, ids, 0)] * mine[..., None].to(embedding.dtype)
        x = mg.exit(part).to(cfg.dtype)
    else:
        x = embedding[tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # the scale is rounded to the model dtype first, as jnp.asarray does
        scale = torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype).item()
        x = x * scale
    return x


def unembed(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    return x @ head.to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                        # (d/2,)
    ang = positions[:, None, :, None].to(torch.float32) * freqs   # (B,1,S,d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL's multimodal rotary.  x: (B, H, S, D); positions: (3, B, S)
    integer, the t/h/w streams.  The D/2 frequency bands split into
    ``sections`` (one per stream, in order) and each band rotates by its
    own stream's position, in float32 as ``apply_rope``.  With three equal
    streams (text) it is ``apply_rope``."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(d, theta, x.device)                        # (half,)
    sec_ids = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device), output_size=half)   # stream per band
    pos = positions[sec_ids].permute(1, 2, 0).to(torch.float32)   # (B, S, half)
    ang = pos[:, None] * freqs                                    # (B,1,S,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
