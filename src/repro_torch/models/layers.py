"""Shared building blocks: norms, embeddings, rotary position encodings.

The counterpart of ``src/repro/models/layers.py``: standard RoPE and
Qwen2-VL's multimodal M-RoPE.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


#: elements drawn at once by ``normal``: a leaf past this is drawn in slices
#: along its first axis, so the float32 temporary stays at most 256 MB
#: (granite-34b's stacked MLP leaf would otherwise need a 53 GB one).
DRAW_ELEMENTS = 1 << 26


def normal(shape: tuple[int, ...], scale: float, dtype: torch.dtype,
           generator: torch.Generator | None, device: torch.device | str) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32, then cast (as the JAX init does),
    into a leaf allocated once in ``dtype``; a leaf of more than
    ``DRAW_ELEMENTS`` is drawn in slices of its first axis.  On the ``meta``
    device only shape and dtype are made."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta" or out.numel() == 0:
        return out
    row = max(out[0].numel(), 1) if out.dim() else 1
    step = max(DRAW_ELEMENTS // row, 1) if out.dim() else 1
    for i in range(0, max(out.shape[0], 1) if out.dim() else 1, step):
        part = out[i:i + step] if out.dim() else out
        x = torch.randn(part.shape, generator=generator, dtype=torch.float32, device=device)
        part.copy_(x.mul_(scale))
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(ms + eps)) * w.to(torch.float32)).to(x.dtype)


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
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
