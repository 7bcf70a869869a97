"""Attention, train mode: the counterpart of ``src/repro/models/attention.py``.

Two paths, chosen by the key length as in the reference: dense softmax up
to ``cfg.dense_attn_threshold`` keys, else blocked attention with an online
softmax over key blocks whose scores are recomputed in backward.  Scores,
softmax and the probability-value product accumulate in float32
(``preferred_element_type=f32`` in the reference).  The KV cache, prefill
and decode wait for the serving slice.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import AttnConfig, ModelConfig
from repro_torch.models.layers import apply_rope, normal

NEG_INF = -1e30


def init_attn(cfg: ModelConfig, generator: torch.Generator | None,
              device: torch.device | str, n_layers: int) -> dict:
    """Stacked ``(L, in, out)`` projections, used as ``x @ W``."""
    a = cfg.attn
    d = cfg.d_model
    hq, hkv, hd = a.n_heads, a.n_kv_heads, a.head_dim
    scale = d ** -0.5
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d)}
    return {k: normal((n_layers, *s), scale, cfg.dtype, generator, device)
            for k, s in shapes.items()}


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, hd).transpose(1, 2)           # (B, H, S, D)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _qkv(p, x: torch.Tensor, a: AttnConfig, positions: torch.Tensor):
    q = _split_heads(x @ p["wq"].to(x.dtype), a.n_heads, a.head_dim)
    k = _split_heads(x @ p["wk"].to(x.dtype), a.n_kv_heads, a.head_dim)
    v = _split_heads(x @ p["wv"].to(x.dtype), a.n_kv_heads, a.head_dim)
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def _visible(q_ids: torch.Tensor, k_ids: torch.Tensor, causal: bool,
             window: int | None) -> torch.Tensor:
    m = torch.ones(torch.broadcast_shapes(q_ids.shape, k_ids.shape),
                   dtype=torch.bool, device=q_ids.device)
    if causal:
        m = m & (q_ids >= k_ids)
    if window is not None:
        m = m & (k_ids > q_ids - window)
    return m


def _dense_attention(q, k, v, *, causal: bool, window: int | None, offset: int = 0):
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qs = (q * D ** -0.5).to(q.dtype)
    s = torch.einsum("bghqd,bhkd->bghqk",
                     qs.reshape(B, group, Hkv, Sq, D).to(torch.float32),
                     k.to(torch.float32))
    dev = q.device
    m = _visible(torch.arange(Sq, device=dev)[:, None] + offset,
                 torch.arange(Sk, device=dev)[None, :], causal, window)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bghqk,bhkd->bghqd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def _blocked_attention(q, k, v, *, causal: bool, window: int | None, block_k: int):
    """Online softmax over key blocks, O(block) scores; each block's step
    is checkpointed so backward recomputes its scores (flash-style)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    nk = -(-Sk // block_k)
    pad = nk * block_k - Sk
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qs = (q * D ** -0.5).to(q.dtype).reshape(B, group, Hkv, Sq, D).to(torch.float32)
    q_ids = torch.arange(Sq, device=q.device)[:, None]

    def step(m_prev, l_prev, acc, kblk, vblk, idx: int):
        s = torch.einsum("bghqd,bhkd->bghqk", qs, kblk.to(torch.float32))
        k_ids = idx * block_k + torch.arange(block_k, device=q.device)[None, :]
        msk = _visible(q_ids, k_ids, causal, window) & (k_ids < Sk)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m_prev, torch.amax(s, dim=-1, keepdim=True))
        pexp = torch.where(msk, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m_prev - m_new)
        l_new = alpha * l_prev + torch.sum(pexp, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bghqk,bhkd->bghqd", pexp.to(vblk.dtype).to(torch.float32),
            vblk.to(torch.float32))
        return m_new, l_new, acc

    shape = (B, group, Hkv, Sq, 1)
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, group, Hkv, Sq, D), dtype=torch.float32, device=q.device)
    for i in range(nk):
        blk = slice(i * block_k, (i + 1) * block_k)
        m, l, acc = checkpoint(step, m, l, acc, kp[:, :, blk], vp[:, :, blk], i,
                               use_reentrant=False)
    safe = torch.where(l == 0, 1.0, l)
    return (acc / safe).reshape(B, Hq, Sq, D).to(q.dtype)


def attention_block(p, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor | None = None, causal: bool = True,
                    window: int | None = None, mode: str = "train") -> torch.Tensor:
    """Full attention sub-layer for teacher-forced training: (B, S, d) -> (B, S, d)."""
    if mode != "train":
        raise NotImplementedError(f"attention mode {mode!r}: the KV cache, "
                                  "prefill and decode wait for the serving slice")
    a = cfg.attn
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(p, x, a, positions)
    # The reference switches here (attention.py:406, ``use_pallas`` on a
    # TPU) to its flash-attention Pallas kernel; the port's Hopper kernel
    # for it comes with the serving slice (prefill).
    if k.shape[2] <= cfg.dense_attn_threshold:
        o = _dense_attention(q, k, v, causal=causal, window=window)
    else:
        o = _blocked_attention(q, k, v, causal=causal, window=window,
                               block_k=cfg.attn_block_k)
    return _merge_heads(o) @ p["wo"].to(x.dtype)
