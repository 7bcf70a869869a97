"""Attention: the counterpart of ``src/repro/models/attention.py``.

Four execution paths for train and prefill, chosen in the reference's
order: the flash-attention kernel (``kernels/flash_attention.py``, the
counterpart of the reference's Pallas switch) when ``use_kernel`` holds,
else the banded O(S·w) sliding window for a ``banded_attention`` config
(``_banded_attention``), else dense softmax up to
``cfg.dense_attn_threshold`` keys, else blocked attention with an online
softmax over key blocks whose scores are recomputed in backward.  Scores,
softmax and the probability-value product accumulate in float32
(``preferred_element_type=f32`` in the reference); a logit softcap
``tanh(s / c) * c`` applies to the float32 scores before masking on every
path but the kernel's.  An encoder-decoder's cross-attention always takes
the dense path, as the reference's.

Decode uses the reference's block-partitioned KV cache ``(n_blk, blk, B,
Hkv, D)``: each block computes a local partial softmax (log-sum-exp form)
and the partials combine exactly.  Unlike the reference, whose arrays are
immutable, the port writes K/V into the cache's storage IN PLACE
(``cache_fill_prefill``, ``cache_update_decode``): the returned cache shares
``k``/``v`` with the one passed in and carries new ``length``/``start``, so
a caller keeps only the returned cache.  This saves a copy of the whole
cache per layer and step.

Under tensor parallelism (``models.tensor_parallel``) a layer whose
``wq`` is a ``"model"`` slice by heads runs its rank's query heads
(``_qkv_tp``) on any of the paths above and its ``wo`` rows as a partial
sum, all-reduced over the group.  In prefill and decode the KV cache is
this rank's piece as ``launch.shardings.cache_specs`` places it: with
``kv_cache_blocks`` a multiple of the ``"model"`` extent, rank ``m`` holds
the blocks of positions ``[m·span, (m+1)·span)`` of EVERY KV head
(``_kv_group``).  Prefill writes only its own block
(``_fill_cache``: K and V that are a slice by heads are exchanged,
all-to-all, into blocks); decode (``_decode``) gathers q over the
group where the heads are split, computes the partial softmax of its own
blocks for all heads, gathers the partials and combines them exactly in
block order, then keeps its heads' output for ``wo``; the new token's K/V
row is written by the rank whose block holds position ``length``.  The
reference's sequence-parallel decode is the same LSE combine, rendered by
GSPMD.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import data_parallel, tensor_parallel
from repro_torch.models.config import AttnConfig, ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope, normal, rms_norm

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (n_blk, blk, B, Hkv, D)
    v: torch.Tensor
    #: tokens stored: () int32, one timeline for every row (train and
    #: fixed-group serving), or (B,) int32, one position per row
    #: (continuous batching).  Decode inserts at ``length`` and attends
    #: ``[start, length)``.
    length: torch.Tensor
    #: (B,) int32 first valid position per row (the left-pad width after a
    #: left-padded prefill, else zeros).
    start: torch.Tensor


def init_attn(cfg: ModelConfig, generator: torch.Generator | None,
              device: torch.device | str, n_layers: int | None) -> dict:
    """Stacked ``(L, in, out)`` projections, used as ``x @ W``; with qk-norm
    also the stacked ``(L, head_dim)`` float32 scales ``q_norm``/``k_norm``.
    ``n_layers=None`` gives one layer's, unstacked."""
    a = cfg.attn
    d = cfg.d_model
    hq, hkv, hd = a.n_heads, a.n_kv_heads, a.head_dim
    scale = d ** -0.5
    lead = () if n_layers is None else (n_layers,)
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d)}
    p = {k: normal((*lead, *s), scale, cfg.dtype, generator, device)
         for k, s in shapes.items()}
    if a.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=torch.float32, device=device)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, hd).transpose(1, 2)           # (B, H, S, D)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _qkv(p, x: torch.Tensor, a: AttnConfig, positions: torch.Tensor, cfg: ModelConfig):
    q = _split_heads(x @ p["wq"].to(x.dtype), a.n_heads, a.head_dim)
    k = _split_heads(x @ p["wk"].to(x.dtype), a.n_kv_heads, a.head_dim)
    v = _split_heads(x @ p["wv"].to(x.dtype), a.n_kv_heads, a.head_dim)
    if a.qk_norm:                        # per head, before RoPE (the reference's)
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if a.mrope:                          # (3, B, S) streams; 2-D: three equal ones
        pos3 = positions if positions.dim() == 3 else positions.expand(3, *positions.shape)
        q = apply_mrope(q, pos3, a.rope_theta, a.mrope_sections)
        k = apply_mrope(k, pos3, a.rope_theta, a.mrope_sections)
    else:
        pos = positions if positions.dim() == 2 else positions[0]
        q = apply_rope(q, pos, a.rope_theta)
        k = apply_rope(k, pos, a.rope_theta)
    return q, k, v


def _qkv_tp(p, x: torch.Tensor, a: AttnConfig, positions: torch.Tensor | None,
            cfg: ModelConfig, mg, cross_kv=None):
    """``_qkv`` on this rank's query heads (``wq`` a ``"model"`` slice by
    heads, ``models.tensor_parallel``).  K and V come by heads too where
    ``wk``/``wv`` are sliced (multi-head attention); else they are computed
    whole from the replicated ``x`` and enter the rank-local compute.
    ``cross_kv`` is an encoder-decoder's, already in that form
    (``transformer._cross_kv_per_layer``).  ``_per_query_kv`` pairs the
    local query heads with their KV heads."""
    hd = a.head_dim
    hq = p["wq"].shape[-1] // hd                 # this rank's query heads
    xin = mg.enter(x)
    q = _split_heads(xin @ p["wq"].to(x.dtype), hq, hd)
    if cross_kv is not None:
        k, v = cross_kv
    else:
        kv_split = p["wk"].shape[-1] != a.n_kv_heads * hd
        src = xin if kv_split else x
        nkv = p["wk"].shape[-1] // hd
        k = _split_heads(src @ p["wk"].to(x.dtype), nkv, hd)
        v = _split_heads(src @ p["wv"].to(x.dtype), nkv, hd)
        if a.qk_norm:
            q = rms_norm(q, mg.enter(p["q_norm"]), cfg.norm_eps)
            k = rms_norm(k, mg.enter(p["k_norm"]) if kv_split else p["k_norm"],
                         cfg.norm_eps)
        if a.mrope:
            pos3 = positions if positions.dim() == 3 else positions.expand(3, *positions.shape)
            q = apply_mrope(q, pos3, a.rope_theta, a.mrope_sections)
            k = apply_mrope(k, pos3, a.rope_theta, a.mrope_sections)
        else:
            pos = positions if positions.dim() == 2 else positions[0]
            q = apply_rope(q, pos, a.rope_theta)
            k = apply_rope(k, pos, a.rope_theta)
        if not kv_split:
            k, v = mg.enter(k), mg.enter(v)
    return q, k, v


def _per_query_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mg):
    """K and V of ``_qkv_tp`` for each of this rank's query heads: its own
    KV head (``h % Hkv`` of its global index ``h``, as
    ``_dense_attention``'s (group, Hkv) reshape pairs them) where K and V
    are not this rank's heads already."""
    hq = q.shape[1]
    if k.shape[1] == hq:
        return k, v
    idx = (mg.index * hq + torch.arange(hq, device=q.device)) % k.shape[1]
    return k[:, idx], v[:, idx]


def _visible(q_ids: torch.Tensor, k_ids: torch.Tensor, causal: bool,
             window: int | None) -> torch.Tensor:
    m = torch.ones(torch.broadcast_shapes(q_ids.shape, k_ids.shape),
                   dtype=torch.bool, device=q_ids.device)
    if causal:
        m = m & (q_ids >= k_ids)
    if window is not None:
        m = m & (k_ids > q_ids - window)
    return m


def _capped(s: torch.Tensor, softcap: float | None) -> torch.Tensor:
    """The reference's logit softcap on float32 scores (None: ``s``)."""
    return s if softcap is None else torch.tanh(s / softcap) * softcap


def _dense_attention(q, k, v, *, causal: bool, window: int | None, offset: int = 0,
                     kv_len: int | None = None, softcap: float | None = None,
                     kv_mask: torch.Tensor | None = None):
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qs = (q * D ** -0.5).to(q.dtype)
    s = _capped(torch.einsum("bghqd,bhkd->bghqk",
                             qs.reshape(B, group, Hkv, Sq, D).to(torch.float32),
                             k.to(torch.float32)), softcap)
    dev = q.device
    k_ids = torch.arange(Sk, device=dev)[None, :]
    m = _visible(torch.arange(Sq, device=dev)[:, None] + offset, k_ids, causal, window)
    if kv_len is not None:
        m = m & (k_ids < kv_len)
    if kv_mask is not None:              # (B, Sk): pad keys drop per row
        m = (m[None] & kv_mask.to(torch.bool)[:, None, :])[:, None, None]
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bghqk,bhkd->bghqd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def _blocked_attention(q, k, v, *, causal: bool, window: int | None, block_k: int,
                       softcap: float | None = None, kv_mask: torch.Tensor | None = None):
    """Online softmax over key blocks, O(block) scores; while autograd
    records, each block's step is checkpointed so backward recomputes its
    scores (flash-style)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    nk = -(-Sk // block_k)
    pad = nk * block_k - Sk
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qs = (q * D ** -0.5).to(q.dtype).reshape(B, group, Hkv, Sq, D).to(torch.float32)
    q_ids = torch.arange(Sq, device=q.device)[:, None]
    # per-row pad keys, padded to whole blocks: (B, nk * block_k)
    kmp = (None if kv_mask is None
           else torch.nn.functional.pad(kv_mask.to(torch.bool), (0, pad)))

    def step(m_prev, l_prev, acc, kblk, vblk, idx: int):
        s = _capped(torch.einsum("bghqd,bhkd->bghqk", qs, kblk.to(torch.float32)),
                    softcap)
        k_ids = idx * block_k + torch.arange(block_k, device=q.device)[None, :]
        msk = _visible(q_ids, k_ids, causal, window) & (k_ids < Sk)
        if kmp is not None:              # (B, Sq, blk)
            blk = kmp[:, idx * block_k:(idx + 1) * block_k]
            msk = (msk[None] & blk[:, None, :])[:, None, None]
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
    recording = torch.is_grad_enabled()
    for i in range(nk):
        blk = slice(i * block_k, (i + 1) * block_k)
        args = (m, l, acc, kp[:, :, blk], vp[:, :, blk], i)
        m, l, acc = (checkpoint(step, *args, use_reentrant=False) if recording
                     else step(*args))
    safe = torch.where(l == 0, 1.0, l)
    return (acc / safe).reshape(B, Hq, Sq, D).to(q.dtype)


def _banded_attention(q, k, v, *, window: int, softcap: float | None = None):
    """Exact causal sliding-window self-attention in O(S·w): queries in
    blocks of ``w`` attend only their own and the previous key block (keys
    in (i - w, i] lie in those two blocks); the padding keys of block -1 and
    of the tail are masked by their global positions."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    assert Sq == Sk, "banded path is for self-attention (train/prefill)"
    group = Hq // Hkv
    w = int(window)
    nb = -(-Sq // w)
    pad = nb * w - Sq
    F = torch.nn.functional
    qb, kb, vb = (F.pad(t, (0, 0, 0, pad)).reshape(B, t.shape[1], nb, w, D)
                  for t in (q, k, v))
    # (B, Hkv, nb, 2w, D): block n's keys are block n-1's then its own
    k2, v2 = (torch.cat([F.pad(t, (0, 0, 0, 0, 1, 0))[:, :, :-1], t], dim=3)
              for t in (kb, vb))
    qs = (qb * D ** -0.5).to(q.dtype).reshape(B, group, Hkv, nb, w, D)
    s = _capped(torch.einsum("bghnqd,bhnkd->bghnqk", qs.to(torch.float32),
                             k2.to(torch.float32)), softcap)
    # global positions: query i of block n is n*w + i, key j is (n-1)*w + j
    dev = q.device
    m = _visible(torch.arange(w, device=dev)[:, None] + w,
                 torch.arange(2 * w, device=dev)[None, :], True, w)
    kg = ((torch.arange(nb, device=dev)[:, None] - 1) * w
          + torch.arange(2 * w, device=dev)[None, :])
    mask = m[None] & ((kg >= 0) & (kg < Sq))[:, None, :]          # (nb, w, 2w)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    o = torch.einsum("bghnqk,bhnkd->bghnqd", p.to(v2.dtype).to(torch.float32),
                     v2.to(torch.float32))
    return o.reshape(B, Hq, nb * w, D)[:, :, :Sq].to(q.dtype)


def _decode_partials(q: torch.Tensor, cache: KVCache, *, window: int | None = None,
                     softcap: float | None = None, first_block: int = 0):
    """The partial softmax of one-token decode over each block of
    ``cache``, whose first block is block ``first_block`` of the whole
    cache (its positions start at ``first_block * blk``): (m, l, o) per
    (block, row, group, KV head), float32, (n_blk, B, g, Hkv, 1 | 1 | D)."""
    B, Hq, _, D = q.shape             # Sq == 1
    n_blk, blk = cache.k.shape[0], cache.k.shape[1]
    Hkv = cache.k.shape[3]
    group = Hq // Hkv
    qs = (q * D ** -0.5).to(cache.k.dtype).reshape(B, group, Hkv, D)
    # scores per block: (n_blk, B, group, Hkv, blk)
    s = _capped(torch.einsum("bghd,nkbhd->nbghk", qs.to(torch.float32),
                             cache.k.to(torch.float32)), softcap)
    # validity per (block, row, offset): rows may sit at different positions
    # (per-slot ``length``) and may start past 0 (left-pad ``start``)
    pos = (first_block * blk + torch.arange(n_blk * blk, device=q.device)).reshape(n_blk, 1, blk)
    length = cache.length
    lb = length[None, :, None] if length.dim() else length
    valid = pos < lb
    if window is not None:
        valid = valid & (pos > lb - 1 - window)
    start = cache.start
    if start.shape[0] != B:          # every data row's, as cache_specs replicates it
        start = data_parallel.current().local_rows(start)
    valid = valid & (pos >= start[None, :, None])
    valid = valid.expand(n_blk, B, blk)[:, :, None, None, :]
    s = torch.where(valid, s, NEG_INF)

    m_blk = torch.amax(s, dim=-1, keepdim=True)                   # (n,B,g,h,1)
    p = torch.where(valid, torch.exp(s - m_blk), 0.0)
    l_blk = torch.sum(p, dim=-1, keepdim=True)
    o_blk = torch.einsum("nbghk,nkbhd->nbghd", p.to(cache.v.dtype).to(torch.float32),
                         cache.v.to(torch.float32))
    return m_blk, l_blk, o_blk


def _combine_partials(m_blk: torch.Tensor, l_blk: torch.Tensor, o_blk: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The exact LSE combine of every block's partial: (B, Hq, 1, D)."""
    _n, B, group, Hkv, D = o_blk.shape
    m = torch.amax(m_blk, dim=0, keepdim=True)                    # global max
    w = torch.exp(m_blk - m)                                      # (n,B,g,h,1)
    l = torch.sum(l_blk * w, dim=0)                               # (B,g,h,1)
    o = torch.sum(o_blk * w, dim=0)                               # (B,g,h,D)
    safe = torch.where(l == 0, 1.0, l)
    return (o / safe).reshape(B, group * Hkv, 1, D).to(dtype)


def _decode_attention_blocked(q: torch.Tensor, cache: KVCache, *,
                              window: int | None = None,
                              softcap: float | None = None) -> torch.Tensor:
    """One-token decode over the block-partitioned cache with exact LSE
    combination across blocks."""
    return _combine_partials(*_decode_partials(q, cache, window=window, softcap=softcap),
                             q.dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, per_slot: bool = False,
                  device: torch.device | str = "cuda") -> KVCache:
    a = cfg.attn
    n_blk = max(cfg.kv_cache_blocks, 1)
    blk = -(-max_len // n_blk)
    shape = (n_blk, blk, batch, a.n_kv_heads, a.head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        # per_slot: every row tracks its own position (continuous batching)
        length=torch.zeros((batch,) if per_slot else (), **i32),
        start=torch.zeros((batch,), **i32))


def cache_update_decode(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                        group=None) -> KVCache:
    """Write one token (S == 1) at position ``length`` (per row if (B,)),
    in place; returns the cache with ``length + 1``.  With ``group`` (the
    ``"model"`` group the cache's blocks are split over, ``_kv_group``)
    ``cache`` is this rank's blocks and only the rank holding position
    ``length`` writes, without a host read (one timeline: ``transformer``
    refuses per-slot lengths under a group)."""
    n_blk, blk = cache.k.shape[0], cache.k.shape[1]
    pos = cache.length
    rows_k = k_new[:, :, 0].to(cache.k.dtype)                     # (B, Hkv, D)
    rows_v = v_new[:, :, 0].to(cache.v.dtype)
    if pos.dim():
        # Per-slot positions: each row writes its own (block, offset).  A row
        # past capacity (an idle slot of a rolling batch) writes nothing, as
        # the reference's ``mode="drop"`` scatter: it is aimed at the last
        # position and writes back what is there.  No host read of ``pos``.
        cap = n_blk * blk
        live = pos < cap
        at = torch.where(live, pos, cap - 1).long()
        bi, off = at // blk, at % blk
        rows = torch.arange(pos.shape[0], device=pos.device)
        keep = live[:, None, None]
        for buf, new in ((cache.k, rows_k), (cache.v, rows_v)):
            buf[bi, off, rows] = torch.where(keep, new, buf[bi, off, rows])
        return cache._replace(length=pos + 1)
    # one timeline: the (B, Hkv, D) slab at (block, offset) of the whole
    # cache, whose blocks before ``first`` other ranks hold; a block index
    # past the end is clamped (``dynamic_update_slice``)
    first, total = (0, n_blk) if group is None else (group.index * n_blk, group.size * n_blk)
    bi = torch.clamp(pos // blk, max=total - 1).long().reshape(1) - first
    off = (pos % blk).long().reshape(1)
    for buf, new in ((cache.k, rows_k), (cache.v, rows_v)):
        if group is None:                # this rank holds every block
            buf[bi, off] = new[None]
        else:
            mine = (bi >= 0) & (bi < n_blk)
            at = torch.clamp(bi, 0, n_blk - 1)
            buf[at, off] = torch.where(mine, new[None], buf[at, off])
    return cache._replace(length=pos + 1)


def cache_fill_prefill(cache: KVCache, k_full: torch.Tensor, v_full: torch.Tensor,
                       pad_mask: torch.Tensor | None = None,
                       length: int | None = None) -> KVCache:
    """Write a full prefill (B, Hkv, S, D) into the blocked cache, in place
    (positions past S are zeroed, as the reference's padded copy).

    ``pad_mask`` (B, S) bool, True = real token: rows record where their
    valid span begins (``start``, the left-pad width) and, for a cache with
    per-slot lengths, where it ends (right-padded rows stop at their true
    prompt length).  A scalar-length cache keeps ``length = S`` and can
    therefore only mask LEFT pads.  ``length`` (no pad mask) overrides S as
    the tokens stored: the prompt's length where ``cache`` is one rank's
    blocks of it (``_fill_cache``)."""
    n_blk, blk = cache.k.shape[0], cache.k.shape[1]
    B, Hkv, S, D = k_full.shape
    if S > n_blk * blk:
        raise ValueError(f"prefill of {S} positions into a cache of {n_blk * blk}")
    for buf, new in ((cache.k, k_full), (cache.v, v_full)):
        flat = buf.view(n_blk * blk, B, Hkv, D)
        flat[:S] = new.permute(2, 0, 1, 3)
        flat[S:] = 0
    i32 = dict(dtype=torch.int32, device=k_full.device)
    S = S if length is None else length
    if pad_mask is None:
        start = torch.zeros_like(cache.start)
        end = torch.full((B,), S, **i32)
    else:
        real = pad_mask.to(torch.bool)
        idx = torch.arange(S, **i32)[None, :]
        start = torch.amin(torch.where(real, idx, S), dim=1).to(torch.int32)
        end = (torch.amax(torch.where(real, idx, -1), dim=1) + 1).to(torch.int32)
    length = end if cache.length.dim() else torch.tensor(S, **i32)
    return KVCache(cache.k, cache.v, length, start)


def _kv_group(cache: KVCache | None, cfg: ModelConfig):
    """The ``"model"`` group whose ranks each hold a sequence block of the
    KV cache (``launch.shardings.cache_specs``: ``kv_cache_blocks`` a
    multiple of the extent), or None where ``cache`` is whole."""
    mg = tensor_parallel.current()
    n_blk = max(cfg.kv_cache_blocks, 1)
    if mg is None or cache is None or cache.k.shape[0] == n_blk:
        return None
    if cache.k.shape[0] * mg.size != n_blk:
        raise ValueError(f"a KV cache of {cache.k.shape[0]} blocks on each of {mg.size} "
                         f"\"model\" ranks for kv_cache_blocks {n_blk}")
    return mg


def _fill_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                mg, pad_mask: torch.Tensor | None) -> KVCache:
    """Prefill's cache fill, under the ``"model"`` group ``mg`` where it is
    not None: ``k`` and ``v`` (B, Hk, S, D) are every KV head, or this
    rank's where they are a slice by heads.  A cache of sequence blocks
    takes only this rank's positions of every head: cut from whole K and
    V, or exchanged from the other ranks' heads (all-to-all: each rank
    sends each other rank only that rank's block of its heads); a whole
    cache gathers the heads."""
    a = cfg.attn
    D = k.shape[-1]
    S = k.shape[2]
    split = k.shape[1] != a.n_kv_heads
    cg = _kv_group(cache, cfg)
    if cg is None:
        if split:
            k, v = mg.gather(torch.cat([k, v], -1), 1, "kv_heads").split(D, -1)
        return cache_fill_prefill(cache, k, v, pad_mask=pad_mask)
    span = cache.k.shape[0] * cache.k.shape[1]
    if S > span * cg.size:
        raise ValueError(f"prefill of {S} positions into a cache of {span * cg.size}")
    kv = torch.nn.functional.pad(torch.cat([k, v], -1), (0, 0, 0, span * cg.size - S))
    if split:
        kv = cg.exchange(kv, 2, 1, "kv_blocks")            # (B, Hkv, span, 2D)
    else:
        kv = kv.narrow(2, cg.index * span, span)
    k, v = kv.split(D, -1)
    return cache_fill_prefill(cache, k, v, length=S)


def _decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: KVCache,
            cfg: ModelConfig, mg, heads, window: int | None):
    """One decode step's cache write and attention, under the ``"model"``
    group ``mg`` where it is not None: ``q`` is this rank's query heads
    where ``heads`` (the group, for a ``wq`` split by heads) else every
    one; ``k``/``v`` the new token's, every KV head or this rank's.  q, K
    and V go round in one gather where any is a slice; each rank computes
    the partial softmax of its blocks for every head, the partials are
    gathered and combined in block order, and this rank keeps its heads'
    output.  Returns (new cache, (B, Hq_local, 1, D))."""
    a = cfg.attn
    sliced = [t for t, cut in ((q, heads is not None), (k, k.shape[1] != a.n_kv_heads),
                               (v, v.shape[1] != a.n_kv_heads)) if cut]
    if sliced:                           # (M, B, heads, 1, D), then shard-major heads
        parts = mg.gather(torch.cat([t.to(q.dtype) for t in sliced], 1)[None], 0, "qkv_row")
        got = iter(t.transpose(0, 1).flatten(1, 2)
                   for t in parts.split([t.shape[1] for t in sliced], 2))
        q = next(got) if heads is not None else q
        k, v = (next(got), next(got)) if k.shape[1] != a.n_kv_heads else (k, v)
    cg = _kv_group(cache, cfg)
    new_cache = cache_update_decode(cache, k, v, cg)
    first = 0 if cg is None else cg.index * cache.k.shape[0]
    m, l, o = _decode_partials(q, new_cache, window=window, softcap=a.logit_softcap,
                               first_block=first)
    if cg is not None:
        D = o.shape[-1]
        m, l, o = cg.gather(torch.cat([m, l, o], -1), 0, "partials").split([1, 1, D], -1)
    out = _combine_partials(m, l, o, q.dtype)
    return new_cache, (out if heads is None else heads.local_rows(out, 1))


def _takes_kernel(use_kernel: bool | None, cfg: ModelConfig, q: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, pad_mask) -> bool:
    """The reference's switch (``use_pallas``, attention.py:406), taken only
    where the kernel computes the same function: no kv pad mask and no
    softcap (the reference's kernel call drops the cap; the port keeps a
    softcap layer off the kernel instead), and never while autograd records
    (the kernel has no backward).  A banded config takes it with its
    window, as the reference's does: the kernel's mask ``k > q - w`` is the
    banded path's function.  ``use_kernel=None`` means "the inputs lie on a
    CUDA device"; on CPU tensors the kernel's wrapper runs its plain
    version."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    recording = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return (use_kernel and pad_mask is None and cfg.attn.logit_softcap is None
            and not recording)


def _kernel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int | None) -> torch.Tensor:
    """The flash-attention kernel on the model's heads.  The kernel maps q
    head h to kv head h // group (the reference kernel's convention); the
    model's dense, blocked and decode paths map it to h % Hkv (their
    ``(group, Hkv)`` reshape).  q's heads go into the kernel's order and the
    output's come back: views for MHA and MQA, one copy each way for GQA."""
    from repro_torch.kernels.flash_attention import flash_attention
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    qk = q.reshape(B, group, Hkv, S, D).transpose(1, 2).reshape(B, Hq, S, D)
    o = flash_attention(qk, k, v, causal=causal, window=window)
    return o.reshape(B, Hkv, group, S, D).transpose(1, 2).reshape(B, Hq, S, D)


def attention_block(p, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor | None = None, causal: bool = True,
                    window: int | None = None, cache: KVCache | None = None,
                    mode: str = "train", use_kernel: bool | None = None,
                    pad_mask: torch.Tensor | None = None,
                    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Full attention sub-layer (B, S, d) -> (B, S, d).  Returns (out,
    new_cache | None).

    ``pad_mask`` (prefill/train, (B, S) bool, True = real token): pad keys
    are masked out of every query's softmax, and the prefill cache records
    each row's valid span so later decode steps skip the pad K/V too.

    ``cross_kv`` (an encoder-decoder's cross-attention): the given (B, Hkv,
    S_enc, D) K and V, q from ``wq`` without RoPE, on the plain dense path,
    non-causal, with no window and no cache in every mode, and the layer's
    logit softcap.  It never takes the kernel, as the reference's
    cross-attention never takes its Pallas switch."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"attention mode {mode!r}")
    a = cfg.attn
    B, S, _ = x.shape
    group = tensor_parallel.current()    # prefill and decode: the cache's group too
    mg = group
    if mg is None or p["wq"].shape[-1] == a.n_heads * a.head_dim:
        mg = None                        # whole heads: the single-device layer

    def out(o):                          # wo; row-parallel under a "model" group
        y = _merge_heads(o) @ p["wo"].to(x.dtype)
        return y if mg is None else mg.exit(y)

    if cross_kv is not None:
        if mg is None:
            q = _split_heads(x @ p["wq"].to(x.dtype), a.n_heads, a.head_dim)
            k, v = cross_kv
        else:
            q, k, v = _qkv_tp(p, x, a, None, cfg, mg, cross_kv)
            k, v = _per_query_kv(q, k, v, mg)
        o = _dense_attention(q, k, v, causal=False, window=None,
                             softcap=a.logit_softcap)
        return out(o), None
    if positions is None:
        if mode == "decode" and cache is not None:
            length = cache.length
            positions = (length[:, None] if length.dim()
                         else length.reshape(1, 1).expand(B, 1))
        else:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = (_qkv(p, x, a, positions, cfg) if mg is None
               else _qkv_tp(p, x, a, positions, cfg, mg))

    new_cache = None
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a KV cache")
        new_cache, o = _decode(q, k, v, cache, cfg, group, mg, window)
    else:
        if mode == "prefill" and cache is not None:
            new_cache = _fill_cache(cache, k, v, cfg, group, pad_mask)
        if mg is not None:
            k, v = _per_query_kv(q, k, v, mg)
        if _takes_kernel(use_kernel, cfg, q, k, v, pad_mask):
            o = _kernel_attention(q, k, v, causal=causal, window=window)
        elif (cfg.banded_attention and a.window and not a.pattern_period
              and causal and k.shape[2] == S and S > 2 * a.window
              and pad_mask is None):
            o = _banded_attention(q, k, v, window=a.window, softcap=a.logit_softcap)
        elif k.shape[2] <= cfg.dense_attn_threshold:
            o = _dense_attention(q, k, v, causal=causal, window=window,
                                 softcap=a.logit_softcap, kv_mask=pad_mask)
        else:
            o = _blocked_attention(q, k, v, causal=causal, window=window,
                                   block_k=cfg.attn_block_k, softcap=a.logit_softcap,
                                   kv_mask=pad_mask)
    return out(o), new_cache
