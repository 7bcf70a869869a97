"""Language-model training loss and greedy serving loop: the counterpart of
``src/repro/models/lm.py``."""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, z_loss: float = 1e-4):
    """Stable CE with optional z-loss.  logits (B,S,V), labels (B,S)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    loss = (lse - gold) + z_loss * torch.square(lse)
    if mask is not None:
        loss = loss * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = loss.numel()
    return torch.sum(loss) / denom


def make_batch_views(batch: dict[str, Any], cfg: ModelConfig):
    """Split a raw batch into model inputs + labels (next token) per
    family: an encoder-decoder's ``enc_embeds`` pass whole beside its
    tokens; an embedding-input batch (the vlm/audio stub frontends) feeds
    ``input_embeds`` and its ``positions`` (M-RoPE's (3, B, S + 1)) less
    the last position, with labels from its tokens."""
    kw: dict[str, Any] = {}
    tokens = batch["tokens"]
    if cfg.encdec:
        kw["enc_embeds"] = batch["enc_embeds"]
        kw["tokens"] = tokens[:, :-1]
    elif "input_embeds" in batch:
        kw["input_embeds"] = batch["input_embeds"][:, :-1]
        if "positions" in batch:
            kw["positions"] = batch["positions"][..., :-1]
    else:
        kw["tokens"] = tokens[:, :-1]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:]
    return kw, tokens[:, 1:], mask


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor | None = None, *,
                          chunk: int = 512, z_loss: float = 1e-4,
                          valid_vocab: int | None = None):
    """CE computed in sequence chunks so the (B, S, V) logits tensor is never
    materialized; each chunk's logits are recomputed in backward.  ``head``
    is (D, V), cast to the hidden dtype inside each chunk."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    V = head.shape[-1]

    def ce_of(h, l):
        lf = (h @ head.to(h.dtype)).to(torch.float32)
        if valid_vocab is not None and valid_vocab != V:
            lf = torch.where(torch.arange(V, device=lf.device) < valid_vocab,
                             lf, -1e30)
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, l[..., None].long())[..., 0]
        return (lse - gold) + z_loss * torch.square(lse)

    # full chunks, then the ragged tail (as the reference's map + tail)
    loss = torch.cat([checkpoint(ce_of, hidden[:, b:b + chunk],
                                 labels[:, b:b + chunk], use_reentrant=False)
                      for b in range(0, S, chunk)], dim=1)
    if mask is not None:
        loss = loss * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = loss.numel()
    return torch.sum(loss) / denom


def loss_fn(params, batch: dict[str, Any], cfg: ModelConfig,
            ce_chunk: int | None = None) -> torch.Tensor:
    kw, labels, mask = make_batch_views(batch, cfg)
    hidden, aux = tfm.forward_hidden(params, cfg, **kw)
    return chunked_cross_entropy(hidden, tfm._head(params, cfg), labels, mask,
                                 chunk=ce_chunk or cfg.ce_chunk,
                                 valid_vocab=cfg.vocab_size) + aux


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor, max_new: int,
                    max_len: int | None = None) -> torch.Tensor:
    """Prefill + greedy decode of ``max_new`` tokens for the (B, S) integer
    ``prompt``, on the prompt's device; returns (B, max_new) tokens."""
    B, S = prompt.shape
    max_len = max_len or (S + max_new)
    caches = tfm.init_caches(cfg, B, max_len, device=prompt.device)
    logits, caches = tfm.prefill(params, cfg, tokens=prompt, caches=caches)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(prompt.dtype)
    outs = [tok]
    for _ in range(max_new - 1):
        logits, caches = tfm.decode_step(params, cfg, tok, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(prompt.dtype)
        outs.append(tok)
    return torch.cat(outs, dim=1)
