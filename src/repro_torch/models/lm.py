"""Language-model training loss and greedy serving loop: the counterpart of
``src/repro/models/lm.py``.

Under a data-parallel group (``models.data_parallel``) a rank's loss is its
rows' summed loss over the GLOBAL denominator (the all-reduced
``sum(mask)``, or token count) plus its share of the global MoE aux loss:
the ranks' losses, and gradients, sum to the reference's on the whole
batch.  Under tensor parallelism (``models.tensor_parallel``) the head's
vocabulary is split over the ``"model"`` ranks, and every one of them
computes the same loss; greedy decoding there gives the mesh-free
tokens."""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import data_parallel, shard_ctx, tensor_parallel
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def _mean(loss: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """``sum(loss) / max(sum(mask), 1)`` (``/ numel`` without a mask), the
    denominator summed over the data-parallel group where there is one."""
    dg = data_parallel.current()
    if mask is not None:
        loss = loss * mask
        denom = torch.sum(mask)
        if dg is not None:
            denom = dg.sum(denom)
        denom = torch.clamp(denom, min=1.0)
    elif dg is not None:
        denom = dg.sum(torch.tensor(float(loss.numel()), device=loss.device))
    else:
        denom = loss.numel()
    return torch.sum(loss) / denom


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, z_loss: float = 1e-4):
    """Stable CE with optional z-loss.  logits (B,S,V), labels (B,S)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return _mean((lse - gold) + z_loss * torch.square(lse), mask)


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
                          valid_vocab: int | None = None, vocab: int | None = None):
    """CE computed in sequence chunks so the (B, S, V) logits tensor is never
    materialized; each chunk's logits are recomputed in backward.  ``head``
    is (D, V), cast to the hidden dtype inside each chunk.

    ``head`` narrower than ``vocab`` columns is this rank's slice of a
    vocabulary-parallel head (``models.tensor_parallel``): each rank makes
    its columns' logits, and the log-sum-exp (max, sum of exponentials)
    and the gold logit are combined over the group; ``valid_vocab`` masks
    by global column."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    V = head.shape[-1]
    mg = tensor_parallel.current()
    if mg is None or vocab is None or V == vocab:
        mg = None
    lo = 0 if mg is None else mg.index * V          # this rank's first column

    def ce_of(h, l):
        if mg is not None:
            h = mg.enter(h)
        lf = shard_ctx.constrain_logits(h @ head.to(h.dtype)).to(torch.float32)
        if valid_vocab is not None and valid_vocab != (V if mg is None else vocab):
            lf = torch.where(lo + torch.arange(V, device=lf.device) < valid_vocab,
                             lf, -1e30)
        if mg is None:
            lse = torch.logsumexp(lf, dim=-1)
            gold = torch.gather(lf, -1, l[..., None].long())[..., 0]
        else:
            top = mg.max(torch.amax(lf, dim=-1))
            lse = torch.log(mg.exit(torch.sum(torch.exp(lf - top[..., None]), dim=-1))) + top
            ids = l.long() - lo
            mine = (ids >= 0) & (ids < V)
            gold = mg.exit(torch.gather(lf, -1, torch.where(mine, ids, 0)[..., None])[..., 0]
                           * mine)
        return (lse - gold) + z_loss * torch.square(lse)

    # full chunks, then the ragged tail (as the reference's map + tail)
    loss = torch.cat([checkpoint(ce_of, hidden[:, b:b + chunk],
                                 labels[:, b:b + chunk], use_reentrant=False)
                      for b in range(0, S, chunk)], dim=1)
    return _mean(loss, mask)


def loss_fn(params, batch: dict[str, Any], cfg: ModelConfig,
            ce_chunk: int | None = None) -> torch.Tensor:
    kw, labels, mask = make_batch_views(batch, cfg)
    hidden, aux = tfm.forward_hidden(params, cfg, **kw)
    dg = data_parallel.current()
    if dg is not None:
        aux = aux / dg.size               # each rank's share of the global aux
    return chunked_cross_entropy(hidden, tfm._head(params, cfg), labels, mask,
                                 chunk=ce_chunk or cfg.ce_chunk,
                                 valid_vocab=cfg.vocab_size, vocab=cfg.padded_vocab) + aux


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor, max_new: int,
                    max_len: int | None = None) -> torch.Tensor:
    """Prefill + greedy decode of ``max_new`` tokens for the (B, S) integer
    ``prompt``, on the prompt's device; returns (B, max_new) tokens.  Under
    a data group ``prompt`` is this rank's rows of the batch, and the decode
    state this rank's pieces of the whole batch's
    (``transformer.init_caches``)."""
    B, S = prompt.shape
    max_len = max_len or (S + max_new)
    dg = data_parallel.current()
    caches = tfm.init_caches(cfg, B * (1 if dg is None else dg.size), max_len,
                             device=prompt.device)
    params = tensor_parallel.serving_view(params, cfg)     # gathered leaves, once
    logits, caches = tfm.prefill(params, cfg, tokens=prompt, caches=caches)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(prompt.dtype)
    outs = [tok]
    for _ in range(max_new - 1):
        logits, caches = tfm.decode_step(params, cfg, tok, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(prompt.dtype)
        outs.append(tok)
    return torch.cat(outs, dim=1)
