"""Assigned input shapes and per-arch applicability rules: the counterpart
of ``src/repro/configs/shapes.py``.

LM transformer shapes are seq_len x global_batch.  ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``.  ``long_500k`` requires sub-quadratic attention: it is
skipped for pure full-attention archs (recorded, not silently dropped) and
runs for SSM / hybrid / mostly-local archs.

``input_specs`` gives ``meta`` tensors where the reference gives
``jax.ShapeDtypeStruct``s: the shapes and dtypes of every model input, with
nothing allocated.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention (see DESIGN.md)"
    if shape.kind == "decode" and not cfg.decode_supported:
        return False, "encoder-only arch has no decode step"
    return True, ""


def enc_len_for(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Stub speech-frontend length for enc-dec archs."""
    return min(shape.seq_len, 4096)


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for every model input (no allocation).

    train / prefill: the batch dict consumed by ``lm.loss_fn`` (train
    carries one more token for the labels).
    decode: one new token against a cache of S tokens; caches are built
    separately (``init_caches`` on ``meta``).
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        extra = 1 if shape.kind == "train" else 0    # labels need S+1 tokens
        batch: dict = {"tokens": _spec((B, S + extra), i32)}
        if cfg.encdec:
            E = enc_len_for(cfg, shape)
            batch["enc_embeds"] = _spec((B, E, cfg.d_model), cfg.dtype)
        elif cfg.family == "vlm":
            batch["input_embeds"] = _spec((B, S + extra, cfg.d_model), cfg.dtype)
            batch["positions"] = _spec((3, B, S + extra), i32)
        elif cfg.family == "audio" and not cfg.encdec:
            batch["input_embeds"] = _spec((B, S + extra, cfg.d_model), cfg.dtype)
        return batch
    out = {"token": _spec((B, 1), i32)}
    if cfg.encdec:
        E = enc_len_for(cfg, shape)
        out["enc_out"] = _spec((B, E, cfg.d_model), cfg.dtype)
    return out
