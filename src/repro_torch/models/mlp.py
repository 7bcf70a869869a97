"""Gated / plain MLP: the counterpart of ``src/repro/models/mlp.py`` (dense
only; Mixture-of-Experts waits for the slice that ports the MoE family)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; F.gelu does not
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def init_mlp(cfg: ModelConfig, generator: torch.Generator | None,
             device: torch.device | str, n_layers: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_in": normal((n_layers, d, f), d ** -0.5, cfg.dtype, generator, device),
         "w_out": normal((n_layers, f, d), f ** -0.5, cfg.dtype, generator, device)}
    if cfg.gated_mlp:
        p["w_gate"] = normal((n_layers, d, f), d ** -0.5, cfg.dtype, generator, device)
    return p


def mlp_block(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = x @ p["w_in"].to(x.dtype)
    if cfg.gated_mlp:
        h = _act(x @ p["w_gate"].to(x.dtype), cfg.activation) * h
    else:
        h = _act(h, cfg.activation)
    return h @ p["w_out"].to(x.dtype)
