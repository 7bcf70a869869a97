"""AdamW: the counterpart of ``src/repro/optim/adamw.py``.

Interchangeable update paths (same math, held against each other and
against the JAX package):

* ``jnp``    — plain tensor ops per leaf (the reference's default; named
               after it so the two packages share the option's values);
* ``kernel`` — the hand-written fused AdamW CUDA kernel, one launch per
               leaf (``kernels/fused_adamw.py``);
* the Mozart pipeline in ``optim/mozart_adamw.py``.

Parameters, gradients and the moments are flat dicts ``{path: tensor}`` in
the reference's leaf order (``models.weights.leaves``).  lr, the global
gradient norm and the clip factor stay on the device: a step makes no host
read.  The update is functional (fresh outputs), as the reference's is;
ZeRO-1 sharding of m and v waits for the mesh port (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch

from repro_torch.kernels.fused_adamw import fused_adamw, scalar_row


class AdamWState(NamedTuple):
    step: torch.Tensor                 # () int32
    m: dict[str, torch.Tensor]         # like params, float32
    v: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m={n: zeros(p) for n, p in params.items()},
                      v={n: zeros(p) for n, p in params.items()})


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (float32, on step's device)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def step_scalars(cfg: AdamWConfig, step: torch.Tensor,
                 grads: Mapping[str, torch.Tensor]):
    """``(sc, lr, grad_norm)`` for the update at ``step`` (1-based): sc is
    the kernel's (8,) scalar row, every value stays on the device."""
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    gscale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return scalar_row(lr, cfg.b1, cfg.b2, step, gscale), lr, gnorm


@torch.no_grad()
def update_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, sc: torch.Tensor, cfg: AdamWConfig,
                path: str = "jnp"):
    """One leaf's new ``(p, m, v)`` under the scalar row ``sc``."""
    if path == "kernel":
        sh = p.shape
        po, mo, vo = fused_adamw(p.reshape(-1), g.reshape(-1), m.reshape(-1),
                                 v.reshape(-1), sc, eps=cfg.eps,
                                 wd=cfg.weight_decay)
        return po.reshape(sh), mo.reshape(sh), vo.reshape(sh)
    if path != "jnp":
        raise ValueError(f"unknown AdamW path {path!r} (jnp | kernel)")
    lr, c1, c2, gscale = sc[0], sc[3], sc[4], sc[5]
    gf = g.to(torch.float32) * gscale
    m = cfg.b1 * m + (1 - cfg.b1) * gf
    v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
    u = (m * c1) / (torch.sqrt(v * c2) + cfg.eps) + \
        cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * u).to(p.dtype), m, v


@torch.no_grad()
def update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
           state: AdamWState, cfg: AdamWConfig, path: str = "jnp"):
    """Returns (new_params, new_state, metrics); ``path="kernel"`` launches
    the fused AdamW kernel once per leaf."""
    step = state.step + 1
    sc, lr, gnorm = step_scalars(cfg, step, grads)
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        new_p[name], new_m[name], new_v[name] = update_leaf(
            p, grads[name], state.m[name], state.v[name], sc, cfg, path)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_p, AdamWState(step=step, m=new_m, v=new_v), metrics
