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
read.  The update is functional (fresh outputs), as the reference's is.

ZeRO-1 (``update_sharded``, ``init_sharded``): on a data-parallel mesh m
and v are ``DTensor``s sharded over the data axes as
``launch.shardings.zero1_specs`` says (a ``Zero1`` layout), and each rank
updates its slice of p, m and v with either path (``kernel``: one launch
per leaf on the local shard).  The caller reduce-scatters the gradients
onto the moment shards first (``Zero1.reduce_scatter``) and all-gathers the
new parameter slices after (``Zero1.gather``): the reference's GSPMD
rendering, made explicit.  With tensor parallelism the parameters are
``"model"`` slices and each rank's shard of p, m and v is its model slice
cut again by data (``zero1_specs``); the global norm counts every element
of the whole model once (``Zero1.norm``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple

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
                 grads: Mapping[str, torch.Tensor], gnorm: torch.Tensor | None = None):
    """``(sc, lr, grad_norm)`` for the update at ``step`` (1-based): sc is
    the kernel's (8,) scalar row, every value stays on the device.
    ``gnorm``, where given, is the global gradient norm (else that of
    ``grads``)."""
    lr = schedule(cfg, step)
    if gnorm is None:
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
    # The reference's expressions, operation for operation; each step writes
    # into a buffer made within this function, so a leaf's update holds two
    # float32 temporaries at a time (gemma-7b's 604M-element leaves at 8
    # layers would not fit beside the training state otherwise).
    lr, c1, c2, gscale = sc[0], sc[3], sc[4], sc[5]
    gf = g.to(torch.float32) * gscale
    m = torch.mul(m, cfg.b1).add_(torch.mul(gf, 1 - cfg.b1))
    v = torch.mul(v, cfg.b2).add_(torch.mul(gf, 1 - cfg.b2).mul_(gf))
    del gf
    u = torch.mul(m, c1).div_(torch.mul(v, c2).sqrt_().add_(cfg.eps))
    pf = p.to(torch.float32)
    u.add_(pf * cfg.weight_decay)
    return torch.sub(pf, u.mul_(lr)).to(p.dtype), m, v


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


# ---------------------------------------------------------------------------
# ZeRO-1: the moments sharded over the data axes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Zero1:
    """Where each leaf's moments live on a mesh: ``dims[name]`` is the
    tensor dim sharded over the data group ``dg`` (a
    ``models.data_parallel.DataGroup``; None: replicated),
    ``placements[name]`` the moments' ``DTensor`` placements on ``mesh``.
    With a ``"model"`` axis (tensor parallelism) a rank holds the
    ``"model"`` slice of each leaf that ``mdims`` names a dim for, over the
    ``models.tensor_parallel.ModelGroup`` ``mg``; the data shard is cut from
    that slice, ``shapes`` are the whole leaves' and ``param_placements``
    the parameters'.  ``everyone`` is the group of every rank of the mesh
    (None for one rank).  Every rank calls the collectives in the same
    order."""
    mesh: Any
    dg: Any
    dims: dict[str, int | None]
    placements: dict[str, tuple]
    everyone: Any = None
    mg: Any = None
    mdims: dict[str, int | None] = dataclasses.field(default_factory=dict)
    shapes: dict[str, torch.Size] = dataclasses.field(default_factory=dict)
    param_placements: dict[str, tuple] = dataclasses.field(default_factory=dict)

    def local(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of the whole ``t`` (contiguous)."""
        d = self.dims[name]
        return t if d is None else self.dg.local_rows(t, d).contiguous()

    def reduce_scatter(self, g: torch.Tensor, name: str) -> torch.Tensor:
        """The sum over the group of every rank's ``g``, this rank's slice
        of it (all of it, all-reduced, for a replicated leaf)."""
        d = self.dims[name]
        return self.dg.sum(g) if d is None else self.dg.reduce_scatter(g, d)

    def gather(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The whole tensor from every rank's slice ``t`` (``t`` itself for
        a replicated leaf)."""
        d = self.dims[name]
        return t if d is None else self.dg.all_gather(t, d)

    def local_shape(self, name: str, shape: torch.Size) -> torch.Size:
        return self.local(torch.empty(shape, device="meta"), name).shape

    def dtensor(self, local: torch.Tensor, name: str):
        """``local`` as this rank's shard of a ``DTensor`` of the whole leaf."""
        from torch.distributed.tensor import DTensor
        full = torch.empty(self.shapes[name], device="meta")
        return DTensor.from_local(local, self.mesh, self.placements[name], run_check=False,
                                  shape=full.shape, stride=full.stride())

    def norm(self, shards: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients whose slices are ``shards``:
        each element of the whole model counted once.  A leaf's squares are
        summed over the data group where its shard is cut by data, over the
        model group where it is a ``"model"`` slice; a leaf whole on every
        rank is counted once."""
        sq = {n: torch.sum(torch.square(g.to(torch.float32))) for n, g in shards.items()}
        zero = torch.zeros((), dtype=torch.float32, device=next(iter(sq.values())).device)

        def part(data: bool, model: bool) -> torch.Tensor:
            return sum((sq[n] for n in shards if (self.dims[n] is not None) == data
                        and (self.mdims.get(n) is not None) == model), zero)
        total = self.dg.sum(part(True, False)) + part(False, False)
        if self.mg is not None:
            total = total + self.mg.sum(self.dg.sum(part(True, True)) + part(False, True))
        return torch.sqrt(total)


def init_sharded(params: Mapping[str, torch.Tensor], zero: Zero1) -> AdamWState:
    """Zero moments as ``DTensor``s of this rank's shards."""
    dev = next(iter(params.values())).device

    def zeros(name, p):
        local = torch.zeros(zero.local_shape(name, p.shape), dtype=torch.float32,
                            device=p.device)
        return zero.dtensor(local, name)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m={n: zeros(n, p) for n, p in params.items()},
                      v={n: zeros(n, p) for n, p in params.items()})


@torch.no_grad()
def update_sharded(params: Mapping[str, torch.Tensor], shards: Mapping[str, torch.Tensor],
                   state: AdamWState, cfg: AdamWConfig, zero: Zero1, path: str = "jnp"):
    """ZeRO-1 AdamW.  ``shards`` are the reduce-scattered gradients (this
    rank's slices of the global gradient, ``Zero1.reduce_scatter``); the
    moments in ``state`` are ``DTensor``s of ``zero``'s layout.  The clip
    factor reads the global norm (one all-reduce).  Returns (this rank's
    new parameter slices, the new sharded state, metrics); ``path="kernel"``
    launches the fused AdamW kernel once per leaf on the local shard."""
    step = state.step + 1
    sc, lr, gnorm = step_scalars(cfg, step, shards, zero.norm(shards))
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        new_p[name], m, v = update_leaf(
            zero.local(p, name), shards[name], state.m[name].to_local(),
            state.v[name].to_local(), sc, cfg, path)
        new_m[name] = zero.dtensor(m, name)
        new_v[name] = zero.dtensor(v, name)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_p, AdamWState(step=step, m=new_m, v=new_v), metrics
