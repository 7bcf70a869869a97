"""Activation-sharding context: the counterpart of
``src/repro/models/shard_ctx.py``.

A launcher installs shardings here and model code reads them.  A sharding
is the port's ``(mesh, placements)`` pair, as ``launch.shardings.named``
gives it: a ``DeviceMesh`` (or a ``launch.mesh.AbstractMesh``) and one
``Shard(dim)`` or ``Replicate()`` per mesh dim.  The launcher lays them out
as the reference's ``launch/dryrun.py`` does:

* ``_RESIDUAL``: (B, S, D) activations, batch over the data axes and
  sequence over ``"model"``;
* ``_CROSS_KV``: an encoder-decoder's (L, B, Hkv, S, hd) K/V;
* ``_MOE_GROUPS``: the (G, ...) MoE dispatch groups, G over every axis;
* ``_LOGITS``: (B, S, V) logits chunks, V over ``"model"``.

The reference's ``constrain_*`` are ``with_sharding_constraint``s at layer
boundaries, placement hints to GSPMD that change no value.  The port's
parallelism is explicit (``models.data_parallel``,
``models.tensor_parallel``), so its ``constrain_*`` return their argument
unchanged, at the reference's call sites and after its rank checks; they
only refuse a sharding that names a dim the tensor lacks.  What changes
results is ``models.mlp.moe_block``'s expert-parallel dispatch, taken
where ``_MOE_GROUPS`` and ``_RESIDUAL`` are both set.  Nothing is installed
by default: the reference's ``train`` installs nothing, and neither does
the port's.  The settings are process-wide (one model runs at a time).
"""

from __future__ import annotations

from typing import Any

import torch

_RESIDUAL: Any = None      # (mesh, placements) for (B, S, D) activations
_CROSS_KV: Any = None      # (mesh, placements) for (L, B, Hkv, S, hd) enc-dec K/V
_MOE_GROUPS: Any = None    # (mesh, placements) for (G, ...) MoE dispatch groups
_LOGITS: Any = None        # (mesh, placements) for (B, S, V) logits chunks


def set_residual(sharding) -> None:
    global _RESIDUAL
    _RESIDUAL = sharding


def set_cross_kv(sharding) -> None:
    global _CROSS_KV
    _CROSS_KV = sharding


def set_moe_groups(sharding) -> None:
    global _MOE_GROUPS
    _MOE_GROUPS = sharding


def set_logits(sharding) -> None:
    global _LOGITS
    _LOGITS = sharding


def clear() -> None:
    set_residual(None)
    set_cross_kv(None)
    set_moe_groups(None)
    set_logits(None)


def _placed(x: torch.Tensor, sharding) -> torch.Tensor:
    """``x`` as it is, once ``sharding``'s placements fit its dims."""
    mesh, placements = sharding
    if len(placements) != len(mesh.mesh_dim_names):
        raise ValueError(f"{len(placements)} placements for a mesh of "
                         f"{len(mesh.mesh_dim_names)} dims")
    for pl in placements:
        if pl.is_shard() and not 0 <= pl.dim < x.ndim:
            raise ValueError(f"{pl} on a tensor of {x.ndim} dims")
    return x


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    if _RESIDUAL is None or x.ndim != 3:
        return x
    return _placed(x, _RESIDUAL)


def constrain_cross_kv(x: torch.Tensor) -> torch.Tensor:
    if _CROSS_KV is None or x.ndim != 5:
        return x
    return _placed(x, _CROSS_KV)


def constrain_logits(x: torch.Tensor) -> torch.Tensor:
    if _LOGITS is None or x.ndim != 3:
        return x
    return _placed(x, _LOGITS)


def constrain_moe_groups(x: torch.Tensor) -> torch.Tensor:
    """The leading group axis of (G, ...) MoE dispatch tensors, sharded as
    ``_MOE_GROUPS`` shards its first dim."""
    if _MOE_GROUPS is None:
        return x
    return _placed(x, _MOE_GROUPS)
