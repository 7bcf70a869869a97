"""Device meshes over ``torch.distributed``: the counterpart of
``src/repro/launch/mesh.py``.

The reference builds ``jax.make_mesh`` meshes over the devices one process
sees.  The port is SPMD: one process per rank, each holding one device, and
a mesh is a ``DeviceMesh`` with ``mesh_dim_names`` over the ranks of the
default process group.  Where no group exists, ``make_host_mesh`` starts a
one-rank group in this process (a ``HashStore``, no network): ``gloo`` for
``device="cpu"``, ``nccl`` on the card.  Under ``torchrun`` (``WORLD_SIZE``
set) the group is initialised from the environment instead.

A mesh lives on the card unless it is given ``device="cpu"``, as a session
does; without CUDA the default raises instead of building a CPU mesh.

Defined as FUNCTIONS, so importing this module touches no process group.
Single pod: 16 x 16 = 256 ranks (data, model).  Multi-pod: 2 x 16 x 16 = 512
(pod, data, model); the pod axis composes with data for data parallelism.

    torchrun --nproc-per-node 2 my_script.py     # mesh = make_host_mesh(2, device="cpu")
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading

import torch
import torch.distributed as dist

from repro_torch.core.runtime import resolve_device
from repro_torch.core.sharded import axis_size, data_extent, data_group

_tls = threading.local()


def _ensure_group(device: torch.device) -> None:
    """Initialise the default process group if none exists: from the
    environment under ``torchrun``, else a one-rank group in this process."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, device_id=device if device.type == "cuda" else None)
        return
    dist.init_process_group(
        backend, store=dist.HashStore(), rank=0, world_size=1,
        device_id=device if device.type == "cuda" else None)


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
              device: torch.device | str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` ranks of
    the default group, row-major (the port's ``jax.make_mesh``)."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    _ensure_group(dev)
    size = 1
    for s in shape:
        size *= int(s)
    world = dist.get_world_size()
    if size > world:
        raise ValueError(f"mesh {tuple(shape)} needs {size} ranks; the process "
                         f"group has {world}")
    ranks = torch.arange(size).reshape(tuple(int(s) for s in shape))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(n_data: int = 1, n_model: int = 1,
                   device: torch.device | str = "cuda"):
    """Small (data, model) mesh over whatever ranks exist (tests, one card),
    clamped to the group's size as the reference clamps to the devices."""
    dev = resolve_device(device)
    _ensure_group(dev)
    n = dist.get_world_size()
    n_data = min(n_data, n)
    n_model = max(min(n_model, n // n_data), 1)
    return make_mesh((n_data, n_model), ("data", "model"), dev)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names without ranks, as ``jax.sharding.AbstractMesh``:
    what the sharding rules (``launch/shardings.py``) and the axis helpers
    below read, so that they run at production meshes (16 x 16, 2 x 16 x 16)
    that no process group here holds.  A ``DeviceMesh`` answers the same
    questions (``shape``, ``mesh_dim_names``, ``ndim``, ``size()``)."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"{len(self.shape)} sizes for axes {self.mesh_dim_names}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        return math.prod(self.shape)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the current mesh for the ``with`` block
    (``current_mesh()``), as ``jax.set_mesh`` does."""
    prev = getattr(_tls, "mesh", None)
    _tls.mesh = mesh
    try:
        yield mesh
    finally:
        _tls.mesh = prev


def current_mesh():
    return getattr(_tls, "mesh", None)


def data_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_extent(mesh) -> int:
    return data_extent(mesh, data_axes_of(mesh))


def tp_extent(mesh) -> int:
    return axis_size(mesh, "model") if "model" in mesh.mesh_dim_names else 1


def model_index(mesh) -> int:
    """This rank's coordinate on ``"model"`` (0 on a mesh without the axis)."""
    if "model" not in mesh.mesh_dim_names:
        return 0
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index("model")])


def model_group(mesh):
    """The process group of this rank's ``"model"`` line of ``mesh`` and the
    ``"model"`` coordinate of each of its ranks, in group-rank order (every
    rank calls this in the same order)."""
    return data_group(mesh, (mesh.mesh_dim_names.index("model"),))
