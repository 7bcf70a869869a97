"""Sharding rules for every architecture: the counterpart of
``src/repro/launch/shardings.py``.

Rules are divisibility-guarded: a dimension shards over ``"model"`` only
when the extent divides (granite's single KV head and hymba's 25 q-heads
stay replicated while their MLP/SSM inner dims shard).  Optimizer moments
additionally shard over the data axes on the first shardable dimension
(ZeRO-1): ``launch/train.py`` renders the update as reduce-scatter(grad)
-> sharded update -> all-gather(param), which GSPMD does implicitly for the
reference.

Decode KV caches are laid out (L, n_blk, blk, B, Hkv, hd) and n_blk is
sharded over ``"model"``.

A spec is a plain tuple per leaf, one entry per tensor dim: ``None``, an
axis name, or a tuple of axis names (the reference's ``PartitionSpec``
entries).  Parameter specs are keyed by the leaf names of
``models.weights.flatten`` (``"layers.attn.wq"``: the reference's tree path
joined with dots); batch specs by the batch's keys; cache specs keep the
cache's own structure (NamedTuples, dicts).  The rules read only axis names
and sizes, so they run on a ``DeviceMesh`` or on a ``launch.mesh.AbstractMesh``
at production meshes, and on ``meta`` tensors (``init_model(cfg, None,
"meta")``).  ``named`` turns specs into the ``(mesh, placements)`` pairs that
``ckpt.restore(..., shardings)`` and ``DTensor.from_local`` take.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.launch.mesh import data_axes_of, dp_extent, tp_extent
from repro_torch.models import weights
from repro_torch.models.config import ModelConfig

Spec = tuple


def _dp(mesh):
    axes = data_axes_of(mesh)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _shard_if(mesh, dim_size: int) -> Any:
    """``"model"`` if divisible (and the axis exists), else None."""
    me = tp_extent(mesh)
    return "model" if me > 1 and dim_size % me == 0 else None


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

#: (in, out) matrices sharded on their output ("wide") dim; MoE experts
#: (E, D, F) on F
_WIDE_OUT = ("wq", "wk", "wv", "w_in", "w_gate", "w_r", "w_k", "w_v", "w_g", "w_ck",
             "in_proj", "dt_proj", "x_proj_unused")
#: (in, out) matrices sharded on their input dim; MoE (E, F, D) on F
_WIDE_IN = ("wo", "w_out", "w_o", "w_cv", "out_proj", "x_proj")


def _leaf_spec(path_names: tuple[str, ...], shape: tuple[int, ...], mesh) -> Spec:
    name = path_names[-1]
    # A leading layer-stack axis exists when 'layers'/'enc_layers' is on the
    # path (DeepSeekMoE's 'pre_layers' are unstacked).
    stacked = any(n in ("layers", "enc_layers") for n in path_names)

    def wrap(*spec):
        return (None, *spec) if stacked else spec

    core = shape[1:] if stacked else shape
    cnd = len(core)

    if name == "embed":
        return (_shard_if(mesh, shape[0]), None)
    if name == "lm_head":
        return (None, _shard_if(mesh, shape[1]))
    if name in _WIDE_OUT:
        if cnd == 2:
            return wrap(None, _shard_if(mesh, core[1]))
        if cnd == 3:
            return wrap(None, None, _shard_if(mesh, core[2]))
    if name in _WIDE_IN:
        if cnd == 2:
            return wrap(_shard_if(mesh, core[0]), None)
        if cnd == 3:
            return wrap(None, _shard_if(mesh, core[1]), None)
    if name == "router":
        return wrap(None, None)
    if name == "conv_w":             # (W, d_in)
        return wrap(None, _shard_if(mesh, core[1]))
    if name == "A_log":              # (d_in, N)
        return wrap(_shard_if(mesh, core[0]), None)
    if name in ("dt_bias", "D_skip"):
        return wrap(_shard_if(mesh, core[0]))
    if name in ("decay_a", "decay_b"):
        return wrap(None, None)
    # norms, mu_*, biases, bonus: replicate
    return wrap(*([None] * cnd))


def _param_leaves(params) -> dict[str, Any]:
    if isinstance(params, weights.ParamTree):
        return weights.leaves(params)
    return weights.flatten(params)


def param_specs(params, mesh) -> dict[str, Spec]:
    """``{leaf name: spec}`` for a parameter tree (a ``ParamTree``, a nested
    dict or a flat ``{name: tensor}`` dict; only shapes are read)."""
    return {name: _leaf_spec(tuple(name.split(".")), tuple(leaf.shape), mesh)
            for name, leaf in _param_leaves(params).items()}


def axis_dim(spec: Spec, axis: str) -> int | None:
    """The dim of ``spec`` sharded over ``axis`` (None: none is)."""
    return next((d for d, e in enumerate(spec)
                 if e == axis or (isinstance(e, tuple) and axis in e)), None)


def model_dims(params, mesh) -> dict[str, int | None]:
    """``{leaf name: the dim param_specs shards over "model"}`` (None: the
    leaf is whole on every rank of a ``"model"`` line)."""
    return {n: axis_dim(sp, "model") for n, sp in param_specs(params, mesh).items()}


def zero1_specs(params, mesh) -> dict[str, Spec]:
    """Optimizer-moment specs: the param spec plus data sharding on the
    first still-unsharded, divisible dimension (ZeRO-1)."""
    dpa, dpe = _dp(mesh), dp_extent(mesh)
    base = param_specs(params, mesh)
    out = {}
    for name, leaf in _param_leaves(params).items():
        spec = base[name]
        if dpa is not None and dpe > 1:
            parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
            for i, (s, dim) in enumerate(zip(parts, leaf.shape)):
                if s is None and dim % dpe == 0 and dim >= dpe:
                    parts[i] = dpa
                    spec = tuple(parts)
                    break
        out[name] = spec
    return out


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(batch, mesh) -> dict[str, Spec]:
    """Rows over the data axes where the batch divides, else replicated;
    M-RoPE ``positions`` (3, B, S) on their B."""
    dpa, dpe = _dp(mesh), dp_extent(mesh)
    out = {}
    for name, leaf in batch.items():
        shape = tuple(leaf.shape)
        if name == "positions":
            out[name] = (None, dpa if shape[1] % dpe == 0 else None, None)
        else:
            out[name] = (dpa if shape[0] % dpe == 0 else None, *([None] * (len(shape) - 1)))
    return out


def map_with_path(fn: Callable, tree, path: tuple[str, ...] = ()):
    """``fn(path, leaf)`` over dicts, NamedTuples and lists, keeping the
    structure (a leaf is anything else)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if hasattr(tree, "items"):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def cache_specs(caches, mesh, cfg: ModelConfig):
    """Stacked (L, ...) decode state, in the cache's own structure.  KV:
    (L, n_blk, blk, B, Hkv, hd), n_blk over ``"model"``, B over the data
    axes; SSM and RWKV states on their batch and inner dims."""
    dpa, dpe, me = _dp(mesh), dp_extent(mesh), tp_extent(mesh)

    def dp_if(b):
        return dpa if b % dpe == 0 else None

    def spec(path, leaf) -> Spec:
        name, shape = (path[-1] if path else ""), tuple(leaf.shape)
        nd = len(shape)
        if name in ("k", "v") and nd == 6:
            return (None, "model" if me > 1 and shape[1] % me == 0 else None,
                    None, dp_if(shape[3]), None, None)
        if name == "length":
            return (None,) * nd
        if name == "h" and nd == 4:           # SSM (L, B, d_in, N)
            return (None, dp_if(shape[1]), _shard_if(mesh, shape[2]), None)
        if name == "conv" and nd == 4:        # (L, B, W-1, d_in)
            return (None, dp_if(shape[1]), None, _shard_if(mesh, shape[3]))
        if name == "wkv" and nd == 5:         # (L, B, H, hd, hd)
            return (None, dp_if(shape[1]), _shard_if(mesh, shape[2]), None, None)
        if name in ("shift_t", "shift_c") and nd == 3:
            return (None, dp_if(shape[1]), None)
        return (None,) * nd

    return map_with_path(spec, caches)


def at_path(tree, path: tuple[str, ...]):
    """The leaf of ``tree`` at a ``map_with_path`` path."""
    for k in path:
        tree = (getattr(tree, k) if hasattr(tree, "_fields")
                else tree[int(k)] if isinstance(tree, list) else tree[k])
    return tree


def region(shape: tuple[int, ...], spec: Spec, mesh, coord: tuple[int, ...]) -> tuple:
    """The part (a slice per dim) of a leaf of ``shape`` that the rank at
    mesh coordinate ``coord`` (one index per mesh dim) holds under
    ``spec``: ``torch.chunk``'s cut along each sharded dim, an entry of
    several axes indexed row-major over them, as ``placements`` lays it
    out."""
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    at = dict(zip(mesh.mesh_dim_names, coord))
    out = []
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        count, index = 1, 0
        for a in axes:
            count, index = count * size[a], index * size[a] + at[a]
        step = -(-shape[d] // count)
        lo = min(index * step, shape[d])
        out.append(slice(lo, min(lo + step, shape[d])))
    return tuple(out) + (slice(None),) * (len(shape) - len(spec))


def local_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    """The shape of the first rank's part of a leaf (``region``)."""
    return tuple(len(range(*r.indices(n)))
                 for r, n in zip(region(shape, spec, mesh, (0,) * len(mesh.shape)), shape))


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec``: ``Shard(d)`` on every mesh
    dim whose axis entry ``d`` names, ``Replicate()`` on the others.  An
    entry of several axes (``("pod", "data")``) shards dim ``d`` over each,
    the first major, which is JAX's order and the mesh's: it must list them
    in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"axis {names[i]!r} shards two dims in {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


def named(specs, mesh):
    """Each spec as the ``(mesh, placements)`` pair that ``ckpt.restore``'s
    ``shardings`` and ``DTensor.from_local`` take, in the specs' structure."""
    return map_with_path(lambda _path, spec: (mesh, placements(spec, mesh)), specs)

