"""Parameters of the port and their carry-across from the JAX package.

The port keeps the JAX package's parameter layout: the same nested tree
(``embed``, ``final_norm``, ``layers/{attn/{wq,wk,wv,wo}, ln1, ln2,
mlp/{w_in,w_gate,w_out}}`` or ``moe/{router, shared, w_gate, w_in, w_out}``,
DeepSeekMoE's list ``pre_layers``, and an encoder-decoder's ``enc_layers``,
``enc_norm`` and per-layer ``cross`` and ``ln3``), layers stacked along a leading ``L``
axis and matrices stored ``(in, out)`` and used as ``x @ W``.  A JAX
parameter tree therefore copies across exactly, and the optimizer sees the
same leaves in the same order as the reference's ``tree_flatten`` (dict
keys sorted, list items in index order).

``ParamTree`` holds that tree as ``nn.Parameter``s of nested modules and
can be indexed like the reference's dict (``params["layers"]["attn"]``,
``params["pre_layers"][0]``).  Decode states carry across the same way: the
reference's stacked ``KVCache``, ``SSMState`` and ``RWKVState`` (and its
``{"stack", "pre"}`` and ``{"kv", "ssm"}`` dicts of them) and the port's
have the same leaves in the same layout; ``cache_piece`` cuts one into a
rank's pieces as ``launch.shardings.cache_specs`` places them and
``cache_assemble`` puts the pieces back together.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.rwkv import RWKVState
from repro_torch.models.ssm import SSMState


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: sub-dicts become child
    modules, lists of sub-dicts ``nn.ModuleList``s, tensors become
    parameters, registered in sorted key order."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        self._keys = tuple(sorted(tree))
        for k in self._keys:
            v = tree[k]
            if hasattr(v, "items"):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(
                    k, v if isinstance(v, nn.Parameter) else nn.Parameter(v))

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def items(self):
        return [(k, getattr(self, k)) for k in self._keys]

    def tree(self) -> dict:
        """The parameters as a plain nested dict (the reference's layout)."""
        return {k: v.tree() if isinstance(v, ParamTree)
                else [x.tree() for x in v] if isinstance(v, nn.ModuleList) else v
                for k, v in self.items()}

    # -- Mozart capture hooks (``core/plan_cache.py``, ``core/annotation.py``)
    def mozart_fingerprint(self) -> tuple:
        """Structural identity for the plan cache: every leaf's path, shape,
        dtype and device type (a whole model passed to an annotated call is
        one value, keyed like a tensor)."""
        return ("ParamTree", tuple(
            (name, tuple(p.shape), str(p.dtype), p.device.type)
            for name, p in self.named_parameters()))

    def mozart_meta(self) -> "ParamTree":
        """The same tree on the ``meta`` device, for abstract evaluation:
        shapes and dtypes only, never a real weight.  Cached per
        fingerprint, so a cold registration builds it once."""
        fp = self.mozart_fingerprint()
        twin = _META_TWINS.get(fp)
        if twin is None:
            twin = ParamTree(unflatten({
                name: torch.empty(p.shape, dtype=p.dtype, device="meta")
                for name, p in self.named_parameters()}))
            twin.requires_grad_(False)
            if len(_META_TWINS) >= 8:            # a few models per process
                _META_TWINS.clear()
            _META_TWINS[fp] = twin
        return twin


#: meta twins of the ParamTrees captured so far, by fingerprint.
_META_TWINS: dict[tuple, ParamTree] = {}


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """``{"a.b.c": leaf}`` in the reference's leaf order (dict keys sorted,
    list items as ``a.0``, ``a.1``, ... in index order)."""
    out: dict[str, Any] = {}
    items = (sorted(tree.items()) if hasattr(tree, "items")
             else [(str(i), v) for i, v in enumerate(tree)])
    for k, v in items:
        name = f"{prefix}.{k}" if prefix else k
        if hasattr(v, "items") or isinstance(v, (list, tuple)):
            out.update(flatten(v, name))
        else:
            out[name] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> dict:
    """The nested tree of ``flatten``'s names; a node whose keys are all
    indices becomes a list."""
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *parents, last = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v

    def lists(node):
        if not hasattr(node, "items"):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def leaves(model: nn.Module) -> dict[str, nn.Parameter]:
    """The optimizer's leaves, in the reference's ``tree_flatten`` order."""
    return dict(sorted(model.named_parameters()))


@torch.no_grad()
def assign(model: nn.Module, new: Mapping[str, torch.Tensor]) -> None:
    """Point each parameter at its new tensor (no copy; the old storage is
    freed once nothing else holds it)."""
    params = leaves(model)
    if set(new) != set(params):
        raise KeyError(f"leaves differ: {sorted(set(new) ^ set(params))}")
    for name, p in params.items():
        t = new[name]
        if t.shape != p.shape or t.dtype != p.dtype or t.device != p.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device} "
                             f"for {tuple(p.shape)} {p.dtype} {p.device}")
        p.data = t


def _tensor(a: Any) -> torch.Tensor:
    a = np.array(a)                        # a writable copy
    if a.dtype.name == "bfloat16":         # ml_dtypes' bfloat16, bit for bit
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
               device: torch.device | str = "cuda") -> ParamTree:
    """The JAX parameter tree (leaves as numpy arrays) as the port's
    parameters.  Paths and shapes must be those ``init_model(cfg)`` makes;
    each leaf takes the dtype the port's init gives it (bfloat16 stays bit
    for bit, float32 arrays of a bfloat16 leaf are rounded to nearest)."""
    from repro_torch.models.transformer import init_model
    want = flatten(init_model(cfg, None, "meta").tree())
    got = flatten(tree)
    if set(got) != set(want):
        raise KeyError(f"parameter paths differ from {cfg.name}'s: "
                       f"{sorted(set(got) ^ set(want))}")
    out = {}
    for name, ref in want.items():
        t = _tensor(got[name])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"{cfg.name} has {tuple(ref.shape)}")
        out[name] = t.to(device=device, dtype=ref.dtype)
    return ParamTree(unflatten(out))


def to_numpy(params: ParamTree | Mapping[str, Any]) -> dict:
    """The parameters as a nested dict of numpy arrays in the reference's
    layout; bfloat16 leaves come out as float32 (exact; numpy has no
    bfloat16 of its own)."""
    tree = params.tree() if isinstance(params, ParamTree) else params

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return unflatten({k: host(v) for k, v in flatten(tree).items()})


def cache_from_numpy(cache: Any, cfg: ModelConfig, device: torch.device | str = "cuda"):
    """The reference's stacked decode state, leaves as numpy arrays, as the
    port's: a ``KVCache`` (k, v (L, n_blk, blk, B, Hkv, D), length (L,) or
    (L, B), start (L, B)), an ``SSMState`` (h (L, B, d_in, N), conv (L, B,
    W-1, d_in)) or an ``RWKVState`` (wkv (L, B, H, hd, hd), shift_t and
    shift_c (L, B, D)), told apart by their field names, or a dict of them.
    k, v, conv and the shifts take ``cfg.dtype`` (bfloat16 bit for bit), h
    and wkv float32, the counters int32."""
    if isinstance(cache, dict):
        return {name: cache_from_numpy(c, cfg, device) for name, c in cache.items()}
    as_model = lambda x: _tensor(x).to(device=device, dtype=cfg.dtype)
    as_f32 = lambda x: _tensor(x).to(device=device, dtype=torch.float32)
    fields = getattr(cache, "_fields", None)
    if fields == SSMState._fields:
        return SSMState(h=as_f32(cache.h), conv=as_model(cache.conv))
    if fields == RWKVState._fields:
        return RWKVState(wkv=as_f32(cache.wkv), shift_t=as_model(cache.shift_t),
                         shift_c=as_model(cache.shift_c))
    k, v, length, start = cache
    ints = [torch.from_numpy(np.array(x, dtype=np.int32)).to(device) for x in (length, start)]
    return KVCache(as_model(k), as_model(v), *ints)


def cache_to_numpy(cache):
    """The port's decode state as the same named tuples (or dict of them)
    of numpy arrays, in the reference's layout; bfloat16 leaves come out as
    float32 (exact)."""
    if isinstance(cache, dict):
        return {name: cache_to_numpy(c) for name, c in cache.items()}

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return type(cache)(*(host(t) for t in cache))


def cache_piece(cache: Any, cfg: ModelConfig, mesh, coord: tuple[int, ...],
                device: torch.device | str = "cuda"):
    """The piece of the reference's stacked decode state ``cache`` (numpy
    leaves, any of ``cache_from_numpy``'s forms) that the rank at mesh
    coordinate ``coord`` (one index per dim of ``mesh``, a ``DeviceMesh``
    or a ``launch.mesh.AbstractMesh``) holds, as
    ``launch.shardings.cache_specs`` places it, as the port's tensors:
    what ``transformer.init_caches`` allocates on that rank, filled."""
    from repro_torch.launch import shardings as shd
    specs = shd.cache_specs(cache, mesh, cfg)
    piece = shd.map_with_path(lambda path, leaf: np.asarray(leaf)[shd.region(
        tuple(np.shape(leaf)), shd.at_path(specs, path), mesh, coord)], cache)
    return cache_from_numpy(piece, cfg, device)


def cache_assemble(pieces: Mapping[tuple[int, ...], Any], cfg: ModelConfig, mesh,
                   batch: int, max_len: int):
    """``cache_piece``'s inverse: the whole stacked decode state of
    ``batch`` rows and ``max_len`` positions, as ``cache_to_numpy`` gives
    it, from every mesh coordinate's piece (``{coord: piece}``, the port's
    tensors); a part held by several coordinates is taken from the first."""
    from repro_torch.launch import shardings as shd
    from repro_torch.models import data_parallel, tensor_parallel
    from repro_torch.models.transformer import init_caches
    with data_parallel.use(None), tensor_parallel.use(None):
        like = init_caches(cfg, batch, max_len, device="meta")
    items = [(c, cache_to_numpy(p)) for c, p in pieces.items()]
    specs = shd.cache_specs(like, mesh, cfg)

    def whole(path: tuple, leaf):
        shape, spec = tuple(leaf.shape), shd.at_path(specs, path)
        out = np.empty(shape, dtype=shd.at_path(items[0][1], path).dtype)
        for coord, piece in reversed(items):
            out[shd.region(shape, spec, mesh, coord)] = shd.at_path(piece, path)
        return out
    return shd.map_with_path(whole, like)


def model_slices(params: ParamTree, dims: Mapping[str, int | None], index: int,
                 size: int) -> ParamTree:
    """Rank ``index``'s ``"model"`` slice of each leaf of the whole
    ``params``, as tensor parallelism holds them (``dims``:
    ``launch.shardings.model_dims``; ``torch.chunk``'s cut, as a ``Shard``
    placement's): a ``ParamTree`` of contiguous copies, a leaf with no dim
    kept as it is.  The reference's parameters come across whole through
    ``from_numpy`` first; ``init_slices`` draws the slices without the
    whole."""
    out = {}
    for name, p in leaves(params).items():
        d = dims[name]
        out[name] = p.detach() if d is None else \
            torch.chunk(p.detach(), size, dim=d)[index].contiguous()
    return ParamTree(unflatten(out))


def init_slices(cfg: ModelConfig, generator: torch.Generator | None,
                device: torch.device | str, dims: Mapping[str, int | None], index: int,
                size: int) -> ParamTree:
    """``model_slices(init_model(cfg, generator, device), dims, index,
    size)`` bit for bit, without ever holding the whole model: each leaf
    ``layers.normal`` draws is drawn straight into this rank's slice, a
    first-axis piece of at most ``layers.DRAW_ELEMENTS`` float32 values at
    a time, from the same draws in the same order.  Which draw makes which
    leaf comes from an init on the ``meta`` device first.  The leaves
    ``normal`` does not draw (norm scales, the SSM's and RWKV's constants)
    are made whole and cut at the end."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import init_model
    made: list[nn.Parameter] = []

    def record(shape, draw):
        made.append(nn.Parameter(draw(), requires_grad=False))
        return made[-1]
    with layers.drawing(record):
        meta = init_model(cfg, None, "meta")
    name_of = {id(p): n for n, p in leaves(meta).items()}
    drawn = [name_of[id(p)] for p in made]
    cuts = iter([None if dims[n] is None else (dims[n], index, size) for n in drawn])
    with layers.drawing(lambda shape, draw: draw(next(cuts))):
        tree = init_model(cfg, generator, device)
    drawn = set(drawn)
    out = {}
    for name, p in leaves(tree).items():
        d = dims[name]
        out[name] = p.detach() if d is None or name in drawn else \
            torch.chunk(p.detach(), size, dim=d)[index].contiguous()
    return ParamTree(unflatten(out))
