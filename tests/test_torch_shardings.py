"""The port's sharding rules (``repro_torch.launch.shardings``) against the
reference's (``repro.launch.shardings``), entry for entry, for every
registry id at published widths, on abstract meshes: (4, 1), (2, 2),
(1, 8) and (16, 16) over ("data", "model"), and (2, 16, 16) over ("pod",
"data", "model").  No devices: the reference's parameters and caches come
from ``jax.eval_shape`` on ``jax.sharding.AbstractMesh``, the port's from
``init_model``/``init_caches`` on the ``meta`` device on
``launch.mesh.AbstractMesh``.  Then ``named`` gives the placements
``ckpt.restore`` and ``DTensor.from_local`` take.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import registry as jreg
from repro.launch import shardings as jshd
from repro.models import transformer as jtfm
from repro_torch.configs import registry as treg
from repro_torch.launch import shardings as tshd
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import transformer as ttfm

MESHES = {"4x1": ((4, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: a decode batch that divides every mesh's data extent, and one that
#: divides none past 4 (replicated rows)
CACHE_BATCHES = (32, 12)
KV_BLOCKS = 16


def _names(path) -> str:
    out = []
    for e in path:
        for attr in ("key", "idx", "name"):
            if hasattr(e, attr):
                out.append(str(getattr(e, attr)))
                break
    return ".".join(out)


def _flat(tree) -> dict:
    """``{dotted path: PartitionSpec as a tuple}`` of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_names(p): tuple(s) for p, s in leaves}


def _port_flat(tree, prefix="") -> dict:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, f"{prefix}.{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def _meshes(key):
    shape, names = MESHES[key]
    return JAbstractMesh(shape, names), AbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg = jreg.get_config(arch)
    javals = jax.eval_shape(functools.partial(jtfm.init_model, cfg=jcfg),
                            jax.random.PRNGKey(0))
    return javals, ttfm.init_model(treg.get_config(arch), None, "meta")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_and_zero1_specs_equal_the_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    javals, model = _params(arch)
    want_p, want_z = _flat(jshd.param_specs(javals, jmesh)), _flat(jshd.zero1_specs(javals, jmesh))
    got_p, got_z = tshd.param_specs(model, tmesh), tshd.zero1_specs(model, tmesh)
    assert got_p == want_p
    assert got_z == want_z
    if tmesh.shape[-2] > 1:                   # ZeRO-1 sharded something
        assert any(z != p for z, p in zip(got_z.values(), got_p.values()))


def _batch_shapes(cfg, B, S):
    shapes = {"tokens": ((B, S + 1), "int32"), "mask": ((B, S + 1), "float32")}
    if cfg.encdec:
        shapes["enc_embeds"] = ((B, 64, cfg.d_model), "float32")
    elif cfg.family == "vlm":
        shapes["input_embeds"] = ((B, S + 1, cfg.d_model), "float32")
        shapes["positions"] = ((3, B, S + 1), "int32")
    return shapes


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg = jreg.get_config(arch).with_runtime(kv_cache_blocks=KV_BLOCKS)
    tcfg = treg.get_config(arch).with_runtime(kv_cache_blocks=KV_BLOCKS)
    for B in CACHE_BATCHES:
        shapes = _batch_shapes(tcfg, B, 128)
        jb = {k: jax.ShapeDtypeStruct(s, d) for k, (s, d) in shapes.items()}
        tb = {k: torch.empty(s, device="meta") for k, (s, _d) in shapes.items()}
        assert tshd.batch_specs(tb, tmesh) == _flat(jshd.batch_specs(jb, jmesh))
        for per_slot in (False, True):
            jc = jax.eval_shape(lambda: jtfm.init_caches(jcfg, B, 256, per_slot=per_slot))
            tc = ttfm.init_caches(tcfg, B, 256, per_slot=per_slot, device="meta")
            want = _flat(jshd.cache_specs(jc, jmesh, jcfg))
            assert _port_flat(tshd.cache_specs(tc, tmesh, tcfg)) == want, (B, per_slot)


def test_kv_blocks_and_batch_shard_as_the_reference_says():
    """The KV cache's n_blk over "model" and B over ("pod", "data") at the
    multi-pod mesh, held to literal specs beside the reference's."""
    _, tmesh = _meshes("2x16x16")
    cfg = treg.get_config("gemma-7b").with_runtime(kv_cache_blocks=KV_BLOCKS)
    kv = tshd.cache_specs(ttfm.init_caches(cfg, 32, 256, device="meta"), tmesh, cfg)
    assert kv.k == (None, "model", None, ("pod", "data"), None, None)
    z = tshd.zero1_specs(ttfm.init_model(cfg, None, "meta"), tmesh)
    assert z["layers.attn.wq"] == (None, ("pod", "data"), "model")
    assert z["embed"] == ("model", ("pod", "data"))


def test_named_gives_the_placements_restore_takes(tmp_path):
    """``named`` on the multi-pod mesh: ("pod", "data") is Shard on both mesh
    dims, pod major; then on a real one-rank mesh ``ckpt.restore`` takes
    the pairs and gives one-rank DTensors of the whole leaves."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.mesh import make_mesh
    _, tmesh = _meshes("2x16x16")
    mesh, pl = tshd.named(("model", ("pod", "data")), tmesh)
    assert mesh is tmesh and pl == (Shard(1), Shard(1), Shard(0))
    assert tshd.named({"a": (None,)}, tmesh)["a"][1] == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        tshd.placements((("data", "pod"),), tmesh)

    real = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    cfg = treg.get_smoke_config("gemma-7b")
    model = ttfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = {n: p.detach() for n, p in sorted(model.named_parameters())}
    ckpt.save(tmp_path, 1, {"m": flat})
    specs = tshd.zero1_specs(model, real)
    back = ckpt.restore(tmp_path, 1, {"m": flat}, {"m": tshd.named(specs, real)})["m"]
    for name, t in back.items():
        assert isinstance(t, DTensor) and t.placements == tshd.placements(specs[name], real)
        assert t.to_local().shape == flat[name].shape
        np.testing.assert_array_equal(t.full_tensor().float().numpy(), flat[name].float().numpy())
