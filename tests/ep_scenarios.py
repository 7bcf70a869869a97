"""The expert-parallel MoE dispatch (``models.shard_ctx`` installed as the
reference's ``launch/dryrun.py`` installs it), run by both packages.

One MoE block of a smoke config in float32 (``moe_block`` on x of
(``BATCH``, ``SEQ``, d_model) at the default capacity factor, where the
routing drops), with ``moe_groups`` the device count.  Its loss is
``sum(out * w) + aux`` for a fixed random ``w``.  The reference runs ONE
subprocess per world (``run_jax``: forced host devices, Auto-axis
meshes), which writes per case the parameters, x and w, and:

* ``oracle``: the reference's mesh-free ``moe_block`` on x PERMUTED so
  that each device's (batch block, sequence block) is one contiguous
  group, then un-permuted, with its loss's gradients (``jax.grad``).  The
  groups are independent and the aux statistics permutation-invariant, so
  this is the expert-parallel result, drops included;
* ``shard_map``: the reference's own expert-parallel branch under ``jit``
  (its forward and aux loss).  It equals the oracle on data-only meshes;
  over a ``"model"`` extent > 1 its psum of ``out_buf`` adds the other
  ranks' tokens (ROADMAP, reference quirks), and it is only recorded;
* ``aux_plain``: the aux loss of the mesh-free block with one group.

The port runs the block in a ``gloo`` world of spawned ranks
(``torch_rank``): each rank its rows of x and its ``"model"`` slices of
the experts, under the data and model groups ``train(mesh=...)`` would
install; the output, the aux loss and the gradients come back whole
(summed over the data group, gathered over ``"model"``).  The "four"
world also trains (``train(mesh=make_host_mesh(2, 2))``, the context
installed) at ``capacity_factor = n_experts / top_k``, where nothing can
drop, against the mesh-free ``train()`` with ``moe_groups`` 4.

This module imports neither JAX nor torch at import time.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys

import numpy as np

BATCH, SEQ, SEED = 4, 16, 0
AXES = ("data", "model")
#: case -> (arch, mesh shape); axes ("data", "model")
CASES = {f"{tag}_{a}x{b}": (arch, (a, b))
         for tag, arch in (("olmoe", "olmoe-1b-7b"), ("deepseek", "deepseek-moe-16b"))
         for a, b in ((2, 1), (1, 2), (4, 1), (2, 2))}
#: world -> (ranks, the block cases that run there)
WORLDS = {"two": (2, tuple(n for n, (_a, s) in CASES.items() if s[0] * s[1] == 2)),
          "four": (4, tuple(n for n, (_a, s) in CASES.items() if s[0] * s[1] == 4))}
#: the "four" world's training runs: (2, 2) for 3 steps at lr 1e-2
TRAIN = {"olmoe": "olmoe-1b-7b", "deepseek": "deepseek-moe-16b"}
TRAIN_SHAPE, STEPS, TRAIN_BATCH, TRAIN_SEQ, LR = (2, 2), 3, 4, 32, 1e-2
#: the port's expert leaves and the dim each splits over "model" (F)
MODEL_DIMS = {"w_in": 2, "w_gate": 2, "w_out": 1,
              "shared.w_in": 1, "shared.w_gate": 1, "shared.w_out": 0}


def devices(shape) -> int:
    return shape[0] * shape[1]


def inputs(d_model: int) -> tuple[np.ndarray, np.ndarray]:
    """x and the loss's weights w, (BATCH, SEQ, d_model) float32 each.  x
    has a component every token shares, so the routing is skewed and the
    default capacity drops assignments (about a tenth) in every group."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((BATCH, SEQ, d_model)) + rng.standard_normal(d_model)
    return (x.astype(np.float32),
            rng.standard_normal((BATCH, SEQ, d_model)).astype(np.float32))


def permute(x, shape):
    """x (B, S, ...) as (n_dev * Bl, Sl, ...) whose rows [g*Bl, (g+1)*Bl)
    are device g = d*M + m's block: rows of batch block d at sequence block
    m.  Works on numpy and JAX arrays."""
    nd, M = shape
    B, S = x.shape[:2]
    rest = x.shape[2:]
    y = x.reshape(nd, B // nd, M, S // M, *rest)
    y = y.transpose(0, 2, 1, 3, *range(4, 4 + len(rest)))
    return y.reshape(nd * M * (B // nd), S // M, *rest)


def unpermute(y, shape, B, S):
    nd, M = shape
    rest = y.shape[2:]
    x = y.reshape(nd, M, B // nd, S // M, *rest)
    x = x.transpose(0, 2, 1, 3, *range(4, 4 + len(rest)))
    return x.reshape(B, S, *rest)


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in sorted(tree.items()):
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if hasattr(v, "items") else {name: np.asarray(v)})
    return out


# ---------------------------------------------------------------------------
# The reference: one subprocess per world
# ---------------------------------------------------------------------------


def _jax_cfg(arch, shape, **moe):
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config
    cfg = get_smoke_config(arch)
    return cfg.with_runtime(dtype=jnp.float32, moe_groups=devices(shape),
                            moe=dataclasses.replace(cfg.moe, **moe))


def jax_install(mesh, cfg, batch: int) -> None:
    """``shard_ctx`` as ``src/repro/launch/dryrun.py:168-183`` installs it."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.models import shard_ctx
    dpa = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dpe = int(np.prod([mesh.shape[a] for a in dpa]))
    dp_spec = dpa if len(dpa) > 1 else (dpa[0] if dpa else None)
    bspec = dp_spec if batch % dpe == 0 else None
    seq_spec = "model" if cfg.seq_shard_residual else None
    shard_ctx.set_residual(NamedSharding(mesh, P(bspec, seq_spec, None)))
    if cfg.moe is not None:
        shard_ctx.set_moe_groups(NamedSharding(mesh, P(tuple(mesh.axis_names))))
    if cfg.padded_vocab % mesh.shape["model"] == 0:
        shard_ctx.set_logits(NamedSharding(mesh, P(bspec, None, "model")))


def _jax_block(name) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models import mlp, shard_ctx
    from sharded_scenarios import jax_mesh
    arch, shape = CASES[name]
    cfg = _jax_cfg(arch, shape)
    p = mlp.init_moe(jax.random.PRNGKey(SEED), cfg)
    x, w = inputs(cfg.d_model)

    def oracle(p, x):
        out, aux = mlp.moe_block(p, permute(x, shape), cfg)
        out = unpermute(out, shape, BATCH, SEQ)
        return jnp.sum(out * w) + aux, (out, aux)
    (_l, (out, aux)), (gp, gx) = jax.value_and_grad(oracle, (0, 1), has_aux=True)(p, x)
    res = {"params": _flat(p), "x": x, "w": w,
           "oracle": {"out": np.asarray(out), "aux": float(aux),
                      "grads": {"x": np.asarray(gx), **_flat(gp)}},
           "aux_plain": float(mlp.moe_block(p, x, cfg.with_runtime(moe_groups=1))[1])}
    mesh = jax_mesh(shape, AXES)
    jax_install(mesh, cfg, BATCH)
    try:
        with jax.set_mesh(mesh):
            got, got_aux = jax.jit(lambda p, x: mlp.moe_block(p, x, cfg))(p, x)
    finally:
        shard_ctx.clear()
    res["shard_map"] = {"out": np.asarray(got), "aux": float(got_aux)}
    return res


def run_jax(world: str, out_path: str) -> None:
    import warnings
    warnings.filterwarnings("ignore")
    results = {name: _jax_block(name) for name in WORLDS[world][1]}
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# The port: a gloo world of spawned ranks
# ---------------------------------------------------------------------------


def torch_cfg(arch, shape, **moe):
    import torch
    from repro_torch.configs.registry import get_smoke_config
    cfg = get_smoke_config(arch)
    return cfg.with_runtime(dtype=torch.float32, moe_groups=devices(shape),
                            moe=dataclasses.replace(cfg.moe, **moe))


def install(mesh, cfg, batch: int) -> None:
    """``shard_ctx`` as the reference's ``dryrun.py`` installs it, in the
    port's ``(mesh, placements)`` pairs."""
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import data_axes_of, dp_extent, tp_extent
    from repro_torch.models import shard_ctx
    dpa = data_axes_of(mesh)
    dp_spec = dpa if len(dpa) > 1 else (dpa[0] if dpa else None)
    bspec = dp_spec if batch % dp_extent(mesh) == 0 else None
    seq_spec = "model" if cfg.seq_shard_residual else None
    shard_ctx.set_residual((mesh, shd.placements((bspec, seq_spec, None), mesh)))
    if cfg.moe is not None:
        shard_ctx.set_moe_groups((mesh, shd.placements((tuple(mesh.mesh_dim_names),), mesh)))
    if cfg.padded_vocab % tp_extent(mesh) == 0:
        shard_ctx.set_logits((mesh, shd.placements((bspec, None, "model"), mesh)))


def rank_slices(params: dict, mg) -> dict:
    """The flat expert leaves as this rank holds them: its ``"model"`` F
    slice of every leaf of ``MODEL_DIMS`` under the model group ``mg``."""
    import torch
    return {n: (t if mg is None or n not in MODEL_DIMS
                else torch.chunk(t, mg.size, MODEL_DIMS[n])[mg.index].contiguous())
            for n, t in params.items()}


def block_run(params: dict, x, w, cfg, mesh, dg, mg) -> dict:
    """``moe_block`` on this rank's rows of x under the data and model
    groups, the context installed, and its loss's backward; the output, the
    aux loss and the gradients made whole, and the assignments dropped."""
    import torch
    from repro_torch.models import data_parallel, mlp, shard_ctx, tensor_parallel
    from repro_torch.models import weights
    local = {n: t.clone().requires_grad_() for n, t in rank_slices(params, mg).items()}
    x_l = dg.local_rows(x).clone().requires_grad_()
    install(mesh, cfg, x.shape[0])
    try:
        with data_parallel.use(dg), tensor_parallel.use(mg), mlp.count_drops() as drops:
            out, aux = mlp.moe_block(weights.unflatten(local), x_l, cfg)
            loss = (out * dg.local_rows(w)).sum() + aux / dg.size
            loss.backward()
    finally:
        shard_ctx.clear()
    grads = {"x": dg.all_gather(x_l.grad, 0)}
    for n, t in local.items():
        g = dg.sum(t.grad)
        grads[n] = g if mg is None or n not in MODEL_DIMS else mg.all_gather(g, MODEL_DIMS[n])
    return {"out": dg.all_gather(out.detach(), 0).cpu().numpy(), "aux": float(aux.detach()),
            "grads": {n: g.cpu().numpy() for n, g in grads.items()},
            "routed": drops.routed, "dropped": drops.dropped}


def plain_run(params: dict, x, w, cfg, shape) -> dict:
    """The port's mesh-free ``moe_block`` with ``moe_groups`` the device
    count on x permuted as ``permute`` lays it out, then un-permuted, and
    the gradients of its loss: the oracle on the card."""
    from repro_torch.models import mlp, weights
    nd, M = shape
    B, S, D = x.shape
    leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
    xx = x.clone().requires_grad_()
    xp = xx.reshape(nd, B // nd, M, S // M, D).permute(0, 2, 1, 3, 4).reshape(-1, S // M, D)
    out, aux = mlp.moe_block(weights.unflatten(leaves), xp, cfg)
    out = out.reshape(nd, M, B // nd, S // M, D).permute(0, 2, 1, 3, 4).reshape(B, S, D)
    ((out * w).sum() + aux).backward()
    return {"out": out.detach().cpu().numpy(), "aux": float(aux.detach()),
            "grads": {"x": xx.grad.cpu().numpy(),
                      **{n: t.grad.cpu().numpy() for n, t in leaves.items()}}}


def _block_case(name, ref) -> dict:
    import torch
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    arch, shape = CASES[name]
    cfg = torch_cfg(arch, shape)
    mesh = make_mesh(shape, AXES, "cpu")
    r = ref[name]
    params = {n: torch.from_numpy(v) for n, v in r["params"].items()}
    return block_run(params, torch.from_numpy(r["x"]), torch.from_numpy(r["w"]), cfg, mesh,
                     T.data_group(mesh), T.tp_group(mesh))


def _train_case(arch) -> dict:
    """``train(mesh=make_host_mesh(2, 2))`` with the context installed, and
    on every rank the mesh-free ``train()`` with ``moe_groups`` 4, both at
    ``capacity_factor = n_experts / top_k``; how often each took the
    expert-parallel branch."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import mlp, shard_ctx
    moe = torch_cfg(arch, TRAIN_SHAPE).moe
    cfg = torch_cfg(arch, TRAIN_SHAPE, capacity_factor=moe.n_experts / moe.top_k)
    kw = dict(steps=STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=LR, device="cpu")
    mesh = make_mesh(TRAIN_SHAPE, AXES, "cpu")
    real, taken = mlp._expert_parallel, []

    def counted(*a, **k):
        taken.append(1)
        return real(*a, **k)
    mlp._expert_parallel = counted
    install(mesh, cfg, TRAIN_BATCH)
    try:
        meshed = train(cfg, mesh=mesh, **kw)["losses"]
        ep_calls = len(taken)
        shard_ctx.clear()
        plain = train(cfg, **kw)["losses"]
    finally:
        shard_ctx.clear()
        mlp._expert_parallel = real
    return {"losses": meshed, "plain": plain, "ep_calls": ep_calls,
            "plain_ep_calls": len(taken) - ep_calls}


def torch_rank(rank: int, world: str, store_path: str, out_dir: str, ref_path: str,
               timeout_s: float) -> None:
    from datetime import timedelta

    import torch.distributed as dist
    size, cases = WORLDS[world]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, size),
                            rank=rank, world_size=size,
                            timeout=timedelta(seconds=timeout_s))
    try:
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        results = {name: _block_case(name, ref) for name in cases}
        if world == "four":
            results["train"] = {tag: _train_case(arch) for tag, arch in TRAIN.items()}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":          # the JAX side: world out_path
    run_jax(sys.argv[1], sys.argv[2])


# ---------------------------------------------------------------------------
# The card: two ranks on one CUDA card (tests/test_torch_kernels_card.py)
# ---------------------------------------------------------------------------


def card_rank(rank: int, store_path: str, out_dir: str, timeout_s: float) -> None:
    """One expert-parallel block of smoke olmoe-1b-7b in float32 on a
    (1, 2) mesh of two ranks sharing ``cuda:0`` in a ``gloo`` group (NCCL
    takes one rank per GPU), leaves drawn on the card from seed 0: the
    block (``block_run``) and its oracle (``plain_run``), as numpy."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank,
                            world_size=2, timeout=timedelta(seconds=timeout_s))
    try:
        from repro_torch.launch import train as T
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import mlp, weights
        shape = (1, 2)
        cfg = torch_cfg("olmoe-1b-7b", shape)
        mesh = make_host_mesh(*shape)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = {n: t[0] for n, t in weights.flatten(mlp.init_moe(cfg, gen, "cuda", 1)).items()}
        x, w = (torch.from_numpy(a).cuda() for a in inputs(cfg.d_model))
        got = block_run(params, x, w, cfg, mesh, T.data_group(mesh), T.tp_group(mesh))
        out = {"got": got, "want": plain_run(params, x, w, cfg, shape),
               "cuda": all(t.is_cuda for t in params.values())}
        with open(os.path.join(out_dir, f"ep{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
