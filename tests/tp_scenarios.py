"""Tensor-parallel training over ``"model"``, run by both packages.

The reference's ``train(cfg, steps=3, batch=4, seq=32, mesh=...)`` on a
``(data, model)`` mesh runs in ONE subprocess per world (``WORLDS``: a
test file's cases; ``run_jax``: forced host devices, Auto-axis meshes); it
writes, per case,
its initial parameters, the three losses, the final parameters and the
local shape of every parameter's and moment's shard.  The port's
``train(mesh=...)`` then runs in a ``gloo`` world of spawned ranks
(``torch_rank``) from the reference's initial parameters (a step-0
checkpoint, which ``train`` resumes from, as ``zero1_scenarios`` does).
The port's worlds also run what has no reference counterpart: resume, a
one-rank step fault, and a masked batch (the reference's loss and update
on the whole batch, computed in the JAX subprocess).  ``card_rank`` is a
rank of the card test's two-rank world on one CUDA card.

Every case is float32 at lr 1e-2, as ``zero1_scenarios``'s.

This module imports neither JAX nor torch at import time.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

import zero1_scenarios as Z

STEPS, BATCH, SEQ, LR = Z.STEPS, Z.BATCH, Z.SEQ, Z.LR

#: the registry's ids, in ``configs.registry.ARCH_IDS`` order
ARCHS = ("gemma-7b", "internlm2-20b", "granite-34b", "gemma3-4b", "olmoe-1b-7b",
         "deepseek-moe-16b", "hymba-1.5b", "rwkv6-1.6b", "qwen2-vl-2b",
         "seamless-m4t-large-v2")

#: case -> (arch, mesh shape, runtime overrides); axes ("data", "model")
CASES = {
    **{f"{a}_1x2": (a, (1, 2), {}) for a in ARCHS},
    "gemma-7b_2x2": ("gemma-7b", (2, 2), {}),
    "olmoe-1b-7b_2x2": ("olmoe-1b-7b", (2, 2), {"moe_groups": 1}),
    "olmoe-1b-7b_groups2_2x2": ("olmoe-1b-7b", (2, 2), {"moe_groups": 2}),
    "qwen2-vl-2b_2x2": ("qwen2-vl-2b", (2, 2), {}),
    "internlm2-20b_1x4": ("internlm2-20b", (1, 4), {}),
    "granite-34b_1x4": ("granite-34b", (1, 4), {}),
}
#: world -> (ranks, the cases that run there); a world per test file, so
#: that each file's reference subprocess and ranks stay well inside its time
WORLDS = {
    "dense": (2, tuple(f"{a}_1x2" for a in ARCHS[:4] + ("qwen2-vl-2b",))),
    "families": (2, tuple(f"{a}_1x2" for a in ARCHS[4:8] + ("seamless-m4t-large-v2",))),
    "mesh": (4, ("gemma-7b_2x2", "olmoe-1b-7b_2x2", "olmoe-1b-7b_groups2_2x2",
                 "qwen2-vl-2b_2x2", "internlm2-20b_1x4", "granite-34b_1x4")),
}
#: leaves that get no gradient, which only weight decay moves
DECAY_ONLY = {"qwen2-vl-2b_1x2": ("embed",), "qwen2-vl-2b_2x2": ("embed",)}
#: the masked batch's case (``zero1_scenarios.mask_for``), on both axes, in
#: the "mesh" world
MASK_CASE = "gemma-7b_2x2"
#: the case resumed and faulted, in the "dense" world
RESUME_CASE = "gemma-7b_1x2"
AXES = ("data", "model")


# ---------------------------------------------------------------------------
# The reference: one subprocess per world
# ---------------------------------------------------------------------------


def _jax_cfg(name):
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config
    arch, _shape, over = CASES[name]
    return get_smoke_config(arch).with_runtime(dtype=jnp.float32, **over)


def _shard_shapes(tree) -> dict:
    import jax
    return {Z._dotted(p): tuple(v.addressable_shards[0].data.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def run_jax(world: str, out_path: str) -> None:
    import warnings
    warnings.filterwarnings("ignore")
    import jax
    from repro.data.pipeline import DataPipeline
    from repro.launch.train import train
    from repro.models import lm
    from repro.optim import adamw
    from sharded_scenarios import jax_mesh

    results = {}
    for name in WORLDS[world][1]:
        _arch, shape, _over = CASES[name]
        cfg = _jax_cfg(name)
        mesh = jax_mesh(shape, AXES)
        init = train(cfg, steps=0, batch=BATCH, seq=SEQ, mesh=mesh)["params"]
        out = train(cfg, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, mesh=mesh)
        results[name] = {"init": Z._flat_np(init), "losses": [float(x) for x in out["losses"]],
                         "params": Z._flat_np(out["params"]),
                         "param_shards": _shard_shapes(out["params"]),
                         "moment_shards": _shard_shapes(out["opt_state"].m)}
        if name == MASK_CASE:                 # one masked step on the whole batch
            batch = dict(DataPipeline(cfg, BATCH, SEQ, seed=0).batch_for_step(0))
            batch["mask"] = Z.mask_for(BATCH, SEQ)
            loss, grads = jax.value_and_grad(lm.loss_fn)(init, batch, cfg)
            new_p, _s, m = adamw.update(init, grads, adamw.init(init),
                                        adamw.AdamWConfig(**Z.OPT))
            results["masked"] = {"loss": float(loss), "params": Z._flat_np(new_p),
                                 "grad_norm": float(m["grad_norm"])}
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# The port: a gloo world of spawned ranks
# ---------------------------------------------------------------------------


def _torch_cfg(name):
    import torch
    from repro_torch.configs.registry import get_smoke_config
    arch, _shape, over = CASES[name]
    return get_smoke_config(arch).with_runtime(dtype=torch.float32, **over)


def _whole(model, cfg, mesh) -> dict:
    """The ``"model"`` slices of ``model`` gathered whole on every rank, as
    numpy arrays."""
    from repro_torch.launch import train as T
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    zero = T.zero1_layout(mesh, tfm.init_model(cfg, None, "meta"))
    out = {}
    for n, p in weights.leaves(model).items():
        d = zero.mdims[n]
        out[n] = (p if d is None else zero.mg.all_gather(p.detach(), d)).detach().float().numpy()
    return out


def _train_case(name, ref, root, *, steps=STEPS, tag="", fresh=True) -> dict:
    """``train(mesh=...)`` of ``name`` in its own checkpoint directory,
    from the reference's initial parameters (``fresh``) or from the
    directory's latest checkpoint."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    _arch, shape, _over = CASES[name]
    cfg = _torch_cfg(name)
    d = os.path.join(root, f"{name}{tag}")
    if fresh:
        Z._start_from(ref[name]["init"], cfg, d)
    mesh = make_mesh(shape, AXES, "cpu")
    out = train(cfg, steps=steps, batch=BATCH, seq=SEQ, lr=LR, mesh=mesh, ckpt_dir=d,
                ckpt_every=2, device="cpu")
    m = out["opt_state"].m
    return {"losses": out["losses"], "params": _whole(out["params"], cfg, mesh),
            "param_shards": {n: tuple(p.shape) for n, p in out["params"].named_parameters()},
            "moment_shards": {n: tuple(t.to_local().shape) for n, t in m.items()},
            "placements": {n: tuple(str(p) for p in t.placements) for n, t in m.items()}}


def _masked_step(ref) -> dict:
    """One step of ``MASK_CASE``'s mesh on the masked global batch from the
    reference's initial parameters; the new parameters gathered whole."""
    import torch
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import weights
    from repro_torch.optim import adamw
    _arch, shape, _over = CASES[MASK_CASE]
    cfg = _torch_cfg(MASK_CASE)
    mesh = make_mesh(shape, AXES, "cpu")
    whole = weights.from_numpy(weights.unflatten(ref[MASK_CASE]["init"]), cfg, "cpu")
    zero = T.zero1_layout(mesh, whole)
    model = weights.model_slices(whole, zero.mdims, zero.mg.index, zero.mg.size)
    batch = dict(DataPipeline(cfg, BATCH, SEQ, seed=0, device="cpu").batch_for_step(0))
    batch["mask"] = torch.from_numpy(Z.mask_for(BATCH, SEQ))
    step = T.make_zero1_step(cfg, adamw.AdamWConfig(**Z.OPT), zero)
    new_p, _s, metrics = step(model, adamw.init_sharded(weights.leaves(model), zero), batch)
    weights.assign(model, new_p)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": _whole(model, cfg, mesh)}


def _fault(ref, root, clean: dict) -> dict:
    """Rank 1's step 2 raises a transient error after its last collective:
    every rank of the mesh retries the step, and the run equals the one
    without the fault."""
    from repro_torch.core import resilience
    from repro_torch.launch import train as T
    real = T.make_zero1_step
    before = resilience.stats["step_retries"]
    T.make_zero1_step = Z._rank1_raises(RuntimeError("injected step fault on rank 1"))
    try:
        got = _train_case(RESUME_CASE, ref, root, tag="_fault")
    finally:
        T.make_zero1_step = real
    return {"retries": resilience.stats["step_retries"] - before,
            "losses_equal": got["losses"] == clean["losses"],
            "params_equal": all(np.array_equal(got["params"][n], v)
                                for n, v in clean["params"].items())}


def _resume(ref, root, clean: dict) -> dict:
    """The three-step run's step-2 checkpoint copied to a directory of its
    own and resumed: step 3's loss and the final parameters equal the
    uninterrupted run's, bit for bit."""
    import shutil

    import torch.distributed as dist
    d = os.path.join(root, f"{RESUME_CASE}_resume")
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(root, RESUME_CASE, "step_00000002"),
                        os.path.join(d, "step_00000002"))
    dist.barrier()
    got = _train_case(RESUME_CASE, ref, root, tag="_resume", fresh=False)
    return {"n_losses": len(got["losses"]),
            "loss_equal": got["losses"][-1] == clean["losses"][-1],
            "params_equal": all(np.array_equal(got["params"][n], v)
                                for n, v in clean["params"].items())}


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
        root = os.path.join(out_dir, "ckpt")
        results = {name: _train_case(name, ref, root) for name in cases}
        if RESUME_CASE in cases:
            results["fault"] = _fault(ref, root, results[RESUME_CASE])
            results["resume"] = _resume(ref, root, results[RESUME_CASE])
        if MASK_CASE in cases:
            results["masked"] = _masked_step(ref)
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
    """One tensor-parallel step of gemma-7b's smoke config in float32 on a
    (1, 2) mesh of two ranks sharing ``cuda:0`` in a ``gloo`` group (NCCL
    takes one rank per GPU), by both AdamW paths from the same parameters:
    the losses, the fused AdamW launches of the kernel path, the largest
    relative difference of the two paths' new slices; rank 0 also takes the
    mesh-free step of ``make_train_step``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank,
                            world_size=2, timeout=timedelta(seconds=timeout_s))
    try:
        from repro_torch.configs.registry import get_smoke_config
        from repro_torch.data.pipeline import DataPipeline
        from repro_torch.kernels import fused_adamw as fa
        from repro_torch.launch import train as T
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import transformer as tfm
        from repro_torch.models import weights
        from repro_torch.optim import adamw
        cfg = get_smoke_config("gemma-7b").with_runtime(dtype=torch.float32)
        opt = adamw.AdamWConfig(**Z.OPT)
        mesh = make_host_mesh(1, 2)
        batch = DataPipeline(cfg, BATCH, SEQ, seed=0, device="cuda").batch_for_step(0)

        def whole():
            return tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        zero = T.zero1_layout(mesh, whole())
        out = {}
        for path in ("jnp", "kernel"):
            model = weights.model_slices(whole(), zero.mdims, zero.mg.index, zero.mg.size)
            state = adamw.init_sharded(weights.leaves(model), zero)
            before = fa.fused_adamw.launches
            new_p, _s, metrics = T.make_zero1_step(cfg, opt, zero, path)(model, state, batch)
            torch.cuda.synchronize()
            out[path] = {"loss": float(metrics["loss"]),
                         "launches": fa.fused_adamw.launches - before,
                         "params": {n: t.detach() for n, t in new_p.items()},
                         "cuda": all(t.is_cuda for t in new_p.values())}
        out["leaves"] = len(out["jnp"]["params"])
        out["kernel_vs_jnp"] = max(
            float(((out["kernel"]["params"][n] - p).abs().max() / p.abs().max()))
            for n, p in out["jnp"]["params"].items())
        for path in ("jnp", "kernel"):
            del out[path]["params"]
        if rank == 0:
            model = whole()
            _s, metrics = T.make_train_step(cfg, opt)(model, adamw.init(weights.leaves(model)),
                                                      batch)
            out["mesh_free_loss"] = float(metrics["loss"])
        with open(os.path.join(out_dir, f"card{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def cards_rank(rank: int, world: int, store_path: str, out_dir: str, timeout_s: float) -> None:
    """One rank per card in an NCCL group (tests/test_torch_kernels_card.py,
    four cards): ``train(mesh=make_host_mesh(2, 2))`` of gemma-7b's smoke
    config in float32 for 3 steps with checkpoints at steps 2 and 3, then
    the step-3 checkpoint removed and ``train`` again from the directory;
    rank 0 also trains mesh-free.  Writes the losses, the resumed loss and
    whether the resumed run's slices equal the uninterrupted run's."""
    import shutil
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s),
                            device_id=torch.device("cuda", rank))
    try:
        from repro_torch.configs.registry import get_smoke_config
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.train import train
        cfg = get_smoke_config("gemma-7b").with_runtime(dtype=torch.float32)
        kw = dict(steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, device="cuda")
        mesh = make_host_mesh(2, 2)
        d = os.path.join(out_dir, "ckpt")
        full = train(cfg, mesh=mesh, ckpt_dir=d, ckpt_every=2, **kw)
        want = {n: p.detach().clone() for n, p in full["params"].named_parameters()}
        dist.barrier()
        if rank == 0:
            shutil.rmtree(os.path.join(d, f"step_{STEPS:08d}"))
        dist.barrier()
        again = train(cfg, mesh=mesh, ckpt_dir=d, ckpt_every=2, **kw)
        out = {"losses": full["losses"], "resumed": again["losses"],
               "backend": dist.get_backend(),
               "params_equal": all(torch.equal(p.detach(), want[n])
                                   for n, p in again["params"].named_parameters()),
               "slices": {n: tuple(p.shape) for n, p in again["params"].named_parameters()}}
        if rank == 0:
            out["mesh_free"] = train(cfg, **kw)["losses"]
        with open(os.path.join(out_dir, f"cards{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
