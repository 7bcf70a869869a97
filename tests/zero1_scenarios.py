"""ZeRO-1 data-parallel training, run by both packages.

The reference's ``train(cfg, steps=3, batch=4, seq=32, mesh=...)`` runs in
ONE subprocess per device count (``run_jax``: forced host devices, meshes
with Auto axes as ``sharded_scenarios.jax_mesh`` builds them); it writes,
per case, its initial parameters (``train(steps=0)``: the values its
``train`` starts from), the three losses, the final parameters and the
local shape of every moment's shard.  The port's ``train(mesh=...)`` then
runs in a ``gloo`` world of spawned ranks (``torch_rank``) from the
reference's initial parameters: a step-0 checkpoint of them, which
``train`` resumes from.  The port's worlds also run the checks that have
no reference counterpart: resume, a one-rank step fault, the MoE
statistics under the data group, the global norm and a masked batch (the
reference's loss and update on the whole batch, computed in the JAX
subprocess).

This module imports neither JAX nor torch at import time.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

#: ``train``'s steps, global batch, sequence and lr: at lr 1e-2 (the
#: schedule's 1e-2, 5.5e-3, 1e-3 over the three steps) Adam moves every
#: element by about 1e-2 in all, ten times the parameter tolerance
STEPS, BATCH, SEQ, LR = 3, 4, 32, 1e-2

#: case -> (arch, mesh shape, mesh axes, runtime overrides); every case in
#: float32, so that the packages agree to float32 rounding
CASES = {
    "gemma_2x1": ("gemma-7b", (2, 1), ("data", "model"), {}),
    "olmoe_groups1_2x1": ("olmoe-1b-7b", (2, 1), ("data", "model"), {"moe_groups": 1}),
    "olmoe_groups2_2x1": ("olmoe-1b-7b", (2, 1), ("data", "model"), {"moe_groups": 2}),
    "qwen2vl_2x1": ("qwen2-vl-2b", (2, 1), ("data", "model"), {}),
    "gemma_4x1": ("gemma-7b", (4, 1), ("data", "model"), {}),
    "gemma_pod_2x2x1": ("gemma-7b", (2, 2, 1), ("pod", "data", "model"), {}),
    "gemma_rows3_2x1": ("gemma-7b", (2, 1), ("data", "model"), {}),
}
#: device counts -> the cases that run there
WORLDS = {2: ("gemma_2x1", "olmoe_groups1_2x1", "olmoe_groups2_2x1", "qwen2vl_2x1",
              "gemma_rows3_2x1"),
          4: ("gemma_4x1", "gemma_pod_2x2x1")}
#: global batches other than ``BATCH``: 3 rows do not divide over 2 ranks,
#: so every rank keeps them all (the reference's batch spec replicates)
BATCHES = {"gemma_rows3_2x1": 3}
#: leaves that get no gradient, which only weight decay moves: qwen2-vl's
#: embedding table (its inputs are embeddings and its head is untied)
DECAY_ONLY = {"qwen2vl_2x1": ("embed",)}
#: the masked batch: rows' masks keep different token counts, so per-rank
#: means differ from the global one
MASK_CASE = "gemma_2x1"
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=12)


def mask_for(batch: int, seq: int) -> np.ndarray:
    m = np.ones((batch, seq + 1), np.float32)
    m[0, 5:] = 0.0
    m[1, 20:] = 0.0
    m[3, :9] = 0.0
    return m


def _dotted(path) -> str:
    out = []
    for e in path:
        for attr in ("key", "idx", "name"):
            if hasattr(e, attr):
                out.append(str(getattr(e, attr)))
                break
    return ".".join(out)


# ---------------------------------------------------------------------------
# The reference: one subprocess per device count
# ---------------------------------------------------------------------------


def _jax_cfg(name):
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config
    arch, _shape, _axes, over = CASES[name]
    return get_smoke_config(arch).with_runtime(dtype=jnp.float32, **over)


def _flat_np(tree) -> dict:
    import jax
    return {_dotted(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def run_jax(n_devices: int, out_path: str) -> None:
    import warnings
    warnings.filterwarnings("ignore")
    import jax
    from repro.data.pipeline import DataPipeline
    from repro.launch.train import train
    from repro.models import lm
    from repro.optim import adamw
    from sharded_scenarios import jax_mesh

    results = {}
    for name in WORLDS[n_devices]:
        _arch, shape, axes, _over = CASES[name]
        cfg = _jax_cfg(name)
        mesh = jax_mesh(shape, axes)
        batch = BATCHES.get(name, BATCH)
        init = train(cfg, steps=0, batch=batch, seq=SEQ, mesh=mesh)["params"]
        out = train(cfg, steps=STEPS, batch=batch, seq=SEQ, lr=LR, mesh=mesh)
        shards = {_dotted(p): tuple(v.addressable_shards[0].data.shape)
                  for p, v in jax.tree_util.tree_flatten_with_path(out["opt_state"].m)[0]}
        results[name] = {"init": _flat_np(init), "losses": [float(x) for x in out["losses"]],
                         "params": _flat_np(out["params"]), "moment_shards": shards}
        if name == MASK_CASE:                 # one masked step on the whole batch
            batch = dict(DataPipeline(cfg, BATCH, SEQ, seed=0).batch_for_step(0))
            batch["mask"] = mask_for(BATCH, SEQ)
            loss, grads = jax.value_and_grad(lm.loss_fn)(init, batch, cfg)
            new_p, _s, m = adamw.update(init, grads, adamw.init(init),
                                        adamw.AdamWConfig(**OPT))
            results["masked"] = {"loss": float(loss), "params": _flat_np(new_p),
                                 "grad_norm": float(m["grad_norm"])}
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# The port: a gloo world of spawned ranks
# ---------------------------------------------------------------------------


def _torch_cfg(name):
    import torch
    from repro_torch.configs.registry import get_smoke_config
    arch, _shape, _axes, over = CASES[name]
    return get_smoke_config(arch).with_runtime(dtype=torch.float32, **over)


def _start_from(init: dict, cfg, ckpt_dir: str) -> None:
    """A step-0 checkpoint of the reference's initial parameters and zero
    moments (written by rank 0), which ``train`` resumes from."""
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.models import weights
    from repro_torch.optim import adamw
    if dist.get_rank() == 0:
        model = weights.from_numpy(weights.unflatten(init), cfg, "cpu")
        ckpt.save(ckpt_dir, 0, {"params": model,
                                "opt": adamw.init(weights.leaves(model))})
    dist.barrier()


def _params_np(model) -> dict:
    return {n: p.detach().float().numpy() for n, p in sorted(model.named_parameters())}


def _train_case(name, ref, root, *, steps=STEPS, tag="", fresh=True) -> dict:
    """``train(mesh=...)`` of ``name`` in its own checkpoint directory,
    from the reference's initial parameters (``fresh``) or from the
    directory's latest checkpoint."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    _arch, shape, axes, _over = CASES[name]
    cfg = _torch_cfg(name)
    d = os.path.join(root, f"{name}{tag}")
    if fresh:
        _start_from(ref[name]["init"], cfg, d)
    out = train(cfg, steps=steps, batch=BATCHES.get(name, BATCH), seq=SEQ, lr=LR,
                mesh=make_mesh(shape, axes, "cpu"), ckpt_dir=d, ckpt_every=2, device="cpu")
    m = out["opt_state"].m
    return {"losses": out["losses"], "params": _params_np(out["params"]),
            "moment_shards": {n: tuple(t.to_local().shape) for n, t in m.items()},
            "placements": {n: tuple(str(p) for p in t.placements) for n, t in m.items()}}


def _masked_step(ref, root) -> dict:
    """One ZeRO-1 step on the masked global batch from the reference's
    initial parameters."""
    import torch
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import weights
    from repro_torch.optim import adamw
    _arch, shape, axes, _over = CASES[MASK_CASE]
    cfg = _torch_cfg(MASK_CASE)
    model = weights.from_numpy(weights.unflatten(ref[MASK_CASE]["init"]), cfg, "cpu")
    zero = T.zero1_layout(make_mesh(shape, axes, "cpu"), model)
    batch = dict(DataPipeline(cfg, BATCH, SEQ, seed=0, device="cpu").batch_for_step(0))
    batch["mask"] = torch.from_numpy(mask_for(BATCH, SEQ))
    step = T.make_zero1_step(cfg, adamw.AdamWConfig(**OPT), zero)
    new_p, _s, metrics = step(model, adamw.init_sharded(weights.leaves(model), zero), batch)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": {n: t.float().numpy() for n, t in new_p.items()}}


def _moe_statistics() -> dict:
    """``moe_block`` under the two-rank data group against the same block on
    the whole batch in one process: every rank's output rows and the aux
    loss, and the gradients (each rank's loss its rows' plus half the aux,
    the parameter gradients summed over the ranks), for ``moe_groups`` 1
    (tokens gathered) and 2 (each rank's rows a whole group)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import data_parallel, mlp
    from repro_torch.models import transformer as tfm
    out = {}
    for groups in (1, 2):
        cfg = _torch_cfg("olmoe_groups1_2x1").with_runtime(moe_groups=groups)
        gen = torch.Generator().manual_seed(3)
        p = {k: v.detach()[0].clone().requires_grad_(True)
             for k, v in tfm.init_model(cfg, gen, "cpu")["layers"]["moe"].items()
             if not hasattr(v, "items")}
        x = torch.randn(BATCH, 16, cfg.d_model, generator=gen)
        w = torch.randn(BATCH, 16, cfg.d_model, generator=gen)
        want, want_aux = mlp.moe_block(p, x, cfg)
        (want * w).sum().add(want_aux).backward()
        want_g = {k: v.grad.clone() for k, v in p.items()}
        for v in p.values():
            v.grad = None
        dg = T.data_group(make_mesh((2, 1), ("data", "model"), "cpu"))
        with data_parallel.use(dg):
            got, aux = mlp.moe_block(p, dg.local_rows(x), cfg)
            (got * dg.local_rows(w)).sum().add(aux / dg.size).backward()
        errs = {"out": float((got - dg.local_rows(want)).detach().abs().max()),
                "aux": abs(float(aux) - float(want_aux))}
        for k, v in p.items():
            g = v.grad.clone()
            dist.all_reduce(g)
            errs[f"grad/{k}"] = float((g - want_g[k]).abs().max() / want_g[k].abs().max())
        out[f"groups{groups}"] = errs
    return out


def _backward_on_another_thread(ref) -> dict:
    """olmoe's loss (remat on, ``moe_groups`` 1: tokens gathered) on this
    rank's rows under the two-rank data group, its backward run on a thread
    of its own, as CUDA's autograd engine runs it on its device thread:
    every ``route`` call, the forward's and each layer's recompute, routes
    the whole batch's tokens (``moe_block`` saw the group and gathered
    them), and the gradients equal those of the backward on the calling
    thread, bit for bit."""
    import threading

    import torch
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import data_parallel, lm, mlp, weights
    name = "olmoe_groups1_2x1"
    cfg = _torch_cfg(name)
    mesh = make_mesh((2, 1), ("data", "model"), "cpu")
    dg = T.data_group(mesh)
    model = weights.from_numpy(weights.unflatten(ref[name]["init"]), cfg, "cpu")
    batch = dict(DataPipeline(cfg, BATCH, SEQ, seed=0, device="cpu").batch_for_step(0))
    local, _sharded = T.local_batch(batch, mesh, dg)
    calls, errors = [], []
    real = mlp.route

    def spy(p, xt, c, g=None):
        calls.append(xt.shape[0])
        return real(p, xt, c, g)

    def grads(backward) -> dict:
        model.zero_grad(set_to_none=True)
        with data_parallel.use(dg):
            backward(lm.loss_fn(model, local, cfg))
        return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    def on_a_thread(loss):
        def run():
            try:
                loss.backward()
            except Exception as e:         # reported to the test, not swallowed
                errors.append(f"{type(e).__name__}: {e}")
        t = threading.Thread(target=run)
        t.start()
        t.join()

    want = grads(lambda loss: loss.backward())
    mlp.route = spy
    try:
        got = grads(on_a_thread)
    finally:
        mlp.route = real
    return {"remat": cfg.remat, "n_layers": cfg.n_layers, "route_tokens": calls,
            "errors": errors,
            "grads_equal": set(got) == set(want)
            and all(torch.equal(got[n], want[n]) for n in want)}


def _checkpoint_moments() -> dict:
    """``train._whole_state`` of ZeRO-1 moments: the writer gets every leaf
    whole, as a host tensor equal to the whole it was sliced from; the
    other ranks get None."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(11)
    whole = {"a": torch.randn(8, 3, generator=gen), "b": torch.randn(3, generator=gen)}
    zero = T.zero1_layout(make_mesh((2, 1), ("data", "model"), "cpu"), whole)
    m = {n: zero.dtensor(zero.local(t, n).clone(), n) for n, t in whole.items()}
    v = {n: zero.dtensor(zero.local(2 * t, n).clone(), n) for n, t in whole.items()}
    keep = dist.get_rank() == 0
    got = T._whole_state(adamw.AdamWState(step=torch.ones((), dtype=torch.int32), m=m, v=v),
                         zero, keep)
    if not keep:
        return {"none": got is None}
    return {"none": got is None, "dims": dict(zero.dims),
            "equal": all(torch.equal(got.m[n], t) and torch.equal(got.v[n], 2 * t)
                         and got.m[n].device.type == "cpu" for n, t in whole.items())}


def _global_norm() -> dict:
    """``Zero1.norm`` of reduce-scattered slices against the norm of the
    whole summed gradients (replicated leaves counted once)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(5 + dist.get_rank())
    grads = {"a": torch.randn(8, 3, generator=gen), "b": torch.randn(3, generator=gen),
             "c": torch.randn(3, 6, generator=gen)}
    zero = T.zero1_layout(make_mesh((2, 1), ("data", "model"), "cpu"), grads)
    shards = {n: zero.reduce_scatter(g, n) for n, g in grads.items()}
    whole = {}
    for n, g in grads.items():
        s = g.clone()
        dist.all_reduce(s)
        whole[n] = s
    return {"dims": dict(zero.dims), "norm": float(zero.norm(shards)),
            "want": float(adamw.global_norm(whole))}


def _rank1_raises(error: Exception):
    """A ``make_zero1_step`` whose step 2 on rank 1 raises ``error`` once,
    after the step's last collective."""
    import torch.distributed as dist
    from repro_torch.launch import train as T
    real = T.make_zero1_step
    fired = []

    def faulty(*a, **kw):
        step = real(*a, **kw)

        def run(model, state, batch):
            out = step(model, state, batch)
            if dist.get_rank() == 1 and int(out[1].step) == 2 and not fired:
                fired.append(1)
                raise error
            return out
        return run
    return faulty


def _fault(ref, root, clean: dict) -> dict:
    """Rank 1's step 2 raises a transient error after its last collective:
    both ranks retry the step, and the run equals the one without the
    fault."""
    from repro_torch.core import resilience
    from repro_torch.launch import train as T
    real = T.make_zero1_step
    before = resilience.stats["step_retries"]
    T.make_zero1_step = _rank1_raises(RuntimeError("injected step fault on rank 1"))
    try:
        got = _train_case("gemma_2x1", ref, root, tag="_fault")
    finally:
        T.make_zero1_step = real
    return {"retries": resilience.stats["step_retries"] - before,
            "losses_equal": got["losses"] == clean["losses"],
            "params_equal": all(np.array_equal(got["params"][n], v)
                                for n, v in clean["params"].items())}


def _fatal(ref, root) -> str:
    """Rank 1's step 2 raises a programming error: no rank retries, every
    rank raises (rank 1 its error, the others ``StepFailure``).  Returns
    the exception's class name on this rank."""
    from repro_torch.launch import train as T
    real = T.make_zero1_step
    T.make_zero1_step = _rank1_raises(ValueError("injected bug on rank 1"))
    try:
        _train_case("gemma_2x1", ref, root, tag="_fatal")
    except Exception as e:           # the scenario's outcome, compared by the test
        return type(e).__name__
    finally:
        T.make_zero1_step = real
    return "none"


def _resume(ref, root, clean: dict) -> dict:
    """The three-step run's step-2 checkpoint copied to a directory of its
    own and resumed: step 3's loss and the final parameters equal the
    uninterrupted run's, bit for bit."""
    import shutil

    import torch.distributed as dist
    d = os.path.join(root, "gemma_2x1_resume")
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(root, "gemma_2x1", "step_00000002"),
                        os.path.join(d, "step_00000002"))
    dist.barrier()
    got = _train_case("gemma_2x1", ref, root, tag="_resume", fresh=False)
    return {"n_losses": len(got["losses"]),
            "loss_equal": got["losses"][-1] == clean["losses"][-1],
            "params_equal": all(np.array_equal(got["params"][n], v)
                                for n, v in clean["params"].items())}


def torch_rank(rank: int, world: int, store_path: str, out_dir: str, ref_path: str,
               timeout_s: float) -> None:
    from datetime import timedelta

    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        root = os.path.join(out_dir, "ckpt")
        results = {name: _train_case(name, ref, root) for name in WORLDS[world]}
        if world == 2:
            results["masked"] = _masked_step(ref, root)
            results["moe_statistics"] = _moe_statistics()
            results["global_norm"] = _global_norm()
            results["backward_thread"] = _backward_on_another_thread(ref)
            results["checkpoint_moments"] = _checkpoint_moments()
            results["fault"] = _fault(ref, root, results["gemma_2x1"])
            results["fatal"] = _fatal(ref, root)
            results["resume"] = _resume(ref, root, results["gemma_2x1"])
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":          # the JAX side: n_devices out_path
    run_jax(int(sys.argv[1]), sys.argv[2])
