"""End-to-end training entry point: the counterpart of
``src/repro/launch/train.py``.

It trains a config with the port's stack: the SA-annotated data pipeline,
the model, AdamW, async checkpointing with exact resume, the straggler
watchdog and step retries.  Runs on the card unless given ``device="cpu"``.

``mesh=`` (a ``(data, model)`` ``DeviceMesh`` from ``launch/mesh.py``)
trains as the reference's ``train(mesh=make_host_mesh(n_data, n_model))``:
SPMD, one process per rank.  What GSPMD does implicitly for the reference
is explicit here.  Data parallelism with ZeRO-1: every rank builds the
same global batch from the seed and keeps its rows
(``shardings.batch_specs``); it computes its rows' share of the global loss
(``models.data_parallel``: global denominator, global MoE statistics and
capacity) and its gradients; each gradient is reduce-scattered over the
data group onto the moment shard ``shardings.zero1_specs`` gives it
(all-reduced where that has no data axis); AdamW updates this rank's slice
of p, m and v (``adamw.update_sharded``); the new slices are all-gathered
over the data group.  Tensor parallelism over ``"model"``: each rank holds
the ``"model"`` slice of every leaf ``shardings.param_specs`` shards there
(``weights.model_slices``) and the forward and backward run on the slices
under the model group (``models.tensor_parallel``: split or gathered per
leaf, ``tensor_parallel.plan``); the moments are those slices cut again by
data, and ``train`` returns the rank's slices.  A rank draws its slices
straight from the seed (``weights.init_slices``), never the whole model,
and a resume draws nothing: it allocates the slices and restores into
them.  m and v are ``DTensor``s; a checkpoint saves parameters and moments
whole (gathered on the main thread, one leaf at a time) and a resume
restores both with their placements.  The expert-parallel MoE dispatch
(``models.shard_ctx``) runs where the caller installs its context, as the
reference's ``launch/dryrun.py`` does; ``train`` installs none, as the
reference's does not.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b --smoke \
        --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt

and in a script started by ``torchrun --nproc-per-node 4``:

    mesh = make_host_mesh(2, 2, device="cpu")
    out = train(get_smoke_config("gemma-7b"), steps=3, batch=4, seq=32,
                mesh=mesh, device="cpu")
"""

from __future__ import annotations

import argparse
import logging
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import sharded
from repro_torch.core.runtime import resolve_device
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import (data_axes_of, dp_extent, model_group, model_index,
                                     tp_extent)
from repro_torch.models import data_parallel, lm, tensor_parallel, weights
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultConfig, StepTimer, with_retries

log = logging.getLogger("repro_torch.train")


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    """``step_fn(model, opt_state, batch) -> (opt_state, metrics)``: loss,
    backward, AdamW (the reference's default ``jnp`` path), then the model
    points at the new parameters.  The model is unchanged if it raises."""
    def step_fn(model: weights.ParamTree, opt_state: adamw.AdamWState, batch):
        model.zero_grad(set_to_none=True)
        loss = lm.loss_fn(model, batch, cfg)
        loss.backward()
        params = weights.leaves(model)
        # a leaf the loss does not reach (the token embedding of an
        # embedding-input batch) has no gradient: zeros, as jax.grad gives
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        new_p, new_s, metrics = adamw.update(params, grads, opt_state, opt_cfg)
        model.zero_grad(set_to_none=True)
        weights.assign(model, new_p)
        return new_s, {"loss": loss.detach(), **metrics}

    return step_fn


def data_group(mesh) -> data_parallel.DataGroup:
    """The ranks of ``mesh``'s data axes (one flattened group, row-major,
    for ("pod", "data")) and this rank's shard."""
    axes = data_axes_of(mesh)
    group, order = sharded.data_group(
        mesh, tuple(mesh.mesh_dim_names.index(a) for a in axes))
    return data_parallel.DataGroup(group=group, size=dp_extent(mesh),
                                   index=sharded.shard_index(mesh, axes), order=tuple(order))


def tp_group(mesh) -> tensor_parallel.ModelGroup | None:
    """The ranks of this rank's ``"model"`` line of ``mesh`` (None where
    the extent is 1)."""
    if tp_extent(mesh) == 1:
        return None
    group, order = model_group(mesh)
    return tensor_parallel.ModelGroup(group=group, size=tp_extent(mesh),
                                      index=model_index(mesh), order=tuple(order))


def mesh_group(mesh):
    """The group of every rank of ``mesh`` (None for one rank): the ranks
    agree over it on the step to resume from and on every retry, and its
    rank 0 writes the checkpoints."""
    if mesh.size() == 1:
        return None
    return sharded.data_group(mesh, tuple(range(mesh.ndim)))[0]


def zero1_layout(mesh, params) -> adamw.Zero1:
    """The layout of the WHOLE ``params`` on ``mesh``: per leaf the dim
    sharded over the data axes (``shardings.zero1_specs``), the moments'
    and the parameters' ``DTensor`` placements and the whole shapes, and
    the group of every rank of the mesh; with a ``"model"`` extent above 1
    also the model group and each leaf's dim sharded over ``"model"``
    (``shardings.model_dims``)."""
    axes = set(data_axes_of(mesh))
    specs = shd.zero1_specs(params, mesh)
    dims = {}
    for name, spec in specs.items():
        named_axes = [(d, {e} if isinstance(e, str) else set(e)) for d, e in enumerate(spec)
                      if e is not None]
        dims[name] = next((d for d, e in named_axes if e & axes), None)
    mg = tp_group(mesh)
    leaves = shd._param_leaves(params)
    return adamw.Zero1(
        mesh=mesh, dg=data_group(mesh), dims=dims, everyone=mesh_group(mesh),
        placements={n: shd.placements(sp, mesh) for n, sp in specs.items()},
        mg=mg, mdims=shd.model_dims(params, mesh) if mg is not None else {},
        shapes={n: t.shape for n, t in leaves.items()},
        param_placements={n: shd.placements(sp, mesh)
                          for n, sp in shd.param_specs(params, mesh).items()})


def rank_params(cfg: ModelConfig, zero: adamw.Zero1, generator: torch.Generator | None,
                device: torch.device) -> weights.ParamTree:
    """This rank's parameters on ``zero.mesh``: its ``"model"`` slices (the
    whole leaves where the extent is 1) drawn straight from ``generator``
    by ``weights.init_slices``, bit-equal to the slices of the mesh-free
    init; with no generator (a resume) the slices allocated, for the
    restore to fill.  No rank holds the whole model."""
    mg = zero.mg
    dims = zero.mdims if mg is not None else dict.fromkeys(zero.shapes)
    index, size = (0, 1) if mg is None else (mg.index, mg.size)
    if generator is not None:
        return weights.init_slices(cfg, generator, device, dims, index, size)
    meta = weights.model_slices(tfm.init_model(cfg, None, "meta"), dims, index, size)
    return weights.ParamTree(weights.unflatten({
        n: torch.empty(p.shape, dtype=p.dtype, device=device)
        for n, p in weights.leaves(meta).items()}))


def local_batch(batch: dict, mesh, dg: data_parallel.DataGroup) -> tuple[dict, bool]:
    """This rank's rows of the global ``batch`` by ``shardings.batch_specs``,
    and whether the rows are sharded (else every rank keeps them all)."""
    specs = shd.batch_specs(batch, mesh)
    dims = {k: next((d for d, e in enumerate(sp) if e is not None), None)
            for k, sp in specs.items()}
    if all(d is None for d in dims.values()):
        return batch, False
    return {k: dg.local_rows(v, dims[k]) for k, v in batch.items()}, True


def make_zero1_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, zero: adamw.Zero1,
                    path: str = "jnp"):
    """``step_fn(model, opt_state, batch) -> (new_params, opt_state,
    metrics)`` on a mesh: ``batch`` is the global batch, ``opt_state``
    ZeRO-1 sharded (``adamw.init_sharded``), ``new_params`` this rank's
    new parameters (its ``"model"`` slices under tensor parallelism, else
    whole), for the caller to assign once every rank's step went through;
    ``path`` is ``adamw.update_sharded``'s.  Rows that do not divide over
    the data ranks stay replicated: each rank then takes 1/size of the
    loss, and the sum over the ranks is the whole gradient again.  Under
    tensor parallelism the forward and the backward run with the model
    group installed, on ``tensor_parallel.view`` of the slices."""
    dg, mg = zero.dg, zero.mg
    table = {} if mg is None else tensor_parallel.plan(cfg, zero.mesh)

    def step_fn(model: weights.ParamTree, opt_state: adamw.AdamWState, batch):
        local, rows_sharded = local_batch(batch, zero.mesh, dg)
        model.zero_grad(set_to_none=True)
        with data_parallel.use(dg if rows_sharded else None), tensor_parallel.use(mg):
            loss = lm.loss_fn(model if mg is None else tensor_parallel.view(model, table, mg),
                              local, cfg)
            if not rows_sharded:
                loss = loss / dg.size
            loss.backward()
        params = weights.leaves(model)
        shards = {}
        for name, p in params.items():        # release each whole gradient
            shards[name] = zero.reduce_scatter(
                torch.zeros_like(p) if p.grad is None else p.grad, name)
            p.grad = None
        new_p, new_s, metrics = adamw.update_sharded(params, shards, opt_state, opt_cfg, zero,
                                                     path)
        new_p = {n: zero.gather(t, n) for n, t in new_p.items()}
        return new_p, new_s, {"loss": dg.sum(loss.detach()), **metrics}

    return step_fn


def _whole_leaf(local: torch.Tensor, placements: tuple, name: str, zero: adamw.Zero1,
                keep: bool) -> torch.Tensor | None:
    """The whole leaf of which ``local`` is this rank's shard (``placements``
    on ``zero.mesh``), on the writer's host (``keep``; None elsewhere):
    one ``gather`` of every rank's shard to the writer over the mesh's
    group (host copies on ``gloo``, which would stage card tensors through
    the host anyway), each shard put where its mesh coordinates place it."""
    group = zero.everyone
    if group is None:
        return local.detach().to("cpu") if keep else None
    t = local.detach().contiguous()
    if dist.get_backend(group) == "gloo":
        t = t.to("cpu")
    ranks = dist.get_process_group_ranks(group)
    parts = [torch.empty_like(t) for _ in ranks] if keep else None
    dist.gather(t, parts, dst=ranks[0], group=group)
    if not keep:
        return None
    out = torch.empty(zero.shapes[name], dtype=t.dtype)
    grid = zero.mesh.mesh
    for g, part in zip(ranks, parts):
        coord = (grid == g).nonzero()[0].tolist()
        view = out
        for d, pl in enumerate(placements):
            if pl.is_shard():
                view = torch.chunk(view, int(zero.mesh.shape[d]), dim=pl.dim)[coord[d]]
        view.copy_(part)
    return out


def _whole_state(state: adamw.AdamWState, zero: adamw.Zero1,
                 keep: bool) -> adamw.AdamWState | None:
    """The sharded moments gathered whole on the host, for a checkpoint:
    every rank takes part, one leaf at a time, and the writer (``keep``)
    assembles each leaf on its host before the next is gathered, so no
    card holds more than its own shards.  Other ranks get None."""
    def whole(d):
        return {n: _whole_leaf(t.to_local(), zero.placements[n], n, zero, keep)
                for n, t in d.items()}
    m, v = whole(state.m), whole(state.v)
    return adamw.AdamWState(step=state.step, m=m, v=v) if keep else None


def _whole_params(model: weights.ParamTree, zero: adamw.Zero1, keep: bool) -> dict | None:
    """The parameters' ``"model"`` slices gathered whole on the writer's
    host (``_whole_state``'s way), as a tree in the reference's layout."""
    flat = {n: _whole_leaf(p, zero.param_placements[n], n, zero, keep)
            for n, p in weights.leaves(model).items()}
    return weights.unflatten(flat) if keep else None


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: str | None = None, ckpt_every: int = 20,
          lr: float = 3e-4, seed: int = 0, mesh=None, log_every: int = 10,
          resume: bool = True, device: torch.device | str = "cuda"):
    device = resolve_device(device)
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=max(steps, 2),
                                warmup_steps=max(steps // 20, 1))
    gen = torch.Generator(device=device).manual_seed(seed)
    zero = group = None
    if mesh is None:
        model = tfm.init_model(cfg, gen, device)
        opt_state = adamw.init(weights.leaves(model))
        step_fn = make_train_step(cfg, opt_cfg)
    else:
        zero = zero1_layout(mesh, tfm.init_model(cfg, None, "meta"))
        step_fn = make_zero1_step(cfg, opt_cfg, zero)
        group = zero.everyone            # every rank of the mesh
    pipe = DataPipeline(cfg, batch, seq, seed=seed, device=device)
    writer = group is None or dist.get_rank(group) == 0     # the rank that writes

    # -- init or resume -------------------------------------------------------
    start = 0
    saver = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir and writer else None
    latest = ckpt.latest_step(ckpt_dir) if ckpt_dir and resume else None
    if group is not None:                    # every rank resumes from one step
        latest = sharded.agree(group, latest)[0]
    if zero is not None:                     # a resume draws no init
        model = rank_params(cfg, zero, gen if latest is None else None, device)
        opt_state = adamw.init_sharded(weights.leaves(model), zero)
    if latest is not None:
        start = latest
        shardings = None
        if zero is not None:
            m = {n: (mesh, zero.placements[n]) for n in opt_state.m}
            shardings = {"opt": adamw.AdamWState(step=None, m=m, v=m)}
            if zero.mg is not None:      # the parameters come back as "model" slices
                shardings["params"] = weights.unflatten(
                    {n: (mesh, pl) for n, pl in zero.param_placements.items()})
        restored = ckpt.restore(ckpt_dir, start, {"params": model.tree(), "opt": opt_state},
                                shardings)
        weights.assign(model, {n: t.to_local() if hasattr(t, "to_local") else t
                               for n, t in weights.flatten(restored["params"]).items()})
        opt_state = restored["opt"]
        log.info("resumed from step %d", start)

    def save(at: int):
        # the moments (and "model" slices) are gathered HERE, on the main
        # thread, by every rank; the checkpointer's thread only writes the
        # host copies
        keep = saver is not None
        state = opt_state if zero is None else _whole_state(opt_state, zero, keep)
        params = model if zero is None or zero.mg is None else _whole_params(model, zero, keep)
        if saver is not None:
            saver.save_async(at, {"params": params, "opt": state}, meta={"arch": cfg.name})

    agree = None if group is None else (lambda outcome: sharded.agree(group, outcome))
    timer = StepTimer(FaultConfig())
    losses = []
    t_start = time.time()
    for step, hbatch in pipe.iterate(start):
        if step >= steps:
            break

        def one():
            return step_fn(model, opt_state, hbatch)

        t0 = time.time()
        if zero is None:
            opt_state, metrics = with_retries(one, retries=1)
        else:
            new_p, opt_state, metrics = with_retries(one, retries=1, agree=agree)
            weights.assign(model, new_p)
        loss = float(metrics["loss"])
        timer.record(step, time.time() - t0)
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            log.info("step %d loss %.4f lr %.2e gnorm %.2f (%.2fs)",
                     step, loss, float(metrics["lr"]),
                     float(metrics["grad_norm"]), time.time() - t0)
        # A checkpoint is labelled with the number of steps it holds, so a
        # resume from it starts at the next step.  (The reference labels a
        # mid-run save with the step just taken, which a resume repeats.)
        done = step + 1
        if ckpt_dir and done < steps and done % ckpt_every == 0:
            save(done)
    pipe.stop()
    if ckpt_dir:
        save(steps)
        if saver is not None:
            saver.wait()
        if group is not None:               # no rank returns before the save
            dist.barrier(group)
    wall = time.time() - t_start
    return {"params": model, "opt_state": opt_state, "losses": losses,
            "wall_s": wall, "stragglers": timer.stragglers}


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = (get_smoke_config(args.arch) if args.smoke else get_config(args.arch))
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                lr=args.lr, resume=not args.no_resume, device=args.device)
    print(f"final loss {out['losses'][-1]:.4f} "
          f"(first {out['losses'][0]:.4f}) in {out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
