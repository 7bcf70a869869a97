"""End-to-end training entry point on one device: the counterpart of
``src/repro/launch/train.py``.

It trains a config with the port's stack: the SA-annotated data pipeline,
the model, AdamW, async checkpointing with exact resume, the straggler
watchdog and step retries.  The reference's mesh, shardings and ZeRO-1
optimizer-state sharding wait for the mesh port (ROADMAP A8).  Runs on
the card unless given ``device="cpu"``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b --smoke \
        --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt
"""

from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.runtime import resolve_device
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models import lm, weights
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


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: str | None = None, ckpt_every: int = 20,
          lr: float = 3e-4, seed: int = 0, log_every: int = 10,
          resume: bool = True, device: torch.device | str = "cuda"):
    device = resolve_device(device)
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=max(steps, 2),
                                warmup_steps=max(steps // 20, 1))
    gen = torch.Generator(device=device).manual_seed(seed)
    model = tfm.init_model(cfg, gen, device)
    opt_state = adamw.init(weights.leaves(model))
    pipe = DataPipeline(cfg, batch, seq, seed=seed, device=device)
    step_fn = make_train_step(cfg, opt_cfg)

    # -- init or resume -------------------------------------------------------
    start = 0
    saver = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        start = ckpt.latest_step(ckpt_dir)
        restored = ckpt.restore(ckpt_dir, start,
                                {"params": model.tree(), "opt": opt_state})
        weights.assign(model, weights.flatten(restored["params"]))
        opt_state = restored["opt"]
        log.info("resumed from step %d", start)

    timer = StepTimer(FaultConfig())
    losses = []
    t_start = time.time()
    for step, hbatch in pipe.iterate(start):
        if step >= steps:
            break

        def one():
            return step_fn(model, opt_state, hbatch)

        t0 = time.time()
        opt_state, metrics = with_retries(one, retries=1)
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
        if saver and done < steps and done % ckpt_every == 0:
            saver.save_async(done, {"params": model, "opt": opt_state},
                             meta={"arch": cfg.name})
    pipe.stop()
    if saver:
        saver.save_async(steps, {"params": model, "opt": opt_state},
                         meta={"arch": cfg.name})
        saver.wait()
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
