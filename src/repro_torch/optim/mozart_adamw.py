"""AdamW expressed as a Mozart (split-annotation) pipeline — the paper's
technique applied to training.  The counterpart of
``src/repro/optim/mozart_adamw.py``.

The update for one parameter tensor is ~12 elementwise vector ops.  Run as
plain library calls, every op round-trips the whole tensor through device
memory.  Here each op is an *annotated* black-box function; Mozart plans
the chains into stages (leaves of equal size share one) and, with the
``cuda`` executor, runs each stage as one launch of the split-pipeline
kernel, so only the stage's inputs and outputs touch device memory.  The
default ``scan`` executor drives cache-sized chunks through each stage.
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core import annotated_numpy as anp
from repro_torch.core import mozart
from repro_torch.optim.adamw import AdamWConfig, AdamWState, global_norm, schedule


def _chain(p1, g1, m1, v1, cfg: AdamWConfig, *, gscale: float, lr: float,
           c1: float, c2: float):
    """One leaf's update as 12 annotated black-box vector ops; returns the
    futures of the new (p, m, v).  The intermediates' futures die on
    return, so they stay inside the stage: only p, m and v escape to device
    memory.  (The reference builds the chain in its loop body, where the
    last leaf's intermediates are still referenced when the session ends
    and escape as extra stage outputs.)"""
    gs = anp.multiply(g1, gscale)
    mn = anp.add(anp.multiply(m1, cfg.b1), anp.multiply(gs, 1 - cfg.b1))
    g2 = anp.multiply(gs, gs)
    vn = anp.add(anp.multiply(v1, cfg.b2), anp.multiply(g2, 1 - cfg.b2))
    mhat = anp.multiply(mn, c1)
    denom = anp.add(anp.sqrt(anp.multiply(vn, c2)), cfg.eps)
    upd = anp.add(anp.divide(mhat, denom), anp.multiply(p1, cfg.weight_decay))
    pn = anp.subtract(p1, anp.multiply(upd, lr))
    return pn, mn, vn


@torch.no_grad()
def mozart_adamw_update(params: Mapping[str, torch.Tensor],
                        grads: Mapping[str, torch.Tensor], state: AdamWState,
                        cfg: AdamWConfig, executor: str = "scan",
                        batch_elements: int | None = None):
    """Same math as ``adamw.update(path="jnp")``, via Mozart pipelines, in a
    session on the parameters' device.

    The default executor is ``scan``, as the reference's; ``cuda`` runs each
    stage on the split-pipeline kernel.  Returns (new_params, new_state,
    metrics); metrics also carry the session's ``stats`` (stages,
    ``cuda_stages``, ``cuda_fallback_stages``, ...)."""
    step = state.step + 1
    lr = float(schedule(cfg, step))
    gnorm = float(global_norm(grads))
    gscale = min(1.0, cfg.clip_norm / max(gnorm, 1e-9))
    sf = float(step)
    c1 = 1.0 / (1.0 - cfg.b1 ** sf)
    c2 = 1.0 / (1.0 - cfg.b2 ** sf)
    device = next(iter(params.values())).device

    new_p, new_m, new_v = {}, {}, {}
    with mozart.session(executor=executor, device=device,
                        batch_elements=batch_elements) as ctx:
        for name, p in params.items():
            new_p[name], new_m[name], new_v[name] = _chain(
                p.reshape(-1).to(torch.float32),
                grads[name].reshape(-1).to(torch.float32),
                state.m[name].reshape(-1), state.v[name].reshape(-1),
                cfg, gscale=gscale, lr=lr, c1=c1, c2=c2)
        # leaving the session flushes every pending pipeline
    out_p = {n: f.value.reshape(params[n].shape).to(params[n].dtype)
             for n, f in new_p.items()}
    out_m = {n: f.value.reshape(params[n].shape) for n, f in new_m.items()}
    out_v = {n: f.value.reshape(params[n].shape) for n, f in new_v.items()}
    metrics = {"lr": lr, "grad_norm": gnorm, "stats": dict(ctx.stats)}
    return out_p, AdamWState(step=step, m=out_m, v=out_v), metrics
