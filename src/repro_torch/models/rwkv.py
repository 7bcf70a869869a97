"""RWKV-6 ("Finch"): attention-free token mixing with data-dependent decay;
the counterpart of ``src/repro/models/rwkv.py``.

Per layer a time-mix block (the WKV matrix-state recurrence) and a
channel-mix block.  The per-head state S in R^{hd x hd} carries all context,
so decode is O(1) per token.

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

The reference runs the recurrence as a ``lax.scan``; the port runs a Python
loop over the steps with everything that does not depend on the carry
computed for the whole sequence first (r, k, v, the decay w, the outer
products k_t^T v_t, time-major, and the bonus term
``(r_t . (u * k_t)) v_t``), so each step is one ``bmm`` (r_t S_{t-1}) and
one ``addcmul`` (the state update).  The Finch decay
``exp(-exp(base + (x A) B))``, the recurrence, the bonus ``u``, the per-head
group norm (var + 1e-5) and ``ln_x`` run in float32.

As in the reference, ``time_mix`` passes ``shift_c`` through unchanged and
``channel_mix`` passes ``wkv`` and ``shift_t`` through unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal

LORA = 64                 # rank of the data-dependent decay


class RWKVState(NamedTuple):
    wkv: torch.Tensor         # (B, H, hd, hd) float32
    shift_t: torch.Tensor     # (B, D) last token (time-mix shift)
    shift_c: torch.Tensor     # (B, D) last token (channel-mix shift)


def _dims(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim if cfg.rwkv else 64
    return cfg.d_model // hd, hd


def init_rwkv(cfg: ModelConfig, generator: torch.Generator | None,
              device: torch.device | str, n_layers: int) -> dict:
    """Stacked ``(L, ...)`` leaves in the reference's layout: the ``mu_*``
    lerp weights (0.5), ``decay_base`` (-6), ``bonus_u`` (zeros, (H, hd))
    and ``ln_x`` (ones) in float32, the matrices in ``cfg.dtype``."""
    D, Fd, L = cfg.d_model, cfg.d_ff, n_layers
    H, hd = _dims(cfg)
    full = lambda shape, v: torch.full((L, *shape), v, dtype=torch.float32, device=device)
    mat = lambda shape, scale: normal((L, *shape), scale, cfg.dtype, generator, device)
    sc = D ** -0.5
    return {
        # time mix
        "mu_r": full((D,), 0.5), "mu_k": full((D,), 0.5), "mu_v": full((D,), 0.5),
        "mu_g": full((D,), 0.5), "mu_w": full((D,), 0.5),
        "w_r": mat((D, D), sc), "w_k": mat((D, D), sc), "w_v": mat((D, D), sc),
        "w_g": mat((D, D), sc), "w_o": mat((D, D), sc),
        # data-dependent decay (low-rank) + base
        "decay_base": full((D,), -6.0),
        "decay_a": mat((D, LORA), sc),
        "decay_b": mat((LORA, D), LORA ** -0.5),
        "bonus_u": full((H, hd), 0.0),
        "ln_x": full((D,), 1.0),
        # channel mix
        "mu_ck": full((D,), 0.5),
        "w_ck": mat((D, Fd), sc),
        "w_cv": mat((Fd, D), Fd ** -0.5),
        "w_cr": mat((D, D), sc),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int,
                    device: torch.device | str = "cuda") -> RWKVState:
    H, hd = _dims(cfg)
    return RWKVState(
        wkv=torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        shift_t=torch.zeros((batch, cfg.d_model), dtype=cfg.dtype, device=device),
        shift_c=torch.zeros((batch, cfg.d_model), dtype=cfg.dtype, device=device))


def _shifted(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Token shift: concat(last, x[:-1]) along the sequence."""
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _wkv(r, k, v, w, u, S0):
    """The recurrence over (B, S, H, hd) float32 r, k, v, w from the state
    S0 (B, H, hd, hd): returns y (B, S, H, hd) and the last state.  On the
    ``meta`` device (an abstract evaluation: shapes and dtypes only) the
    steps are skipped."""
    B, S, H, hd = r.shape
    if r.is_meta:
        return torch.empty_like(r), torch.empty_like(S0)
    BH = B * H
    steps = lambda t, *tail: t.transpose(0, 1).reshape(S, BH, *tail)   # time-major
    rt, kt, vt, wt = steps(r, 1, hd), steps(k, hd, 1), steps(v, 1, hd), steps(w, hd, 1)
    kv = kt * vt                                                  # (S, BH, hd, hd)
    St, ys = S0.reshape(BH, hd, hd), []
    for t in range(S):
        ys.append(torch.bmm(rt[t], St))                           # r_t S_{t-1}
        St = torch.addcmul(kv[t], wt[t], St)
    y = torch.stack(ys).reshape(S, B, H, hd).transpose(0, 1)
    y = y + (r * u * k).sum(-1, keepdim=True) * v                 # r_t diag(u) k_t^T v_t
    return y, St.reshape(B, H, hd, hd)


def time_mix(p, x: torch.Tensor, cfg: ModelConfig, state: RWKVState):
    B, S, D = x.shape
    H, hd = _dims(cfg)
    xprev = _shifted(x, state.shift_t)

    def lerp(mu):
        return x + (xprev - x) * mu.to(x.dtype)

    r = (lerp(p["mu_r"]) @ p["w_r"].to(x.dtype)).reshape(B, S, H, hd)
    k = (lerp(p["mu_k"]) @ p["w_k"].to(x.dtype)).reshape(B, S, H, hd)
    v = (lerp(p["mu_v"]) @ p["w_v"].to(x.dtype)).reshape(B, S, H, hd)
    g = F.silu(lerp(p["mu_g"]) @ p["w_g"].to(x.dtype))

    # Finch: data-dependent decay in (0, 1) per channel
    dd = ((lerp(p["mu_w"]).to(torch.float32) @ p["decay_a"].to(torch.float32))
          @ p["decay_b"].to(torch.float32))
    w = torch.exp(-torch.exp(p["decay_base"] + dd)).reshape(B, S, H, hd)
    f32 = lambda t: t.to(torch.float32)
    y, ST = _wkv(f32(r), f32(k), f32(v), w, p["bonus_u"], state.wkv)

    # per-head group norm
    mean = y.mean(-1, keepdim=True)
    var = torch.square(y - mean).mean(-1, keepdim=True)
    y = ((y - mean) * torch.rsqrt(var + 1e-5)).reshape(B, S, D) * p["ln_x"]
    out = (y.to(x.dtype) * g) @ p["w_o"].to(x.dtype)
    return out, RWKVState(wkv=ST, shift_t=x[:, -1], shift_c=state.shift_c)


def channel_mix(p, x: torch.Tensor, cfg: ModelConfig, state: RWKVState):
    xprev = _shifted(x, state.shift_c)
    mk = x + (xprev - x) * p["mu_ck"].to(x.dtype)
    kk = torch.square(F.relu(mk @ p["w_ck"].to(x.dtype)))
    rr = torch.sigmoid(mk @ p["w_cr"].to(x.dtype))
    out = rr * (kk @ p["w_cv"].to(x.dtype))
    return out, RWKVState(wkv=state.wkv, shift_t=state.shift_t, shift_c=x[:, -1])
