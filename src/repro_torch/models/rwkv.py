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
``channel_mix`` passes ``wkv`` and ``shift_t`` through unchanged.  Under
tensor parallelism (``models.tensor_parallel``) a time mix split by heads
carries this rank's heads of ``wkv``, as ``launch.shardings.cache_specs``
places them; the shifts are whole.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import tensor_parallel
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


def init_rwkv_state(cfg: ModelConfig, batch: int, device: torch.device | str = "cuda",
                    n_heads: int | None = None) -> RWKVState:
    """Zeros; ``wkv`` of ``n_heads`` heads (all of them by default; a time
    mix split by heads carries its rank's, ``state_heads``)."""
    H, hd = _dims(cfg)
    H = H if n_heads is None else n_heads
    return RWKVState(
        wkv=torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        shift_t=torch.zeros((batch, cfg.d_model), dtype=cfg.dtype, device=device),
        shift_c=torch.zeros((batch, cfg.d_model), dtype=cfg.dtype, device=device))


def state_heads(p, cfg: ModelConfig) -> int:
    """The heads of ``wkv`` a layer of parameters ``p`` carries: this
    rank's where ``w_r`` is a ``"model"`` slice by heads, else all."""
    return p["w_r"].shape[-1] // _dims(cfg)[1]


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
    """The time mix.  ``w_r``/``w_k``/``w_v``/``w_g`` that are a ``"model"``
    slice by heads (``models.tensor_parallel``) run this rank's heads: the
    per-channel decay, bonus and norm scale enter rank-local compute and
    are cut to its channels, ``state.wkv`` is this rank's heads
    (``state_heads``) and so is the one returned, and ``w_o``'s rows give a
    partial sum, all-reduced."""
    B, S, D = x.shape
    H, hd = _dims(cfg)
    xprev = _shifted(x, state.shift_t)
    mg = tensor_parallel.current()
    if mg is not None and p["w_r"].shape[-1] == D:
        mg = None
    Dl = p["w_r"].shape[-1]                      # this rank's channels
    Hl, c0 = Dl // hd, (0 if mg is None else mg.index * Dl)

    def local(t, dim=-1):                        # a whole value, cut to this rank's part
        return t if mg is None else mg.enter(t).narrow(dim, c0 // (hd if dim == 0 else 1),
                                                       Hl if dim == 0 else Dl)

    def lerp(mu):
        y = x + (xprev - x) * mu.to(x.dtype)
        return y if mg is None else mg.enter(y)

    r = (lerp(p["mu_r"]) @ p["w_r"].to(x.dtype)).reshape(B, S, Hl, hd)
    k = (lerp(p["mu_k"]) @ p["w_k"].to(x.dtype)).reshape(B, S, Hl, hd)
    v = (lerp(p["mu_v"]) @ p["w_v"].to(x.dtype)).reshape(B, S, Hl, hd)
    g = F.silu(lerp(p["mu_g"]) @ p["w_g"].to(x.dtype))

    # Finch: data-dependent decay in (0, 1) per channel
    xw = x + (xprev - x) * p["mu_w"].to(x.dtype)
    dd = ((xw.to(torch.float32) @ p["decay_a"].to(torch.float32))
          @ p["decay_b"].to(torch.float32))
    w = torch.exp(-torch.exp(local(p["decay_base"]) + local(dd))).reshape(B, S, Hl, hd)
    f32 = lambda t: t.to(torch.float32)
    if state.wkv.shape[1] != Hl:
        raise ValueError(f"a wkv state of {state.wkv.shape[1]} heads for {Hl}")
    y, ST = _wkv(f32(r), f32(k), f32(v), w, local(p["bonus_u"], 0), state.wkv)

    # per-head group norm
    mean = y.mean(-1, keepdim=True)
    var = torch.square(y - mean).mean(-1, keepdim=True)
    y = ((y - mean) * torch.rsqrt(var + 1e-5)).reshape(B, S, Dl) * local(p["ln_x"])
    out = (y.to(x.dtype) * g) @ p["w_o"].to(x.dtype)
    if mg is not None:
        out = mg.exit(out)
    return out, RWKVState(wkv=ST, shift_t=x[:, -1], shift_c=state.shift_c)


def channel_mix(p, x: torch.Tensor, cfg: ModelConfig, state: RWKVState):
    """The channel mix.  ``w_ck``/``w_cv`` that are a ``"model"`` slice
    (``models.tensor_parallel``) compute this rank's columns of the FFN
    and a partial sum of its rows, all-reduced before the receptance
    gate."""
    xprev = _shifted(x, state.shift_c)
    mk = x + (xprev - x) * p["mu_ck"].to(x.dtype)
    mg = tensor_parallel.current()
    if mg is not None and p["w_ck"].shape[-1] == cfg.d_ff:
        mg = None
    kk = torch.square(F.relu((mk if mg is None else mg.enter(mk)) @ p["w_ck"].to(x.dtype)))
    rr = torch.sigmoid(mk @ p["w_cr"].to(x.dtype))
    kv = kk @ p["w_cv"].to(x.dtype)
    out = rr * (kv if mg is None else mg.exit(kv))
    return out, RWKVState(wkv=state.wkv, shift_t=state.shift_t, shift_c=x[:, -1])
