"""Selective state-space sub-layer (Mamba-style), Hymba's SSM heads: the
counterpart of ``src/repro/models/ssm.py``.

The recurrence h_t = dA_t * h_{t-1} + dB_t x_t ; y_t = C_t . h_t.  The
reference runs it as a ``lax.scan`` (through ``chunked_scan``, whose chunks
change backward memory, not values); the port runs a Python loop over the
steps, with everything that does not depend on the carry computed for the
whole sequence first: dA = exp(dt A) and dBx, time-major, so each step is one
``addcmul`` on contiguous slices, and y = C . h as one batched product after
the loop.  Train mode's backward memory is bounded by the stack's per-layer
``torch.utils.checkpoint``.  Decode is the O(1) single step over a rolling
``(B, W-1, d_in)`` window of conv inputs.  softplus(dt), the recurrence, the
``D_skip`` term and the ``silu(z)`` gate run in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal


class SSMState(NamedTuple):
    h: torch.Tensor           # (B, d_in, N) float32
    conv: torch.Tensor        # (B, conv_width-1, d_in) rolling input window


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.state_dim, s.conv_width


def init_ssm(cfg: ModelConfig, generator: torch.Generator | None,
             device: torch.device | str, n_layers: int) -> dict:
    """Stacked ``(L, ...)`` leaves in the reference's layout: matrices in
    ``cfg.dtype`` (``in_proj``, ``conv_w``, ``x_proj``, ``dt_proj``,
    ``out_proj``), ``dt_bias`` zeros, ``A_log = log(1..N)`` per channel and
    ``D_skip`` ones in float32."""
    d = cfg.d_model
    d_in, dt_rank, N, W = _dims(cfg)
    L = n_layers
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.arange(1, N + 1, **f32)).expand(L, d_in, N).clone()
    return {
        "in_proj": normal((L, d, 2 * d_in), d ** -0.5, cfg.dtype, generator, device),
        "conv_w": normal((L, W, d_in), 0.2, cfg.dtype, generator, device),
        "x_proj": normal((L, d_in, dt_rank + 2 * N), d_in ** -0.5, cfg.dtype, generator,
                         device),
        "dt_proj": normal((L, dt_rank, d_in), dt_rank ** -0.5, cfg.dtype, generator, device),
        "dt_bias": torch.zeros((L, d_in), **f32),
        "A_log": a_log,
        "D_skip": torch.ones((L, d_in), **f32),
        "out_proj": normal((L, d_in, d), d_in ** -0.5, cfg.dtype, generator, device),
    }


def init_ssm_state(cfg: ModelConfig, batch: int,
                   device: torch.device | str = "cuda") -> SSMState:
    d_in, _, N, W = _dims(cfg)
    return SSMState(h=torch.zeros((batch, d_in, N), dtype=torch.float32, device=device),
                    conv=torch.zeros((batch, W - 1, d_in), dtype=cfg.dtype, device=device))


def _scan(dA: torch.Tensor, dBx: torch.Tensor, h: torch.Tensor):
    """h_t = dA_t * h_{t-1} + dBx_t over the leading (time) axis of dA and
    dBx (S, B, d_in, N), from h (B, d_in, N): one ``addcmul`` per step.
    Returns every h_t stacked and the last.  On the ``meta`` device (an
    abstract evaluation: shapes and dtypes only) the steps are skipped."""
    if dA.is_meta:
        return torch.empty_like(dBx), torch.empty_like(h)
    hs = []
    for t in range(dA.shape[0]):
        h = torch.addcmul(dBx[t], dA[t], h)
        hs.append(h)
    return torch.stack(hs), h


def _ssm_core(p, xc: torch.Tensor, z: torch.Tensor, cfg: ModelConfig, h0: torch.Tensor):
    """xc: (B, S, d_in) float32 post-conv activations; returns (y float32,
    the last h)."""
    d_in, dt_rank, N, _ = _dims(cfg)
    A = -torch.exp(p["A_log"])                                    # (d_in, N)
    proj = xc @ p["x_proj"].to(torch.float32)
    dt, Bc, Cc = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(torch.float32) + p["dt_bias"])   # (B, S, d_in)

    # time-major, carry-free: dA_t = exp(dt_t A), dBx_t = (dt_t x_t) B_t
    dt_t = dt.transpose(0, 1)                                     # (S, B, d_in)
    dA = torch.exp(dt_t[..., None] * A)                           # (S, B, d_in, N)
    dBx = (dt_t * xc.transpose(0, 1))[..., None] * Bc.transpose(0, 1)[:, :, None, :]
    hs, h = _scan(dA, dBx, h0)
    # y_t = h_t . C_t for every step at once: (S, B, d_in, N) @ (S, B, N, 1)
    y = (hs @ Cc.transpose(0, 1)[..., None])[..., 0].transpose(0, 1)
    y = y + xc * p["D_skip"]
    y = y * F.silu(z.to(torch.float32))
    return y, h


def _conv_silu(win: torch.Tensor, conv_w: torch.Tensor, S: int) -> torch.Tensor:
    """The causal depthwise conv over ``win`` (B, S+W-1, d_in), float32:
    position s sums ``win[:, s + i] * conv_w[i]`` over the W taps; then silu."""
    w = conv_w.to(torch.float32)
    xc = win[:, :S].to(torch.float32) * w[0]
    for i in range(1, w.shape[0]):
        xc = torch.addcmul(xc, win[:, i:i + S].to(torch.float32), w[i])
    return F.silu(xc)


def ssm_block(p, x: torch.Tensor, cfg: ModelConfig, state: SSMState | None = None,
              mode: str = "train"):
    """x: (B, S, D) -> (out, new_state).  decode: S == 1, the O(1) step.
    Train and prefill pad the conv causally with W-1 zeros, or with the
    carried ``state.conv``, and start from ``state.h`` (zeros without one)."""
    d_in, _, N, W = _dims(cfg)
    B, S, _ = x.shape
    xs, z = torch.chunk(x @ p["in_proj"].to(x.dtype), 2, dim=-1)  # (B, S, d_in)

    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("SSM decode takes one token and a state")
        win = torch.cat([state.conv.to(xs.dtype), xs], dim=1)    # (B, W, d_in)
        y, hT = _ssm_core(p, _conv_silu(win, p["conv_w"], 1), z, cfg, state.h)
        new_state = SSMState(h=hT, conv=win[:, 1:].to(state.conv.dtype))
        return y.to(x.dtype) @ p["out_proj"].to(x.dtype), new_state

    pad = (torch.zeros((B, W - 1, d_in), dtype=xs.dtype, device=xs.device)
           if state is None else state.conv.to(xs.dtype))
    xpad = torch.cat([pad, xs], dim=1)                            # (B, S+W-1, d_in)
    h0 = (torch.zeros((B, d_in, N), dtype=torch.float32, device=x.device)
          if state is None else state.h)
    y, hT = _ssm_core(p, _conv_silu(xpad, p["conv_w"], S), z, cfg, h0)
    new_state = SSMState(h=hT, conv=xpad[:, -(W - 1):].to(cfg.dtype))
    return y.to(x.dtype) @ p["out_proj"].to(x.dtype), new_state
