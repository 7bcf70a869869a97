"""Plain PyTorch versions of the port's kernels (the correctness references).

``attention_ref`` and ``rmsnorm_ref`` are copies of the JAX package's
oracles (``src/repro/kernels/ref.py``) for the flash-attention and RMSNorm
kernels; ``adamw_ref`` is the fused AdamW kernel's arithmetic on whole
tensors.
``split_pipeline_ref`` evaluates the SAME program the split-pipeline kernel
runs, opcode by opcode, with torch ops on whole 1-D tensors — so the stage
lowering is exercised on the CPU, and on the card the kernel is held
against it on the same inputs.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.kernels.program import (
    KIND_FWD,
    KIND_INPUT,
    KIND_SCALAR,
    NO_STORE,
    OPCODES,
    Program,
    decode,
)


def _f(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.float32)


#: float32 semantics of every opcode; a bool is 1.0/0.0.
_IMPL: dict[str, Callable[..., torch.Tensor]] = {
    "COPY": lambda x: x,
    "NEG": torch.neg,
    "ABS": torch.abs,
    "EXP": torch.exp,
    "LOG": torch.log,
    "LOG1P": torch.log1p,
    "SQRT": torch.sqrt,
    "ERF": torch.special.erf,
    "SIN": torch.sin,
    "COS": torch.cos,
    "TANH": torch.tanh,
    "SIGN": torch.sign,
    "ASIN": torch.asin,
    "ACOS": torch.acos,
    "EXPM1": torch.expm1,
    "SQUARE": lambda x: x * x,
    "RECIP": torch.reciprocal,
    "FLOOR": torch.floor,
    "ISNAN": lambda x: _f(torch.isnan(x)),
    "NOT": lambda x: _f(x == 0),
    "BOOL": lambda x: _f(x != 0),
    "ADD": torch.add,
    "SUB": torch.sub,
    "MUL": torch.mul,
    "DIV": torch.div,
    "POW": torch.pow,
    "MAX": torch.maximum,
    "MIN": torch.minimum,
    "GT": lambda a, b: _f(a > b),
    "LT": lambda a, b: _f(a < b),
    "GE": lambda a, b: _f(a >= b),
    "LE": lambda a, b: _f(a <= b),
    "EQ": lambda a, b: _f(a == b),
    "NE": lambda a, b: _f(a != b),
    "AND": lambda a, b: _f((a != 0) & (b != 0)),
    "OR": lambda a, b: _f((a != 0) | (b != 0)),
    "ATAN2": torch.atan2,
    "MOD": torch.remainder,
    "WHERE": lambda c, x, y: torch.where(c != 0, x, y),
}
_BY_CODE = [(_IMPL[name], arity) for name, arity in OPCODES]

_REDUCE = {"add": torch.sum, "mul": torch.prod, "max": torch.amax,
           "min": torch.amin}


def split_pipeline_ref(program: Program, split_inputs: Sequence[torch.Tensor],
                       bcast_inputs: Sequence[Any],
                       out_kinds: Sequence[tuple[str, str]]) -> list[torch.Tensor]:
    """Evaluate ``program`` on whole 1-D tensors; same contract as the
    kernel wrapper (concat outputs of length n, reductions as 0-d f32).
    Honours the forwarding marks as the kernel does: a ``KIND_FWD`` operand
    reads the previous instruction's result and a ``NO_STORE`` result is
    written to no slot."""
    dev = split_inputs[0].device
    ins = [_f(x) for x in split_inputs]
    scalars = [torch.as_tensor(v, dtype=torch.float32, device=dev)
               for v in list(bcast_inputs) + list(program.imms)]
    slots: list[torch.Tensor | None] = [None] * program.n_slots
    prev: torch.Tensor | None = None

    def read(code: int) -> torch.Tensor:
        kind, i = decode(code)
        if kind == KIND_INPUT:
            return ins[i]
        if kind == KIND_SCALAR:
            return scalars[i]
        v = prev if kind == KIND_FWD else slots[i]
        if v is None:
            raise ValueError(f"operand {code:#06x} reads no value")
        return v

    for op, dst, a, b, c in program.code:
        fn, arity = _BY_CODE[op]
        prev = fn(*(read(x) for x in (a, b, c)[:arity]))
        if not dst & NO_STORE:
            slots[dst] = prev

    results = []
    for (kind, rop), (src, is_bool) in zip(out_kinds, program.outputs):
        v = read(src)
        if kind == "reduce":
            results.append(_REDUCE[rop](v))
        elif is_bool:
            results.append(v != 0)
        else:
            results.append(v.clone() if any(v is x for x in ins) else v)
    return results


def adamw_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, sc: torch.Tensor, *, eps: float,
              wd: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused AdamW kernel: the same float32 arithmetic
    in the same order on whole tensors, scalars from the (8,) row ``sc``
    (``lr, b1, b2, c1, c2, gscale``)."""
    lr, b1, b2, c1, c2, gscale = sc[:6].unbind()
    pf = p.to(torch.float32)
    gf = g.to(torch.float32) * gscale
    m = b1 * m + (1.0 - b1) * gf
    v = b2 * v + (1.0 - b2) * gf * gf
    update = (m * c1) / (torch.sqrt(v * c2) + eps) + wd * pf
    return (pf - lr * update).to(p.dtype), m, v


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  sm_scale: float | None = None) -> torch.Tensor:
    """Dense softmax attention with GQA / causal / sliding-window masks:
    q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), kv head = q head // group.
    Masked scores are -1e30; rows with no visible key give 0."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    kq = torch.repeat_interleave(k, group, dim=1).to(torch.float32)
    vq = torch.repeat_interleave(v, group, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kq) * sm_scale
    q_ids = torch.arange(Sq, device=q.device)[:, None]
    k_ids = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_ids >= k_ids)
    if window is not None:
        mask = mask & (k_ids > q_ids - window)
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    # rows with no visible key: softmax of all -1e30 is uniform; zero them
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.to(torch.float32)).to(x.dtype)
