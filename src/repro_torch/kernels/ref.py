"""Plain PyTorch versions of the port's kernels (the correctness references).

``attention_ref`` and ``rmsnorm_ref`` are copies of the JAX package's
oracles (``src/repro/kernels/ref.py``) for the flash-attention and RMSNorm
kernels; ``adamw_ref`` is the fused AdamW kernel's arithmetic on whole
tensors.
``split_pipeline_ref`` evaluates the SAME typed program the split-pipeline
kernel runs, opcode by opcode, with torch ops on whole 1-D tensors of the
kernel's 32-bit words — so the stage lowering is exercised on the CPU, and
on the card the kernel is held against it on the same inputs.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.kernels.program import (
    BF16,
    BITS,
    BOOL,
    CLASS,
    DTYPES,
    F16,
    FLOAT,
    KIND_FWD,
    KIND_INPUT,
    KIND_SCALAR,
    NO_STORE,
    OPCODES,
    SIGNED,
    UNSIGNED,
    Program,
    decode,
)

_M32 = 0xFFFFFFFF


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


def _imod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Floor mod of integer words; a zero divisor gives 0 (jnp.mod), as
    does -1 (never divided: INT_MIN % -1 traps)."""
    safe = (b == 0) | (b == -1)
    return torch.where(safe, torch.zeros_like(a), torch.remainder(a, torch.where(safe, 1, b)))


def _ipow(a: torch.Tensor, b: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """Exact integer power by squaring (wrapping as the words do); a
    negative exponent gives 0 but for bases 1 and -1."""
    acc, base, e = torch.ones_like(a), a, b.clamp(min=0)
    for _ in range(32):
        acc = torch.where((e & 1) == 1, acc * base, acc)
        base, e = base * base, e >> 1
        if unsigned:
            acc, base = acc & _M32, base & _M32
    if unsigned:
        return acc
    odd = (b & 1) == 1
    neg = torch.where(a == 1, 1, torch.where(a == -1, torch.where(odd, -1, 1), 0))
    return torch.where(b < 0, neg.to(acc.dtype), acc)


def _cmp(f):
    return lambda a, b: _f(f(a, b))


#: integer semantics (int32 words, or int64 words in [0, 2**32) for the
#: unsigned class); opcodes in ``FLOAT_ONLY`` never compute here.
_INT_IMPL: dict[str, Callable[..., torch.Tensor]] = {
    "COPY": lambda x: x, "NEG": torch.neg, "ABS": torch.abs, "SIGN": torch.sign,
    "SQUARE": lambda x: x * x, "FLOOR": lambda x: x,
    "ISNAN": lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
    "NOT": lambda x: _f(x == 0), "BOOL": lambda x: _f(x != 0),
    "ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul,
    "MAX": torch.maximum, "MIN": torch.minimum,
    "GT": _cmp(torch.gt), "LT": _cmp(torch.lt), "GE": _cmp(torch.ge), "LE": _cmp(torch.le),
    "EQ": _cmp(torch.eq), "NE": _cmp(torch.ne),
    "AND": lambda a, b: _f((a != 0) & (b != 0)),
    "OR": lambda a, b: _f((a != 0) | (b != 0)),
    "MOD": _imod,
    "WHERE": lambda c, x, y: torch.where(c != 0, x, y),
}

_REDUCE = {"add": torch.sum, "mul": torch.prod, "max": torch.amax,
           "min": torch.amin}


def word_tensor(x: torch.Tensor, code: int) -> torch.Tensor:
    """A split input as the kernel's words: float32 for the float class and
    bool, int32 for signed integers, int64 in [0, 2**32) for unsigned ones."""
    return x.to({FLOAT: torch.float32, SIGNED: torch.int32, UNSIGNED: torch.int64}[CLASS[code]])


def scalar_word(v: Any, code: int) -> float | int:
    """A broadcast scalar or immediate (a Python number or a one-element
    tensor) at dtype ``code``, as the kernel's word holds it: a float for
    the float class (1.0/0.0 for bool), else the integer wrapped to the
    dtype's width."""
    if isinstance(v, torch.Tensor):
        v = v.reshape(()).item()         # host read (syncs a CUDA scalar)
    if code == BOOL:
        return 1.0 if v else 0.0
    if CLASS[code] == FLOAT:
        return float(v)
    return wrap(int(v), code)


def wrap(x: int, code: int) -> int:
    """The Python int ``x`` wrapped to integer dtype ``code``."""
    bits = BITS[code]
    x &= (1 << bits) - 1
    if CLASS[code] == SIGNED and x >= 1 << (bits - 1):
        x -= 1 << bits
    return x


def _finish(v: torch.Tensor, code: int) -> torch.Tensor:
    """A result word rounded (float16/bfloat16) or wrapped (8/16-bit)."""
    if code in (F16, BF16):
        return v.to(DTYPES[code]).to(torch.float32)
    bits = BITS[code]
    if bits in (8, 16):
        if CLASS[code] == UNSIGNED:
            return v & ((1 << bits) - 1)
        return v.to(DTYPES[code]).to(torch.int32)
    if CLASS[code] == UNSIGNED:
        return v & _M32
    return v


def cast_word(v: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """``CAST``: a word of dtype ``src`` as a word of dtype ``dst``."""
    if dst == BOOL:
        return _f(v != 0)
    cls = CLASS[dst]
    if cls == FLOAT:
        return _finish(_f(v), dst)
    if CLASS[src] == FLOAT:              # truncation toward zero
        v = v.to(torch.int64)
    out = _finish(v.to(torch.int64) & _M32 if cls == UNSIGNED else v.to(torch.int32), dst)
    return out


def _apply(name: str, cls: int, args: list) -> torch.Tensor:
    if cls == FLOAT:
        return _IMPL[name](*args)
    if name == "POW":
        return _ipow(*args, unsigned=cls == UNSIGNED)
    if cls == UNSIGNED and name in ("NEG", "ABS", "SIGN"):
        x = args[0]
        return {"NEG": lambda: -x, "ABS": lambda: x, "SIGN": lambda: (x != 0).to(x.dtype)}[name]()
    return _INT_IMPL[name](*args)


def reduce_words(v: torch.Tensor, op: str, code: int) -> torch.Tensor:
    """Reduce words (the whole operand, or the kernel's per-CTA partials)
    with ``op`` into a 0-d tensor of accumulator dtype ``code``: float-class
    words in float32, integers in 64 bits wrapped to 32, as the kernel's
    32-bit accumulators do."""
    if CLASS[code] == FLOAT:
        r = _REDUCE[op](v)
        return (r != 0) if code == BOOL else r.to(DTYPES[code])
    r = _REDUCE[op](v.to(torch.int64))
    if CLASS[code] == UNSIGNED:
        return (r & _M32).to(DTYPES[code])
    return r.to(torch.int32).to(DTYPES[code])


def store_word(v: torch.Tensor, code: int) -> torch.Tensor:
    """A concat output's words as a tensor of dtype ``code``."""
    return (v != 0) if code == BOOL else v.to(DTYPES[code])


def split_pipeline_ref(program: Program, split_inputs: Sequence[torch.Tensor],
                       bcast_inputs: Sequence[Any],
                       out_kinds: Sequence[tuple[str, str]]) -> list[torch.Tensor]:
    """Evaluate ``program`` on whole 1-D tensors; same contract as the
    kernel wrapper (concat outputs of length n, reductions as 0-d tensors of
    their accumulator dtype).  Runs the typed program as the kernel does:
    each instruction in its operand dtype's class, float results rounded to
    float16/bfloat16 and integer results wrapped to 8/16 bits after every
    instruction.  Honours the forwarding marks as the kernel does: a
    ``KIND_FWD`` operand reads the previous instruction's result and a
    ``NO_STORE`` result is written to no slot."""
    dev = split_inputs[0].device
    in_codes = program.in_dtypes or tuple(
        BOOL if x.dtype == torch.bool else 0 for x in split_inputs)
    ins = [word_tensor(x, c) for x, c in zip(split_inputs, in_codes)]
    scalars = []
    for (kind, v), code in zip(program.scalar_sources(), program.scalar_types):
        w = scalar_word(bcast_inputs[v] if kind == "bcast" else v, code)
        scalars.append(torch.tensor(w, device=dev, dtype={
            FLOAT: torch.float32, SIGNED: torch.int32, UNSIGNED: torch.int64}[CLASS[code]]))
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

    for (op, dst, a, b, c), (sdt, rdt) in zip(program.code, program.instr_types):
        name, arity = OPCODES[op]
        args = [read(x) for x in (a, b, c)[:arity]]
        if name == "CAST":
            prev = cast_word(args[0], sdt, rdt)
        else:
            prev = _apply(name, CLASS[sdt], args)
            if rdt != BOOL:
                prev = _finish(prev, rdt)
        if prev.dim() == 0:
            prev = prev.expand(ins[0].shape)
        if not dst & NO_STORE:
            slots[dst] = prev

    results = []
    for (kind, rop), (src, _is_bool), code in zip(out_kinds, program.outputs,
                                                    program.output_types):
        v = read(src)
        if kind == "reduce":
            results.append(reduce_words(v, rop, code))
        else:
            out = store_word(v, code)
            results.append(out.clone() if any(out.data_ptr() == x.data_ptr()
                                              for x in split_inputs) else out)
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
