"""The straight-line program the split-pipeline kernel interprets.

``core/cuda_exec.py`` lowers one Mozart stage into a ``Program``: a list of
instructions ``(opcode, dst_slot, a, b, c)`` over five kinds of values —
split inputs (one tile of each is resident), scalars (the stage's broadcast
inputs, passed at run time, followed by the program's immediates and by
copies of broadcast inputs at another dtype), slots (tile-wide
intermediates in shared memory, allocated by liveness), and the previous
instruction's result, which the kernel keeps in registers (*forwarded*).

Every value has one of the kernel's dtypes (``DTYPES``): bool, int8/16/32,
uint8/16/32, float16, bfloat16 or float32.  The kernel holds each as one
32-bit word: a float-class value (and a bool, as 1.0/0.0) as the float32
value it rounds to, a signed integer sign-extended to int32, an unsigned
one zero-extended to uint32.  ``types`` gives, per instruction, the dtype it
computes in (its operands') and the dtype of its result: float instructions
compute in float32 and round to a float16/bfloat16 result after each
instruction, integer ones compute in 32 bits and wrap to an 8- or 16-bit
result, and ``CAST`` converts its operand from one dtype to the other.  A
program built without dtypes (every ``*_dtypes`` field empty) is the float32
program of the kernel's first version: every value float32, comparisons and
logical opcodes giving bool.

``assemble`` builds a program from SSA form and ``forward`` re-assembles
any program: a value read only by the next instruction, or the last
instruction's result read only by outputs, is never written to a slot.  Its
readers name it as ``KIND_FWD`` and its instruction carries ``NO_STORE``.
Both marks keep the index of a slot that no stored value uses (the
*register slot*), so ``unmarked`` turns a marked program back into an
equivalent one that stores every result.

The opcode order and the dtype codes are the kernel's ABI:
``csrc/split_pipeline.cu`` declares the same enums, and the wrapper checks
their counts and the parameter block's size when it loads the kernel.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Sequence

import torch

#: opcode names in ABI order, with their arity.
OPCODES: tuple[tuple[str, int], ...] = (
    ("COPY", 1), ("NEG", 1), ("ABS", 1), ("EXP", 1), ("LOG", 1), ("LOG1P", 1),
    ("SQRT", 1), ("ERF", 1), ("SIN", 1), ("COS", 1), ("TANH", 1), ("SIGN", 1),
    ("ASIN", 1), ("ACOS", 1), ("EXPM1", 1), ("SQUARE", 1), ("RECIP", 1),
    ("FLOOR", 1), ("ISNAN", 1), ("NOT", 1), ("BOOL", 1),
    ("ADD", 2), ("SUB", 2), ("MUL", 2), ("DIV", 2), ("POW", 2), ("MAX", 2),
    ("MIN", 2), ("GT", 2), ("LT", 2), ("GE", 2), ("LE", 2), ("EQ", 2), ("NE", 2),
    ("AND", 2), ("OR", 2), ("ATAN2", 2), ("MOD", 2),
    ("WHERE", 3),
    ("CAST", 1),
)
OP = {name: i for i, (name, _arity) in enumerate(OPCODES)}
ARITY = {name: arity for name, arity in OPCODES}
_ARITY_OF = [arity for _name, arity in OPCODES]

#: opcodes whose result is a bool (1.0/0.0).
BOOL_RESULT = frozenset(
    {"ISNAN", "NOT", "BOOL", "GT", "LT", "GE", "LE", "EQ", "NE", "AND", "OR"})
#: opcodes the kernel computes in float only (their operands are cast first).
FLOAT_ONLY = frozenset(
    {"EXP", "LOG", "LOG1P", "SQRT", "ERF", "SIN", "COS", "TANH", "ASIN", "ACOS",
     "EXPM1", "RECIP", "DIV", "ATAN2"})

#: the kernel's dtypes by code (``DType`` in the CUDA source).  A code below
#: 8 is also the load/store format of a row of that dtype (0: 32-bit words).
DTYPES: tuple[torch.dtype, ...] = (
    torch.float32, torch.bool, torch.int8, torch.uint8, torch.int16, torch.uint16,
    torch.float16, torch.bfloat16, torch.int32, torch.uint32)
F32, BOOL, I8, U8, I16, U16, F16, BF16, I32, U32 = range(len(DTYPES))
CODE = {dt: i for i, dt in enumerate(DTYPES)}
ITEMSIZE = (4, 1, 1, 1, 2, 2, 2, 2, 4, 4)
#: word classes: float (and bool, as 1.0/0.0), signed and unsigned integers.
FLOAT, SIGNED, UNSIGNED = 0, 1, 2
CLASS = (FLOAT, FLOAT, SIGNED, UNSIGNED, SIGNED, UNSIGNED, FLOAT, FLOAT, SIGNED, UNSIGNED)
#: bits of an integer dtype (0 for the float class).
BITS = (0, 0, 8, 8, 16, 16, 0, 0, 32, 32)

# Operand encoding: kind in the top two bits of a uint16, index below.
KIND_INPUT, KIND_SCALAR, KIND_SLOT, KIND_FWD = 0, 1, 2, 3
_INDEX_BITS = 14
MAX_INDEX = (1 << _INDEX_BITS) - 1
#: bit of ``dst`` (a uint8): the result is not written to its slot.
NO_STORE = 0x80

#: an SSA source: ("in", i), ("sc", i) or ("v", j), j an earlier instruction.
Src = tuple[str, int]


def operand(kind: int, index: int) -> int:
    if not 0 <= index <= MAX_INDEX:
        raise ValueError(f"operand index {index} out of range")
    return (kind << _INDEX_BITS) | index


def decode(code: int) -> tuple[int, int]:
    return code >> _INDEX_BITS, code & MAX_INDEX


@dataclasses.dataclass(frozen=True)
class Program:
    """One stage as a kernel program.

    ``code`` holds ``(opcode, dst_slot, a, b, c)`` with encoded operands
    (unused operands are 0).  Scalar ``i < n_bcast`` is broadcast input
    ``i``; scalar ``n_bcast + j`` is ``imms[j]``; scalar ``n_bcast +
    len(imms) + k`` is broadcast input ``bcast_copies[k]`` again, at
    another dtype.  ``outputs`` lists, per escaping value, its operand and
    whether it is stored as bool; the caller's ``out_kinds`` say whether
    each is a concat output or a reduction of that operand.  ``n_slots``
    counts every slot the code names, the register slot included.

    Dtype codes (``DTYPES``): ``types`` per instruction (operand dtype,
    result dtype), ``in_dtypes`` per split input, ``scalar_dtypes`` per
    scalar, ``out_dtypes`` per output (a concat output's dtype, or a
    reduction's accumulator and result dtype).  Left empty, they take the
    float32 program's: see ``instr_types``, ``scalar_types`` and
    ``output_types``; an empty ``in_dtypes`` takes the inputs' own."""

    code: tuple[tuple[int, int, int, int, int], ...]
    n_split: int
    n_bcast: int
    n_slots: int
    imms: tuple[float, ...]
    outputs: tuple[tuple[int, bool], ...]
    types: tuple[tuple[int, int], ...] = ()
    in_dtypes: tuple[int, ...] = ()
    scalar_dtypes: tuple[int, ...] = ()
    bcast_copies: tuple[int, ...] = ()
    out_dtypes: tuple[int, ...] = ()

    @property
    def n_scalars(self) -> int:
        return self.n_bcast + len(self.imms) + len(self.bcast_copies)

    @property
    def instr_types(self) -> tuple[tuple[int, int], ...]:
        """(operand dtype, result dtype) per instruction."""
        if self.types:
            return self.types
        return tuple((F32, BOOL if OPCODES[op][0] in BOOL_RESULT else F32)
                     for op, *_ in self.code)

    @property
    def scalar_types(self) -> tuple[int, ...]:
        return self.scalar_dtypes or (F32,) * self.n_scalars

    @property
    def output_types(self) -> tuple[int, ...]:
        return self.out_dtypes or tuple(BOOL if b else F32 for _s, b in self.outputs)

    def scalar_sources(self) -> list[tuple[str, Any]]:
        """Per scalar: ``("bcast", i)`` or ``("imm", value)``."""
        return ([("bcast", i) for i in range(self.n_bcast)]
                + [("imm", v) for v in self.imms]
                + [("bcast", i) for i in self.bcast_copies])

    @property
    def stored_slots(self) -> int:
        """Slots the kernel keeps in shared memory: one more than the
        highest slot a result is written to."""
        return max((dst + 1 for _op, dst, *_ in self.code if not dst & NO_STORE),
                   default=0)

    @property
    def forwarded(self) -> int:
        """Instructions whose result stays in registers."""
        return sum(1 for _op, dst, *_ in self.code if dst & NO_STORE)


def assemble(code: Sequence[tuple[int, Sequence[Src]]],
             outputs: Sequence[tuple[Src, bool]], *, n_split: int, n_bcast: int,
             imms: Sequence[float], **dtypes) -> Program:
    """The program of SSA instructions ``(opcode, sources)`` with forwarding
    marks and slots allocated by liveness; ``dtypes`` are the ``Program``'s
    dtype fields (``types``, ``in_dtypes``, ``scalar_dtypes``,
    ``bcast_copies``, ``out_dtypes``), kept as they are.

    Instruction j's result is *forwarded* (``NO_STORE``; its readers name
    it ``KIND_FWD``) when instruction j + 1 is its only reader and no
    output reads it, or when j is the last instruction and only outputs
    read it; a result nothing reads is not stored either.  Every other
    result gets a slot, freed after its last reader: an instruction may
    write the slot its last-read operand frees, since the kernel reads an
    element's operands before it writes the element."""
    n = len(code)
    readers: list[set[int]] = [set() for _ in range(n)]
    last = [-1] * n
    for i, (_op, srcs) in enumerate(code):
        for kind, j in srcs:
            if kind == "v":
                if not 0 <= j < i:
                    raise ValueError(f"instruction {i} reads value {j}")
                readers[j].add(i)
                last[j] = i
    out_read = [False] * n
    for (kind, j), _is_bool in outputs:
        if kind == "v":
            out_read[j] = True
            last[j] = n
    fwd = [(readers[j] == {j + 1} and not out_read[j])
           or (j == n - 1 and out_read[j] and not readers[j]) for j in range(n)]
    stored = [last[j] >= 0 and not fwd[j] for j in range(n)]

    free: list[int] = []
    slot_of: dict[int, int] = {}
    n_stored = 0
    for i, (_op, srcs) in enumerate(code):
        for j in {j for kind, j in srcs if kind == "v" and stored[j] and last[j] == i}:
            heapq.heappush(free, slot_of[j])
        if stored[i]:
            if free:
                slot_of[i] = heapq.heappop(free)
            else:
                slot_of[i], n_stored = n_stored, n_stored + 1
    reg = n_stored                      # the register slot

    def enc(src: Src) -> int:
        kind, i = src
        if kind == "in":
            return operand(KIND_INPUT, i)
        if kind == "sc":
            return operand(KIND_SCALAR, i)
        return operand(KIND_FWD, reg) if fwd[i] else operand(KIND_SLOT, slot_of[i])

    out_code = []
    for i, (op, srcs) in enumerate(code):
        ops = [enc(s) for s in srcs] + [0] * (3 - len(srcs))
        out_code.append((op, slot_of[i] if stored[i] else NO_STORE | reg, *ops))
    return Program(code=tuple(out_code), n_split=n_split, n_bcast=n_bcast,
                   n_slots=n_stored + (0 if all(stored) else 1), imms=tuple(imms),
                   outputs=tuple((enc(s), is_bool) for s, is_bool in outputs),
                   **{k: tuple(v) for k, v in dtypes.items()})


def _ssa(program: Program) -> tuple[list, list]:
    """``program``'s instructions and outputs over SSA sources."""
    kinds = {KIND_INPUT: "in", KIND_SCALAR: "sc"}
    holder: dict[int, int] = {}           # slot -> instruction last written there

    def src(x: int, i: int) -> Src:
        kind, idx = decode(x)
        if kind in kinds:
            return kinds[kind], idx
        if kind == KIND_FWD:
            if i == 0:
                raise ValueError("a forwarded operand with no instruction before it")
            return "v", i - 1
        if idx not in holder:
            raise ValueError(f"slot {idx} read before it is written")
        return "v", holder[idx]

    code = []
    for i, (op, dst, a, b, c) in enumerate(program.code):
        code.append((op, [src(x, i) for x in (a, b, c)[:_ARITY_OF[op]]]))
        if not dst & NO_STORE:
            holder[dst] = i
    n = len(program.code)
    return code, [(src(x, n), is_bool) for x, is_bool in program.outputs]


def forward(program: Program) -> Program:
    """``program`` with forwarding marks and its stored values re-allocated
    (``assemble``); an already marked program comes back unchanged."""
    code, outputs = _ssa(program)
    return assemble(code, outputs, n_split=program.n_split, n_bcast=program.n_bcast,
                    imms=program.imms, types=program.types, in_dtypes=program.in_dtypes,
                    scalar_dtypes=program.scalar_dtypes,
                    bcast_copies=program.bcast_copies, out_dtypes=program.out_dtypes)


def unmarked(program: Program) -> Program:
    """The same program with every result stored: forwarded operands read
    the register slot and ``NO_STORE`` instructions write it."""
    def plain(x: int) -> int:
        kind, idx = decode(x)
        return operand(KIND_SLOT, idx) if kind == KIND_FWD else x

    code = tuple((op, dst & ~NO_STORE, plain(a), plain(b), plain(c))
                 for op, dst, a, b, c in program.code)
    return dataclasses.replace(program, code=code, outputs=tuple(
        (plain(x), is_bool) for x, is_bool in program.outputs))
