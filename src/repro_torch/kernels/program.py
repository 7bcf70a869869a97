"""The straight-line program the split-pipeline kernel interprets.

``core/cuda_exec.py`` lowers one Mozart stage into a ``Program``: a list of
instructions ``(opcode, dst_slot, a, b, c)`` over four kinds of values —
split inputs (one tile of each is resident), scalars (the stage's broadcast
inputs, passed at run time, followed by the program's immediates), and
slots (tile-wide intermediates, allocated by liveness).  Every value is
float32; a bool is 1.0/0.0 and is stored as one byte.

The opcode order is the kernel's ABI: ``csrc/split_pipeline.cu`` declares
the same enum, and the wrapper checks the count when it loads the kernel.
"""

from __future__ import annotations

import dataclasses

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
)
OP = {name: i for i, (name, _arity) in enumerate(OPCODES)}
ARITY = {name: arity for name, arity in OPCODES}

#: opcodes whose result is a bool (1.0/0.0).
BOOL_RESULT = frozenset(
    {"ISNAN", "NOT", "BOOL", "GT", "LT", "GE", "LE", "EQ", "NE", "AND", "OR"})

# Operand encoding: kind in the top two bits of a uint16, index below.
KIND_INPUT, KIND_SCALAR, KIND_SLOT = 0, 1, 2
_INDEX_BITS = 14
MAX_INDEX = (1 << _INDEX_BITS) - 1


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
    ``i``; scalar ``n_bcast + j`` is ``imms[j]``.  ``outputs`` lists, per
    escaping value, its operand and whether it is stored as bool; the
    caller's ``out_kinds`` say whether each is a concat output or a
    reduction of that operand."""

    code: tuple[tuple[int, int, int, int, int], ...]
    n_split: int
    n_bcast: int
    n_slots: int
    imms: tuple[float, ...]
    outputs: tuple[tuple[int, bool], ...]

    @property
    def n_scalars(self) -> int:
        return self.n_bcast + len(self.imms)
