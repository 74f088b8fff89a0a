"""LUT3/LUT4 synthesis: lower k-input lookup tables to native gates.

The reference declares LUT3/LUT4 gate types but leaves evaluation a
"remember to write" stub (reference src/gate.h:51, src/gate.cpp:217-225).
Here they are fully functional: a LUT is lowered at netlist-construction
time into the native bootstrappable gate set via recursive Shannon
decomposition, so the evaluator, levelizer, assembler, and both execution
modes handle LUT circuits with no special cases.

Truth-table convention: for inputs ``ins = [i0, i1, ..., i{k-1}]``
(i0 = least-significant select bit), the output is bit
``mask >> (i0 + 2*i1 + 4*i2 + ...) & 1``.

Cost model (FHEW: AND/OR/XOR = 1 bootstrap, NOT free): a LUT3 lowers to at
most 1 XOR + 2x(2-LUT) + MUX = 6 bootstraps worst case, but the
decomposition folds constant/equal/complement cofactors, so common masks
(majority 0xE8, full adder sum 0x96, mux 0xCA...) cost 1-4 bootstraps.

The port's own copy of ``oece_tpu.circuits.lut``, kept in step with it
(tests/test_torch_copies.py): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

from .netlist import Op

# emit(op, a, b) -> wire; the caller provides wire allocation.
Emit = Callable[[Op, int, int], int]


def _full_mask(k: int) -> int:
    return (1 << (1 << k)) - 1


def lower_lut(emit: Emit, const: Callable[[int], int], mask: int,
              ins: Sequence[int]) -> int:
    """Emit native gates computing the k-input LUT; returns the output wire.

    ``emit(op, a, b)`` appends one gate; ``const(bit)`` returns a constant
    wire.  Gates are emitted in topological order.
    """
    k = len(ins)
    full = _full_mask(k)
    mask &= full
    if mask == 0:
        return const(0)
    if mask == full:
        return const(1)
    if k == 1:
        a = ins[0]
        return emit(Op.NOT, a, a) if mask == 0b01 else a  # 0b10 == identity
    s = ins[-1]  # top select bit
    half = 1 << (k - 1)
    lo_full = _full_mask(k - 1)
    m0 = mask & lo_full          # cofactor s = 0
    m1 = (mask >> half) & lo_full  # cofactor s = 1
    if m0 == m1:
        return lower_lut(emit, const, m0, ins[:-1])
    if m0 == (~m1 & lo_full):
        # f = s XOR f0 (f1 is the complement of f0)
        f0 = lower_lut(emit, const, m0, ins[:-1])
        return emit(Op.XOR, s, f0)
    if m0 == 0:
        f1 = lower_lut(emit, const, m1, ins[:-1])
        return emit(Op.AND, s, f1)
    if m0 == lo_full:
        f1 = lower_lut(emit, const, m1, ins[:-1])
        ns = emit(Op.NOT, s, s)
        return emit(Op.OR, ns, f1)
    if m1 == 0:
        f0 = lower_lut(emit, const, m0, ins[:-1])
        ns = emit(Op.NOT, s, s)
        return emit(Op.AND, ns, f0)
    if m1 == lo_full:
        f0 = lower_lut(emit, const, m0, ins[:-1])
        return emit(Op.OR, s, f0)
    if m0 & m1 == m0:
        # f0 implies f1: MUX simplifies to OR(f0, AND(s, f1))
        f0 = lower_lut(emit, const, m0, ins[:-1])
        f1 = lower_lut(emit, const, m1, ins[:-1])
        return emit(Op.OR, f0, emit(Op.AND, s, f1))
    if m0 & m1 == m1:
        # f1 implies f0: MUX simplifies to OR(f1, AND(NOT s, f0))
        f0 = lower_lut(emit, const, m0, ins[:-1])
        f1 = lower_lut(emit, const, m1, ins[:-1])
        ns = emit(Op.NOT, s, s)
        return emit(Op.OR, f1, emit(Op.AND, ns, f0))
    # general MUX(s, f1, f0) = OR(AND(s, f1), AND(NOT s, f0))
    f0 = lower_lut(emit, const, m0, ins[:-1])
    f1 = lower_lut(emit, const, m1, ins[:-1])
    ns = emit(Op.NOT, s, s)
    t1 = emit(Op.AND, s, f1)
    t0 = emit(Op.AND, ns, f0)
    return emit(Op.OR, t1, t0)


def lut_reference(mask: int, bits: Sequence[int]) -> int:
    """Plain-integer truth evaluation (for tests)."""
    idx = 0
    for i, b in enumerate(bits):
        idx |= (int(b) & 1) << i
    return (mask >> idx) & 1
