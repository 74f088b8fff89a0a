"""Circuit generator DSL: build Bristol-style netlists programmatically.

The reference ships only pre-made circuit data files (examples/, SURVEY.md
§2.9).  This module makes the framework self-contained: adders, comparators,
multipliers, parity chains, and the MD5/SHA-256 compression functions can be
*generated*, so every harness family runs even without the reference corpus,
and users can synthesize new circuits for their own functions.

The builder produces the same integer Netlist IR as the parsers, so
generated circuits levelize, evaluate, assemble to ``.out``, and round-trip
through the Bristol emitters identically to parsed ones.

The port's own copy of ``oece_tpu.circuits.gen``, kept in step with it
(tests/test_torch_harness.py): the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .lut import lower_lut
from .netlist import Netlist, Op


class Builder:
    """Tiny gate-level HDL.  Wires are ints; inputs declared first."""

    def __init__(self, name: str):
        self.name = name
        self.n_wires = 0
        self.inputs: List[np.ndarray] = []
        self.ops: List[int] = []
        self.in0: List[int] = []
        self.in1: List[int] = []
        self.outw: List[int] = []
        self._outputs: List[np.ndarray] = []
        self._dff_q: List[int] = []
        self._dff_d: List[int | None] = []

    # -- wires ----------------------------------------------------------
    def _new(self) -> int:
        self.n_wires += 1
        return self.n_wires - 1

    def input_word(self, bits: int) -> List[int]:
        w = [self._new() for _ in range(bits)]
        self.inputs.append(np.array(w, dtype=np.int32))
        return w

    def output_word(self, wires: Sequence[int]) -> None:
        self._outputs.append(np.array(list(wires), dtype=np.int32))

    # -- gates ----------------------------------------------------------
    def _gate(self, op: Op, a: int, b: int | None = None) -> int:
        w = self._new()
        self.ops.append(int(op))
        self.in0.append(a)
        self.in1.append(b if b is not None else a)
        self.outw.append(w)
        return w

    def AND(self, a, b):
        return self._gate(Op.AND, a, b)

    def OR(self, a, b):
        return self._gate(Op.OR, a, b)

    def XOR(self, a, b):
        return self._gate(Op.XOR, a, b)

    def NOT(self, a):
        return self._gate(Op.NOT, a)

    def NAND(self, a, b):
        return self._gate(Op.NAND, a, b)

    def const(self, bit: int) -> int:
        return self._gate(Op.EQ1 if bit else Op.EQ0, 0)

    def MUX(self, sel, a, b):
        """sel ? b : a  (2 AND + 1 OR + 1 NOT)."""
        return self.OR(self.AND(self.NOT(sel), a), self.AND(sel, b))

    def LUT(self, mask: int, ins: Sequence[int]) -> int:
        """k-input lookup table, lowered to native gates (circuits/lut.py).

        The reference declares LUT3/LUT4 but never implements them
        (src/gate.cpp:217-225); here any k works.  ins[0] is the LSB of the
        truth-table index."""
        return lower_lut(
            lambda op, a, b: self._gate(op, a, b), self.const, mask, list(ins)
        )

    def LUT3(self, mask: int, a, b, c):
        return self.LUT(mask, [a, b, c])

    def LUT4(self, mask: int, a, b, c, d):
        return self.LUT(mask, [a, b, c, d])

    def DFF(self) -> int:
        """Allocate a flip-flop output (state) wire.  Q reads as 0 on the
        first cycle after Reset; bind its next-state input with dff_bind.
        (The reference lists DFF as a to-do, src/gate.cpp:217-225 and
        README.md:55; here clocked circuits are first-class.)"""
        q = self._new()
        self._dff_q.append(q)
        self._dff_d.append(None)
        return q

    def dff_bind(self, q: int, d: int) -> None:
        ix = self._dff_q.index(q)
        self._dff_d[ix] = d

    # -- word helpers ----------------------------------------------------
    def xor_word(self, A, B):
        return [self.XOR(a, b) for a, b in zip(A, B)]

    def and_word(self, A, B):
        return [self.AND(a, b) for a, b in zip(A, B)]

    def not_word(self, A):
        return [self.NOT(a) for a in A]

    def add_word(self, A, B, cin: int | None = None) -> tuple:
        """Ripple-carry adder; returns (sum bits, carry-out)."""
        S = []
        c = cin
        for a, b in zip(A, B):
            axb = self.XOR(a, b)
            if c is None:
                S.append(axb)
                c = self.AND(a, b)
            else:
                S.append(self.XOR(axb, c))
                c = self.OR(self.AND(a, b), self.AND(axb, c))
        return S, c

    def mux_word(self, sel, A, B):
        """Per-bit ``sel ? B : A``."""
        return [self.MUX(sel, a, b) for a, b in zip(A, B)]

    def sub_word(self, A, B) -> tuple:
        """A - B via A + ~B + 1; returns (diff bits, carry-out).

        carry-out == 1  iff  A >= B  (unsigned)."""
        one = self.const(1)
        return self.add_word(A, self.not_word(B), cin=one)

    def neg_word(self, A):
        """Two's-complement negation ~A + 1 as a ripple increment of ~A:
        bit 0 is ~a0 ^ 1 = a0; carry chain c = AND(~a_i, c)."""
        inv = self.not_word(A)
        S = [A[0]]
        c = inv[0]
        for x in inv[1:]:
            S.append(self.XOR(x, c))
            c = self.AND(x, c)
        return S

    def rotr_word(self, A, r: int):
        n = len(A)
        return [A[(i + r) % n] for i in range(n)]

    def shr_word(self, A, r: int, zero: int):
        n = len(A)
        return [A[i + r] if i + r < n else zero for i in range(n)]

    def build(self) -> Netlist:
        assert all(d is not None for d in self._dff_d), "unbound DFF (dff_bind)"
        nl = Netlist(
            name=self.name,
            n_wires=self.n_wires,
            inputs=self.inputs,
            outputs=self._outputs,
            op=np.array(self.ops, dtype=np.int32),
            in0=np.array(self.in0, dtype=np.int32),
            in1=np.array(self.in1, dtype=np.int32),
            out=np.array(self.outw, dtype=np.int32),
            dff_d=np.array(self._dff_d, dtype=np.int32),
            dff_q=np.array(self._dff_q, dtype=np.int32),
        )
        return nl


# ---------------------------------------------------------------------------
# Generators (LSB-first words, matching harness/testlib conventions)
# ---------------------------------------------------------------------------


def gen_adder(width: int, carry_out: bool = True) -> Netlist:
    """Ripple-carry adder.  carry_out=True gives the old-Bristol width+1-bit
    interface (adder_32bit.txt); False the new-Bristol width-bit one
    (adder64.txt)."""
    b = Builder(f"gen_adder_{width}")
    A = b.input_word(width)
    B = b.input_word(width)
    S, c = b.add_word(A, B)
    b.output_word(S + [c] if carry_out else S)
    return b.build()


def gen_comparator(width: int, signed: bool = False, or_equal: bool = False) -> Netlist:
    """out = A < B (or <=); signed compares flip the MSB."""
    b = Builder(f"gen_cmp_{width}{'s' if signed else 'u'}{'e' if or_equal else ''}")
    A = b.input_word(width)
    B = b.input_word(width)
    if signed:
        A = A[:-1] + [b.NOT(A[-1])]
        B = B[:-1] + [b.NOT(B[-1])]
    # iterative from LSB: lt = (~a & b) | (eq_bit & lt_prev) ... compute via
    # standard MSB-down recursion done LSB-up with carry:
    lt = b.const(1 if or_equal else 0)  # empty-prefix value
    for a, bb in zip(A, B):
        eq = b.NOT(b.XOR(a, bb))
        a_lt_b = b.AND(b.NOT(a), bb)
        lt = b.OR(a_lt_b, b.AND(eq, lt))
    b.output_word([lt])
    return b.build()


def gen_multiplier(width: int) -> Netlist:
    """width x width -> 2*width shift-add multiplier."""
    b = Builder(f"gen_mult_{width}")
    A = b.input_word(width)
    B = b.input_word(width)
    zero = b.const(0)
    acc = [zero] * (2 * width)
    for j, bj in enumerate(B):
        partial = [b.AND(a, bj) for a in A]
        seg = acc[j : j + width]
        S, c = b.add_word(seg, partial)
        acc[j : j + width] = S
        # propagate carry into the remaining high bits
        k = j + width
        while k < 2 * width:
            s = b.XOR(acc[k], c)
            c = b.AND(acc[k], c)
            acc[k] = s
            k += 1
    b.output_word(acc)
    return b.build()


def gen_parity(width: int = 8) -> Netlist:
    """Parity generator/checker with cascade input (parity.out parity:
    Out0 = even indicator, Out1 = odd indicator over width+1 inputs)."""
    b = Builder(f"gen_parity_{width}")
    A = b.input_word(width + 1)
    x = A[0]
    for a in A[1:]:
        x = b.XOR(x, a)
    odd = x
    even = b.NOT(x)
    b.output_word([even, odd])
    return b.build()


# ---------------------------------------------------------------------------
# New-Bristol arithmetic suite (reference corpus examples/new_bristol_ckts/
# arith/{adder64,sub64,neg64,zero_equal,mult64,mult2_64,udivide64,divide64}
# .txt, SURVEY.md §2.9).  Semantics (LSB-first words): out = in1 OP in2.
# ---------------------------------------------------------------------------


def gen_sub(width: int) -> Netlist:
    """in1 - in2 (two's complement wraparound), width -> width."""
    b = Builder(f"gen_sub_{width}")
    A = b.input_word(width)
    B = b.input_word(width)
    S, _ = b.sub_word(A, B)
    b.output_word(S)
    return b.build()


def gen_neg(width: int) -> Netlist:
    """Two's-complement negation, width -> width (neg64.txt interface)."""
    b = Builder(f"gen_neg_{width}")
    A = b.input_word(width)
    b.output_word(b.neg_word(A))
    return b.build()


def gen_zero_equal(width: int) -> Netlist:
    """out = (in == 0), width -> 1 (zero_equal.txt interface)."""
    b = Builder(f"gen_zero_equal_{width}")
    A = b.input_word(width)
    t = A[0]
    for a in A[1:]:
        t = b.OR(t, a)
    b.output_word([b.NOT(t)])
    return b.build()


def gen_mult_low(width: int) -> Netlist:
    """width x width -> width low product (mult64.txt interface): shift-add
    keeping only the low ``width`` bits."""
    b = Builder(f"gen_mult_low_{width}")
    A = b.input_word(width)
    B = b.input_word(width)
    zero = b.const(0)
    acc = [zero] * width
    for j, bj in enumerate(B):
        n = width - j
        partial = [b.AND(A[i], bj) for i in range(n)]
        S, _ = b.add_word(acc[j:], partial)
        acc[j:] = S
    b.output_word(acc)
    return b.build()


def gen_mult2(width: int) -> Netlist:
    """width x width -> full 2*width product as TWO declared output words in
    (high, low) order — the reference mult2_64.txt's pinned interface
    (header ``2 64 64``, tools/probe_conventions.py: out word 0 = high)."""
    b = Builder(f"gen_mult2_{width}")
    A = b.input_word(width)
    B = b.input_word(width)
    zero = b.const(0)
    acc = [zero] * (2 * width)
    for j, bj in enumerate(B):
        partial = [b.AND(a, bj) for a in A]
        S, c = b.add_word(acc[j : j + width], partial)
        acc[j : j + width] = S
        k = j + width
        while k < 2 * width:
            s = b.XOR(acc[k], c)
            c = b.AND(acc[k], c)
            acc[k] = s
            k += 1
    b.output_word(acc[width:])  # high word first
    b.output_word(acc[:width])
    return b.build()


def _udiv_core(b: Builder, A, B) -> List[int]:
    """Non-restoring-division quotient of unsigned LSB-first words on
    ``width``-bit two's-complement registers — the reference udivide64.txt's
    empirically pinned structure (tools/probe_conventions.py, models.udiv).

    Per step (MSB of A down): R' = (R << 1) | a_i, then R = R' - B when the
    old R was non-negative else R' + B (wrapping); q_i = NOT sign(R).
    Equals true division for B in [1, 2^(width-1)); /0 gives the
    prefix-sign pattern (all-ones when A < 2^(width-1))."""
    width = len(A)
    zero = b.const(0)
    R = [zero] * width
    sign = zero  # sign bit of R (R[-1])
    Q = [None] * width
    for i in range(width - 1, -1, -1):
        Rp = [A[i]] + R[:-1]  # shift left, bring in dividend bit
        Dm, _ = b.sub_word(Rp, B)
        Dp, _ = b.add_word(Rp, B)
        R = b.mux_word(sign, Dm, Dp)  # old-R negative ? R'+B : R'-B
        sign = R[-1]
        Q[i] = b.NOT(sign)
    return Q


def gen_udivide(width: int) -> Netlist:
    """Unsigned quotient in1 / in2 (udivide64.txt interface, non-restoring
    semantics — see _udiv_core)."""
    b = Builder(f"gen_udivide_{width}")
    A = b.input_word(width)
    B = b.input_word(width)
    b.output_word(_udiv_core(b, A, B))
    return b.build()


def gen_divide(width: int) -> Netlist:
    """Signed quotient in1 / in2, truncated toward zero (divide64.txt
    interface): |in1| / |in2| unsigned, negated when signs differ.
    Edge semantics (pinned against the reference circuit, matched by
    models.sdiv): /0 gives -1 for in1 >= 0 and +1 for in1 < 0;
    INT_MIN / -1 wraps to INT_MIN."""
    b = Builder(f"gen_divide_{width}")
    A = b.input_word(width)
    B = b.input_word(width)
    sa, sb = A[-1], B[-1]
    Aa = b.mux_word(sa, A, b.neg_word(A))
    Ba = b.mux_word(sb, B, b.neg_word(B))
    Q = _udiv_core(b, Aa, Ba)
    qs = b.XOR(sa, sb)
    b.output_word(b.mux_word(qs, Q, b.neg_word(Q)))
    return b.build()


def _word32(b: Builder, value: int) -> List[int]:
    zero = b.const(0)
    one = b.const(1)
    return [one if (value >> i) & 1 else zero for i in range(32)]


def gen_sha256_compress() -> Netlist:
    """SHA-256 compression: inputs (512-bit block, 256-bit state), output
    256-bit new state — same interface as new_bristol_ckts/crypto/sha256.txt.

    Word convention: the 512-bit input is 16 big-endian words; with the
    harness's bits_c mapping the j-th word's bits live at positions
    [512 - 32*(j+1), 512 - 32*j), LSB-first.
    """
    b = Builder("gen_sha256")
    M = b.input_word(512)
    H = b.input_word(256)
    nw = 16

    def word(flat, j, total):
        lo = total - 32 * (j + 1)
        return flat[lo : lo + 32]

    w = [word(M, j, 512) for j in range(nw)]
    zero = b.const(0)
    for i in range(16, 64):
        w15, w2 = w[i - 15], w[i - 2]
        s0 = [
            b.XOR(b.XOR(x, y), z)
            for x, y, z in zip(
                b.rotr_word(w15, 7), b.rotr_word(w15, 18), b.shr_word(w15, 3, zero)
            )
        ]
        s1 = [
            b.XOR(b.XOR(x, y), z)
            for x, y, z in zip(
                b.rotr_word(w2, 17), b.rotr_word(w2, 19), b.shr_word(w2, 10, zero)
            )
        ]
        t, _ = b.add_word(w[i - 16], s0)
        t, _ = b.add_word(t, w[i - 7])
        t, _ = b.add_word(t, s1)
        w.append(t)

    hs = [word(H, j, 256) for j in range(8)]
    a, bb, c, d, e, f, g, h = hs
    from ..harness.models import _SHA_K

    for i in range(64):
        S1 = [
            b.XOR(b.XOR(x, y), z)
            for x, y, z in zip(b.rotr_word(e, 6), b.rotr_word(e, 11), b.rotr_word(e, 25))
        ]
        ch = [b.XOR(b.AND(ee, ff), b.AND(b.NOT(ee), gg)) for ee, ff, gg in zip(e, f, g)]
        t1, _ = b.add_word(h, S1)
        t1, _ = b.add_word(t1, ch)
        t1, _ = b.add_word(t1, _word32(b, _SHA_K[i]))
        t1, _ = b.add_word(t1, w[i])
        S0 = [
            b.XOR(b.XOR(x, y), z)
            for x, y, z in zip(b.rotr_word(a, 2), b.rotr_word(a, 13), b.rotr_word(a, 22))
        ]
        maj = [
            b.XOR(b.XOR(b.AND(x, y), b.AND(x, z)), b.AND(y, z))
            for x, y, z in zip(a, bb, c)
        ]
        t2, _ = b.add_word(S0, maj)
        h, g, f = g, f, e
        e, _ = b.add_word(d, t1)
        d, c, bb = c, bb, a
        a, _ = b.add_word(t1, t2)

    outs = []
    for old, new in zip(hs, [a, bb, c, d, e, f, g, h]):
        s, _ = b.add_word(old, new)
        outs.append(s)
    flat = []
    for j in range(7, -1, -1):  # big-endian word order, matching bits_c
        flat += outs[j]
    b.output_word(flat)
    return b.build()


def gen_sha1_compress() -> Netlist:
    """SHA-1 compression: 512-bit block -> 160-bit state (fixed IV), the
    old_bristol_ckts/crypto/sha-1.txt interface (header 512 0 160).

    Bit convention: bits_d (plain MSB-first bitstring of the byte string,
    like md5); words are big-endian within the block/digest.
    """
    b = Builder("gen_sha1")
    M = b.input_word(512)

    def be_word(flat, j):
        # bytes 4j..4j+3 big-endian; bits_d gives MSB-first per byte
        bits: List[int] = []
        for byte in (3, 2, 1, 0):
            seg = flat[8 * (4 * j + byte) : 8 * (4 * j + byte) + 8]
            bits = bits + seg[::-1]  # LSB-first within byte
        return bits  # LSB-first 32-bit big-endian word

    def rotl(word, r):
        n = len(word)
        return [word[(i - r) % n] for i in range(n)]

    from ..harness.models import SHA1_IV

    w = [be_word(M, j) for j in range(16)]
    for i in range(16, 80):
        x = [
            b.XOR(b.XOR(p, q), b.XOR(r, s))
            for p, q, r, s in zip(w[i - 3], w[i - 8], w[i - 14], w[i - 16])
        ]
        w.append(rotl(x, 1))

    iv_words = [_word32(b, v) for v in SHA1_IV]
    a, bb, c, d, e = iv_words
    ks = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)
    for i in range(80):
        if i < 20:  # Ch
            f = [b.XOR(b.AND(x, y), b.AND(b.NOT(x), z)) for x, y, z in zip(bb, c, d)]
        elif 40 <= i < 60:  # Maj
            f = [
                b.XOR(b.XOR(b.AND(x, y), b.AND(x, z)), b.AND(y, z))
                for x, y, z in zip(bb, c, d)
            ]
        else:  # Parity
            f = [b.XOR(b.XOR(x, y), z) for x, y, z in zip(bb, c, d)]
        t, _ = b.add_word(rotl(a, 5), f)
        t, _ = b.add_word(t, e)
        t, _ = b.add_word(t, _word32(b, ks[i // 20]))
        t, _ = b.add_word(t, w[i])
        e, d, c, bb, a = d, c, rotl(bb, 30), a, t

    outs = []
    for init, fin in zip(iv_words, (a, bb, c, d, e)):
        s, _ = b.add_word(init, fin)
        outs.append(s)
    # output in bits_d order of the big-endian byte string
    flat: List[int] = []
    for word in outs:
        for byte in (3, 2, 1, 0):
            flat += word[8 * byte : 8 * byte + 8][::-1]
    b.output_word(flat)
    return b.build()


def gen_md5_compress() -> Netlist:
    """MD5 compression: 512-bit block -> 128-bit digest (fixed IV), same
    interface as old_bristol_ckts/crypto/md5.txt (bits_d convention: the
    j-th little-endian word's bits are at [32j, 32j+32) reversed per byte).

    For simplicity this generator uses the *harness bit order directly*:
    inputs/outputs use the bits_d mapping of the byte strings.
    """
    b = Builder("gen_md5")
    M = b.input_word(512)

    def le_word(flat, j):
        # bytes 4j..4j+3 little-endian; bits_d gives MSB-first per byte
        bits = []
        for byte in range(4):
            seg = flat[8 * (4 * j + byte) : 8 * (4 * j + byte) + 8]
            bits = bits + seg[::-1]  # LSB-first within byte
        return bits  # LSB-first 32-bit word (little-endian bytes)

    w = [le_word(M, j) for j in range(16)]
    from ..harness.models import _MD5_K, _MD5_S, _MD5_IV

    def rotl(word, r):
        n = len(word)
        return [word[(i - r) % n] for i in range(n)]

    A0, B0, C0, D0 = [_word32(b, v) for v in _MD5_IV]
    a, bb, c, d = A0, B0, C0, D0
    for i in range(64):
        if i < 16:
            F = [b.OR(b.AND(x, y), b.AND(b.NOT(x), z)) for x, y, z in zip(bb, c, d)]
            g = i
        elif i < 32:
            F = [b.OR(b.AND(z, x), b.AND(b.NOT(z), y)) for x, y, z in zip(bb, c, d)]
            g = (5 * i + 1) % 16
        elif i < 48:
            F = [b.XOR(b.XOR(x, y), z) for x, y, z in zip(bb, c, d)]
            g = (3 * i + 5) % 16
        else:
            F = [b.XOR(y, b.OR(x, b.NOT(z))) for x, y, z in zip(bb, c, d)]
            g = (7 * i) % 16
        t, _ = b.add_word(F, a)
        t, _ = b.add_word(t, _word32(b, _MD5_K[i]))
        t, _ = b.add_word(t, w[g])
        t = rotl(t, _MD5_S[i])
        nb, _ = b.add_word(bb, t)
        a, d, c, bb = d, c, bb, nb

    outs = []
    for init, fin in zip((A0, B0, C0, D0), (a, bb, c, d)):
        s, _ = b.add_word(init, fin)
        outs.append(s)
    # output in bits_d order of the little-endian byte string
    flat = []
    for word in outs:
        for byte in range(4):
            flat += word[8 * byte : 8 * byte + 8][::-1]
    b.output_word(flat)
    return b.build()


def _word64(b: Builder, value: int) -> List[int]:
    zero = b.const(0)
    one = b.const(1)
    return [one if (value >> i) & 1 else zero for i in range(64)]


def gen_sha512_compress() -> Netlist:
    """SHA-512 compression: (1024-bit block, 512-bit state) -> 512-bit state
    (the reference lists sha512.txt in its corpus CMake but the blob is
    missing — SURVEY.md §2.9; generated here).  bits_c convention like
    sha256 (big-endian words)."""
    b = Builder("gen_sha512")
    M = b.input_word(1024)
    H = b.input_word(512)
    from ..harness.models import _SHA512_K

    def word(flat, j, total):
        lo = total - 64 * (j + 1)
        return flat[lo : lo + 64]

    zero = b.const(0)
    w = [word(M, j, 1024) for j in range(16)]
    for i in range(16, 80):
        w15, w2 = w[i - 15], w[i - 2]
        s0 = [
            b.XOR(b.XOR(x, y), z)
            for x, y, z in zip(
                b.rotr_word(w15, 1), b.rotr_word(w15, 8), b.shr_word(w15, 7, zero)
            )
        ]
        s1 = [
            b.XOR(b.XOR(x, y), z)
            for x, y, z in zip(
                b.rotr_word(w2, 19), b.rotr_word(w2, 61), b.shr_word(w2, 6, zero)
            )
        ]
        t, _ = b.add_word(w[i - 16], s0)
        t, _ = b.add_word(t, w[i - 7])
        t, _ = b.add_word(t, s1)
        w.append(t)

    hs = [word(H, j, 512) for j in range(8)]
    a, bb, c, d, e, f, g, h = hs
    for i in range(80):
        S1 = [
            b.XOR(b.XOR(x, y), z)
            for x, y, z in zip(
                b.rotr_word(e, 14), b.rotr_word(e, 18), b.rotr_word(e, 41)
            )
        ]
        ch = [b.XOR(b.AND(ee, ff), b.AND(b.NOT(ee), gg)) for ee, ff, gg in zip(e, f, g)]
        t1, _ = b.add_word(h, S1)
        t1, _ = b.add_word(t1, ch)
        t1, _ = b.add_word(t1, _word64(b, _SHA512_K[i]))
        t1, _ = b.add_word(t1, w[i])
        S0 = [
            b.XOR(b.XOR(x, y), z)
            for x, y, z in zip(
                b.rotr_word(a, 28), b.rotr_word(a, 34), b.rotr_word(a, 39)
            )
        ]
        maj = [
            b.XOR(b.XOR(b.AND(x, y), b.AND(x, z)), b.AND(y, z))
            for x, y, z in zip(a, bb, c)
        ]
        t2, _ = b.add_word(S0, maj)
        h, g, f = g, f, e
        e, _ = b.add_word(d, t1)
        d, c, bb = c, bb, a
        a, _ = b.add_word(t1, t2)

    outs = []
    for old, new in zip(hs, [a, bb, c, d, e, f, g, h]):
        s, _ = b.add_word(old, new)
        outs.append(s)
    flat: List[int] = []
    for j in range(7, -1, -1):  # big-endian word order (bits_c)
        flat += outs[j]
    b.output_word(flat)
    return b.build()


def gen_keccak_f() -> Netlist:
    """Keccak-f[1600] permutation, 1600 -> 1600 (Keccak_f.txt is a missing
    blob in the reference corpus; generated here).  Bit convention: flat
    bits_lsb of the 200-byte state, lane (x, y) little-endian at bytes
    8*(x + 5y) — so flat[64*(x + 5y) + z] is lane bit z.  Matches
    models.keccak_f (itself hashlib-SHA3-checked)."""
    b = Builder("gen_keccak_f")
    S = b.input_word(1600)
    from ..harness.models import _keccak_rcs, _keccak_rots

    rot = _keccak_rots()
    A = [[S[64 * (x + 5 * y) : 64 * (x + 5 * y) + 64] for y in range(5)]
         for x in range(5)]

    def rotl(w, n):
        n %= 64
        return [w[(z - n) % 64] for z in range(64)]

    for rc in _keccak_rcs():
        # theta
        C = []
        for x in range(5):
            t = A[x][0]
            for y in range(1, 5):
                t = b.xor_word(t, A[x][y])
            C.append(t)
        D = [b.xor_word(C[(x - 1) % 5], rotl(C[(x + 1) % 5], 1)) for x in range(5)]
        A = [[b.xor_word(A[x][y], D[x]) for y in range(5)] for x in range(5)]
        # rho + pi
        B = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                B[y][(2 * x + 3 * y) % 5] = rotl(A[x][y], rot[x][y])
        # chi
        A = [
            [
                [
                    b.XOR(B[x][y][z], b.AND(b.NOT(B[(x + 1) % 5][y][z]),
                                            B[(x + 2) % 5][y][z]))
                    for z in range(64)
                ]
                for y in range(5)
            ]
            for x in range(5)
        ]
        # iota
        A[0][0] = [b.NOT(w) if (rc >> z) & 1 else w for z, w in enumerate(A[0][0])]

    flat: List[int] = []
    for y in range(5):
        for x in range(5):
            flat += A[x][y]
    b.output_word(flat)
    return b.build()


# ---------------------------------------------------------------------------
# DES (reference corpus old_bristol_ckts/crypto/DES-{expanded,non-expanded}
# .txt, SURVEY.md §2.9).  S-boxes synthesized as 6-input LUTs (Shannon
# lowering, circuits/lut.py); permutations/expansions/key schedule are pure
# wiring.  Bit convention: bits_d (FIPS bit 1 = flat[0]).
# ---------------------------------------------------------------------------


def _des_sbox_masks():
    from ..harness.models import _DES_SBOX

    masks = []  # per sbox: 4 output-bit LUT masks over ins [b6,b5,b4,b3,b2,b1]
    for s in range(8):
        m = [0, 0, 0, 0]
        for v in range(64):
            b1, b2, b3, b4, b5, b6 = (
                (v >> 5) & 1, (v >> 4) & 1, (v >> 3) & 1,
                (v >> 2) & 1, (v >> 1) & 1, v & 1,
            )
            val = _DES_SBOX[s][2 * b1 + b6][8 * b2 + 4 * b3 + 2 * b4 + b5]
            for j in range(4):  # output bit j is MSB-first (FIPS order)
                m[j] |= ((val >> (3 - j)) & 1) << v
        masks.append(m)
    return masks


def gen_des(expanded_key: bool = True) -> Netlist:
    """DES encryption (DES-expanded: 64-bit block + 768-bit round-key
    vector; DES-non-expanded: 64-bit block + 64-bit key with the FIPS 46-3
    key schedule as wiring).  Verified against models.des_encrypt."""
    from ..harness.models import (
        _DES_E, _DES_FP, _DES_IP, _DES_P, _DES_PC1, _DES_PC2, _DES_SHIFTS,
    )

    b = Builder("gen_des_" + ("expanded" if expanded_key else "nonexpanded"))
    pt = b.input_word(64)
    key = b.input_word(768 if expanded_key else 64)

    def perm(bits, table):
        return [bits[i - 1] for i in table]

    if expanded_key:
        rks = [key[48 * r : 48 * (r + 1)] for r in range(16)]
    else:
        cd = perm(key, _DES_PC1)
        c, d = cd[:28], cd[28:]
        rks = []
        for s in _DES_SHIFTS:
            c = c[s:] + c[:s]
            d = d[s:] + d[:s]
            rks.append(perm(c + d, _DES_PC2))

    masks = _des_sbox_masks()
    bits = perm(pt, _DES_IP)
    l, r = bits[:32], bits[32:]
    for rk in rks:
        x = b.xor_word(perm(r, _DES_E), rk)
        sout: List[int] = []
        for s in range(8):
            b6 = x[6 * s : 6 * s + 6]
            ins = b6[::-1]  # LUT index LSB-first = [b6,b5,b4,b3,b2,b1]
            sout += [b.LUT(masks[s][j], ins) for j in range(4)]
        f = perm(sout, _DES_P)
        l, r = r, b.xor_word(l, f)
    b.output_word(perm(r + l, _DES_FP))
    return b.build()


# ---------------------------------------------------------------------------
# AES-128 (reference workload TB_aes; circuit generated from the algebraic
# S-box: GF(2^8) inversion by square-multiply chain + affine map, so the
# netlist is derived, not transcribed).  Bit convention matches
# harness/testlib.bits_d: flat MSB-first bitstring (byte i bits at positions
# 8i..8i+7, MSB first), the convention pinned for the reference AES corpus
# (test_aes.cpp:184-233).
# ---------------------------------------------------------------------------

_AES_P = 0x11B


def _gfm_int(a: int, b_: int) -> int:
    r = 0
    while b_:
        if b_ & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= _AES_P
        b_ >>= 1
    return r


def _lin_cols(f) -> List[int]:
    """Column masks of a GF(2)-linear byte map f: out_j = XOR of in_i where
    bit j of cols[i] is set."""
    return [f(1 << i) & 0xFF for i in range(8)]


def _aff_int(v: int) -> int:
    s = 0
    for i in range(8):
        bit = (
            (v >> i) ^ (v >> ((i + 4) % 8)) ^ (v >> ((i + 5) % 8))
            ^ (v >> ((i + 6) % 8)) ^ (v >> ((i + 7) % 8))
        ) & 1
        s |= bit << i
    return s


_SQ_COLS = _lin_cols(lambda v: _gfm_int(v, v))
_AFF_COLS = _lin_cols(_aff_int)
# x^k mod P as a byte, for schoolbook-product reduction (k = 0..14)
_RED = [(_gfm_int(1 << (k - 8), 0x1B) if k >= 8 else 1 << k) for k in range(15)]


class _AesOps:
    """Byte-level circuit ops over LSB-first 8-wire byte lists."""

    def __init__(self, b: Builder):
        self.b = b

    def xor_tree(self, ws):
        t = ws[0]
        for u in ws[1:]:
            t = self.b.XOR(t, u)
        return t

    def lin(self, ins, cols, const=0):
        """ins: wires; cols[i]: output-bit mask of input i; const: XOR byte."""
        out = []
        for j in range(8):
            terms = [w for w, c in zip(ins, cols) if (c >> j) & 1]
            cb = (const >> j) & 1
            if not terms:
                out.append(self.b.const(cb))
            else:
                t = self.xor_tree(terms)
                out.append(self.b.NOT(t) if cb else t)
        return out

    def xor_const(self, byte, c):
        return [self.b.NOT(w) if (c >> j) & 1 else w for j, w in enumerate(byte)]

    def byte_xor(self, A, B):
        return [self.b.XOR(x, y) for x, y in zip(A, B)]

    def gf_mul(self, A, B):
        """Schoolbook GF(2^8) product: 64 ANDs + XOR trees + reduction."""
        part: dict = {}
        for i in range(8):
            for j in range(8):
                part.setdefault(i + j, []).append(self.b.AND(A[i], B[j]))
        out_terms: List[List[int]] = [[] for _ in range(8)]
        for k, plist in part.items():
            ck = self.xor_tree(plist)
            for j in range(8):
                if (_RED[k] >> j) & 1:
                    out_terms[j].append(ck)
        return [self.xor_tree(t) for t in out_terms]

    def gf_sq(self, A):
        return self.lin(A, _SQ_COLS)

    def inv(self, A):
        """x^254 by square-multiply: t <- t^2 * x five times from x^3."""
        t = self.gf_mul(self.gf_sq(A), A)  # x^3
        for _ in range(5):  # x^7, x^15, x^31, x^63, x^127
            t = self.gf_mul(self.gf_sq(t), A)
        return self.gf_sq(t)  # x^254

    def sbox(self, A):
        return self.lin(self.inv(A), _AFF_COLS, 0x63)


def _bytes_from_word(word: List[int], n_bytes: int) -> List[List[int]]:
    """bits_d word (MSB-first per byte) -> list of LSB-first byte wire lists."""
    return [word[8 * i : 8 * i + 8][::-1] for i in range(n_bytes)]


def _word_from_bytes(bts: List[List[int]]) -> List[int]:
    out: List[int] = []
    for byte in bts:
        out += byte[::-1]
    return out


def _bytes_from_word_c(word: List[int], n_bytes: int) -> List[List[int]]:
    """bits_c word (whole value little-endian: byte order reversed, bits
    LSB-first per byte) -> list of LSB-first byte wire lists in byte-string
    order."""
    return [word[8 * (n_bytes - 1 - i) : 8 * (n_bytes - i)] for i in range(n_bytes)]


def _word_from_bytes_c(bts: List[List[int]]) -> List[int]:
    out: List[int] = []
    for byte in reversed(bts):
        out += list(byte)
    return out


def _aes_schedule(ops: "_AesOps", kbytes, nk: int, nr: int):
    """In-circuit FIPS-197 key schedule (aes_expand_key parity, models.py)."""
    w = [kbytes[4 * i : 4 * i + 4] for i in range(nk)]
    rcon = 1
    for i in range(nk, 4 * (nr + 1)):
        t = [list(x) for x in w[i - 1]]
        if i % nk == 0:
            t = t[1:] + t[:1]
            t = [ops.sbox(x) for x in t]
            t[0] = ops.xor_const(t[0], rcon)
            rcon = _gfm_int(rcon, 2)
        elif nk > 6 and i % nk == 4:
            t = [ops.sbox(x) for x in t]
        w.append([ops.byte_xor(a, x) for a, x in zip(w[i - nk], t)])
    return [sum(w[4 * r : 4 * r + 4], []) for r in range(nr + 1)]


_MIX = [[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]]


def _aes_rounds(ops: "_AesOps", state, rks):
    """The Nr-round AES data path on a 16-byte wire state."""

    def add_rk(s, rk):
        return [ops.byte_xor(a, k) for a, k in zip(s, rk)]

    def sub(s):
        return [ops.sbox(x) for x in s]

    def shift_rows(s):
        out = [None] * 16
        for r in range(4):
            for c in range(4):
                out[r + 4 * c] = s[r + 4 * ((c + r) % 4)]
        return out

    def mix(s):
        out = []
        for c in range(4):
            col = s[4 * c : 4 * c + 4]
            flat = sum(col, [])
            for r in range(4):
                cols = []
                for coeff in _MIX[r]:
                    cols += _lin_cols(lambda v, k=coeff: _gfm_int(v, k))
                out.append(ops.lin(flat, cols))
        return out

    nr = len(rks) - 1
    state = add_rk(state, rks[0])
    for rnd in range(1, nr):
        state = add_rk(mix(shift_rows(sub(state))), rks[rnd])
    return add_rk(shift_rows(sub(state)), rks[nr])


def gen_aes128(expanded_key: bool = True) -> Netlist:
    """AES-128 encryption circuit (TB_aes parity: AES-expanded takes a
    1408-bit pre-expanded key, AES-non-expanded a 128-bit key with the key
    schedule synthesized in-circuit, test_aes.cpp:184-233)."""
    b = Builder("gen_aes128_" + ("expanded" if expanded_key else "nonexpanded"))
    ops = _AesOps(b)
    pt_w = b.input_word(128)
    key_w = b.input_word(1408 if expanded_key else 128)
    state = _bytes_from_word(pt_w, 16)
    if expanded_key:
        rks = [_bytes_from_word(key_w[128 * r : 128 * (r + 1)], 16) for r in range(11)]
    else:
        rks = _aes_schedule(ops, _bytes_from_word(key_w, 16), 4, 10)
    b.output_word(_word_from_bytes(_aes_rounds(ops, state, rks)))
    return b.build()


def gen_aes(key_bits: int) -> Netlist:
    """AES-128/192/256 with the new-Bristol corpus interface
    (new_bristol_ckts/crypto/aes_{128,192,256}.txt headers: in1 = key,
    in2 = 128-bit block, out = 128-bit ciphertext; SURVEY.md §2.9), key
    schedule in-circuit.  All words use the whole-value little-endian
    (bits_c) convention, pinned against the reference files
    (tools/probe_conventions.py).  Matches models.aes_encrypt."""
    assert key_bits in (128, 192, 256)
    nk = key_bits // 32
    b = Builder(f"gen_aes_{key_bits}")
    ops = _AesOps(b)
    key_w = b.input_word(key_bits)
    pt_w = b.input_word(128)
    rks = _aes_schedule(ops, _bytes_from_word_c(key_w, key_bits // 8), nk, nk + 6)
    state = _bytes_from_word_c(pt_w, 16)
    b.output_word(_word_from_bytes_c(_aes_rounds(ops, state, rks)))
    return b.build()
