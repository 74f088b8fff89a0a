"""IEEE-754 binary64 circuit generators (FP-add/mul/div/sqrt/eq/f2i).

The reference ships FP-{add,eq,f2i,mul}.txt as data only (no TB, no golden
vectors; FP-div/FP-sqrt are missing blobs — SURVEY.md §2.9); here the whole
family is *generated* and bit-exactly matches the integer-arithmetic golden
models (harness/models.py fp_*), which are themselves fuzz-checked against
the host FPU (tests/test_fp.py).  Semantics: round-to-nearest-even, full
subnormal support, with the special-value conventions pinned empirically
against the reference's FP-{add,mul,eq,f2i}.txt circuits
(tools/probe_conventions.py): NaN inputs propagate payload+sign with the
quiet bit forced (second operand wins when both are NaN); invalid ops
(inf-inf, 0*inf, 0/0, inf/inf, sqrt(-x)) produce 0x7FFFFFFFFFFFFFFF; f2i
is saturating round-to-nearest-even.

Words are LSB-first wire lists: sign = w[63], exponent = w[52:63],
mantissa = w[0:52].

Construction notes (the textbook FPU datapath, gate-level):
  * alignment/normalization use mux barrel shifters with sticky collection;
  * sticky is OR-folded into the LSB before any add/sub, which provably
    preserves round-to-nearest-even (no fake ties: the folded LSB is odd
    whenever a nonzero tail was dropped);
  * one shared backend normalizes an exact 106-bit significand P with
    value = P * 2^W: full left-normalize (LZC), subnormal right-shift when
    the biased exponent E <= 0, then pack-and-increment rounding on the
    packed 63-bit integer (monotonic IEEE encoding makes mantissa-overflow
    and subnormal->normal promotion automatic).

The port's own copy of ``oece_tpu.circuits.fp``, kept in step with it
(tests/test_torch_harness.py): the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

from .gen import Builder
from .netlist import Netlist

INVALID = 0x7FFFFFFFFFFFFFFF  # invalid-op result (reference-circuit pinned)


# ---------------------------------------------------------------------------
# word-level helpers
# ---------------------------------------------------------------------------


def _or_tree(b: Builder, ws: List[int]) -> int:
    ws = list(ws)
    if not ws:
        return b.const(0)
    while len(ws) > 1:
        nxt = [b.OR(ws[i], ws[i + 1]) for i in range(0, len(ws) - 1, 2)]
        if len(ws) % 2:
            nxt.append(ws[-1])
        ws = nxt
    return ws[0]


def _and_tree(b: Builder, ws: List[int]) -> int:
    ws = list(ws)
    if not ws:
        return b.const(1)
    while len(ws) > 1:
        nxt = [b.AND(ws[i], ws[i + 1]) for i in range(0, len(ws) - 1, 2)]
        if len(ws) % 2:
            nxt.append(ws[-1])
        ws = nxt
    return ws[0]


def _const_word(b: Builder, value: int, n: int) -> List[int]:
    return [b.const((value >> i) & 1) for i in range(n)]


def _inc_word(b: Builder, A: List[int], cin: int) -> Tuple[List[int], int]:
    """A + cin (single-bit); returns (sum, carry-out)."""
    S = []
    c = cin
    for a in A:
        S.append(b.XOR(a, c))
        c = b.AND(a, c)
    return S, c


def _bsr_sticky(
    b: Builder, word: List[int], amt: List[int], sticky: int | None = None
) -> Tuple[List[int], int]:
    """Right barrel shift by the unsigned amount `amt` (LSB-first bits);
    returns (shifted, sticky) where sticky ORs every shifted-out bit (and
    the optional incoming sticky)."""
    n = len(word)
    w = list(word)
    zero = b.const(0)
    for k, s in enumerate(amt):
        sh = 1 << k
        dropped = w[: min(sh, n)]
        d = b.AND(s, _or_tree(b, dropped))
        sticky = d if sticky is None else b.OR(sticky, d)
        w = [b.MUX(s, w[i], w[i + sh] if i + sh < n else zero) for i in range(n)]
    return w, (sticky if sticky is not None else zero)


def _bsl(b: Builder, word: List[int], amt: List[int]) -> List[int]:
    """Left barrel shift by `amt`; bits shifted past the top are discarded
    (callers guarantee none are significant)."""
    n = len(word)
    w = list(word)
    zero = b.const(0)
    for k, s in enumerate(amt):
        sh = 1 << k
        w = [b.MUX(s, w[i], w[i - sh] if i - sh >= 0 else zero) for i in range(n)]
    return w


def _lzc(b: Builder, word: List[int]) -> Tuple[List[int], int]:
    """Leading-zero count of a power-of-two-length word (LSB-first).
    Returns (count bits LSB-first, all_zero flag); the count is undefined
    when all_zero."""
    n = len(word)
    assert n & (n - 1) == 0
    if n == 1:
        return [], b.NOT(word[0])
    half = n // 2
    lo, hi = word[:half], word[half:]
    c_hi, z_hi = _lzc(b, hi)
    c_lo, z_lo = _lzc(b, lo)
    count = [b.MUX(z_hi, ch, cl) for ch, cl in zip(c_hi, c_lo)] + [z_hi]
    return count, b.AND(z_hi, z_lo)


def _pad_pow2(b: Builder, word: List[int], n: int) -> List[int]:
    """Pad at the LSB end (does not change the leading-zero count)."""
    zero = b.const(0)
    return [zero] * (n - len(word)) + list(word)


# ---------------------------------------------------------------------------
# field classification
# ---------------------------------------------------------------------------


class _Cls:
    def __init__(self, b: Builder, X: List[int]):
        self.sign = X[63]
        self.exp = X[52:63]  # 11 bits
        self.man = X[0:52]
        self.e_zero = b.NOT(_or_tree(b, self.exp))
        self.e_max = _and_tree(b, self.exp)
        self.m_zero = b.NOT(_or_tree(b, self.man))
        self.is_nan = b.AND(self.e_max, b.NOT(self.m_zero))
        self.is_inf = b.AND(self.e_max, self.m_zero)
        self.is_zero = b.AND(self.e_zero, self.m_zero)
        # effective biased exponent max(e, 1) and significand with implicit bit
        self.e_eff = [b.OR(self.exp[0], self.e_zero)] + list(self.exp[1:])
        self.sig = list(self.man) + [b.NOT(self.e_zero)]  # 53 bits


def _invalid_word(b: Builder) -> List[int]:
    return _const_word(b, INVALID, 64)


def _nan_special(
    b: Builder, A: List[int], B: List[int], ca: _Cls, cb: _Cls,
    invalid: int, res64: List[int],
) -> List[int]:
    """Apply the family's special-value conventions to a computed result:
    invalid-op -> 0x7FFF...F; any NaN input -> that operand (B wins when
    both are NaN) with the quiet bit (bit 51) forced."""
    res64 = b.mux_word(invalid, res64, _invalid_word(b))
    prop = b.mux_word(cb.is_nan, A, B)  # NaN source operand
    prop = prop[:51] + [b.const(1)] + prop[52:]
    nan_in = b.OR(ca.is_nan, cb.is_nan)
    return b.mux_word(nan_in, res64, prop)


def _inf63(b: Builder) -> List[int]:
    return _const_word(b, 0x7FF << 52, 63)


def _sext(b: Builder, word: List[int], n: int) -> List[int]:
    return list(word) + [word[-1]] * (n - len(word))


def _zext(b: Builder, word: List[int], n: int) -> List[int]:
    zero = b.const(0)
    return list(word) + [zero] * (n - len(word))


# ---------------------------------------------------------------------------
# shared normalize/round/pack backend
# ---------------------------------------------------------------------------

_EW = 14  # signed exponent datapath width


def _pack_from_p106(b: Builder, P106: List[int], W: List[int]) -> List[int]:
    """Normalize-round-pack: exact value = P106 * 2^W (P106's bit 0 may be a
    sticky OR-fold), W a 14-bit signed word.  Returns the 63-bit packed
    magnitude (exp|mant); the caller supplies the sign and special cases.

    Zero P106 packs to +0 automatically; overflow packs to the inf pattern.
    """
    assert len(P106) == 106 and len(W) == _EW
    count, p_zero = _lzc(b, _pad_pow2(b, P106, 128))  # count == lz of P106
    Pn = _bsl(b, P106, count)  # leading bit at 105 (when nonzero)
    T = list(Pn[50:106])  # 56 bits: [S R G m0..m52]
    sticky_low = _or_tree(b, Pn[0:50])
    T[0] = b.OR(T[0], sticky_low)

    # biased exponent of the leading bit: E = W + 1128 - lz
    E = b.add_word(W, _const_word(b, 1128, _EW))[0]
    E = b.sub_word(E, _zext(b, count, _EW))[0]

    # E <= 0 -> subnormal: right shift by min(1 - E, 63) with sticky
    Em1 = b.sub_word(E, _const_word(b, 1, _EW))[0]
    neg = Em1[_EW - 1]  # E <= 0
    r = b.neg_word(Em1)  # 1 - E (valid when neg)
    r_hi = _or_tree(b, r[6 : _EW - 1])
    samt = [b.AND(neg, b.OR(r[k], r_hi)) for k in range(6)]
    T2, st2 = _bsr_sticky(b, T, samt)
    T2[0] = b.OR(T2[0], st2)

    e_ok = b.AND(b.NOT(neg), b.NOT(p_zero))
    E_field = [b.AND(E[k], e_ok) for k in range(11)]

    # packed pre-round integer [mant52 | exp11] + RNE increment
    P63 = list(T2[3:55]) + E_field
    g, rr, s0, m0 = T2[2], T2[1], T2[0], T2[3]
    round_up = b.AND(g, b.OR(rr, b.OR(s0, m0)))
    P63r, _ = _inc_word(b, P63, round_up)

    # pre-round overflow: E >= 2047 (post-round carry to 2047 is already the
    # correct inf pattern)
    Eov = b.sub_word(E, _const_word(b, 2047, _EW))[0]
    ovf = b.AND(b.NOT(Eov[_EW - 1]), e_ok)
    return b.mux_word(ovf, P63r, _inf63(b))


def _normalize_sig(b: Builder, c: _Cls) -> Tuple[List[int], List[int]]:
    """(53-bit left-normalized significand, 14-bit signed exponent of its
    LSB).  value = sig_n * 2^xn; subnormals are normalized so sig_n's top
    bit is set whenever the input is nonzero."""
    count, _ = _lzc(b, _pad_pow2(b, c.sig, 64))  # LSB-pad: count == lz of sig
    sig_n = _bsl(b, c.sig, count[:6])  # lz <= 53 < 64
    # xn = e_eff - 1075 - lz
    xn = b.sub_word(_zext(b, c.e_eff, _EW), _const_word(b, 1075, _EW))[0]
    xn = b.sub_word(xn, _zext(b, count[:6], _EW))[0]
    return sig_n, xn


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


def gen_fp_add() -> Netlist:
    """FP-add.txt interface: in1 + in2 -> out (binary64, RNE).
    Matches models.fp_add bit-exactly (tests/test_fp.py)."""
    b = Builder("gen_fp_add")
    A = b.input_word(64)
    B = b.input_word(64)
    ca, cb = _Cls(b, A), _Cls(b, B)

    # |A| >= |B| ordering: the 63-bit magnitude order of IEEE patterns is
    # the unsigned integer order (true across normals and subnormals)
    _, a_ge_b = b.sub_word(A[:63], B[:63])
    swap = b.NOT(a_ge_b)
    X = b.mux_word(swap, A, B)
    Y = b.mux_word(swap, B, A)
    cx, cy = _Cls(b, X), _Cls(b, Y)

    subtract = b.XOR(ca.sign, cb.sign)

    # align Y to X: d = ex' - ey' (>= 0), clamp to 63
    d = b.sub_word(_zext(b, cx.e_eff, 12), _zext(b, cy.e_eff, 12))[0]
    d_hi = _or_tree(b, d[6:12])
    samt = [b.OR(d[k], d_hi) for k in range(6)]
    zero = b.const(0)
    fy_ext = [zero, zero, zero] + list(cy.sig)  # 56 bits (G R S pad)
    y_sh, sticky = _bsr_sticky(b, fy_ext, samt)
    y_sh[0] = b.OR(y_sh[0], sticky)  # sticky OR-fold (RNE-safe)

    fx_ext = [zero, zero, zero] + list(cx.sig)
    ssum, cout = b.add_word(fx_ext, y_sh)
    sdiff, _ = b.sub_word(fx_ext, y_sh)
    mag = b.mux_word(subtract, ssum + [cout], sdiff + [zero])  # 57 bits

    # value = mag * 2^(ex' - 1078); backend wants P106 = mag << 49
    P106 = [zero] * 49 + mag
    W = b.sub_word(_zext(b, cx.e_eff, _EW), _const_word(b, 1127, _EW))[0]
    P63 = _pack_from_p106(b, P106, W)

    # sign: larger-magnitude operand's, except exact zero -> +0 unless both
    # inputs are -0
    mag_zero = b.NOT(_or_tree(b, mag))
    sign = b.MUX(mag_zero, cx.sign, b.AND(ca.sign, cb.sign))

    # specials
    invalid = b.AND(b.AND(ca.is_inf, cb.is_inf), subtract)  # inf + (-inf)
    any_inf = b.OR(ca.is_inf, cb.is_inf)
    sign_inf = b.MUX(ca.is_inf, cb.sign, ca.sign)
    res63 = b.mux_word(any_inf, P63, _inf63(b))
    sign = b.MUX(any_inf, sign, sign_inf)
    b.output_word(_nan_special(b, A, B, ca, cb, invalid, res63 + [sign]))
    return b.build()


def _mul_sig(b: Builder, A: List[int], B: List[int]) -> List[int]:
    """Shift-add product, len(A)+len(B) bits (circuits/gen.gen_multiplier
    core on existing wires)."""
    zero = b.const(0)
    n, m = len(A), len(B)
    acc = [zero] * (n + m)
    for j, bj in enumerate(B):
        partial = [b.AND(a, bj) for a in A]
        S, c = b.add_word(acc[j : j + n], partial)
        acc[j : j + n] = S
        k = j + n
        while k < n + m:
            s = b.XOR(acc[k], c)
            c = b.AND(acc[k], c)
            acc[k] = s
            k += 1
    return acc


def gen_fp_mul() -> Netlist:
    """FP-mul.txt interface: in1 * in2 -> out (binary64, RNE)."""
    b = Builder("gen_fp_mul")
    A = b.input_word(64)
    B = b.input_word(64)
    ca, cb = _Cls(b, A), _Cls(b, B)
    sign = b.XOR(ca.sign, cb.sign)

    P106 = _mul_sig(b, ca.sig, cb.sig)
    # value = P * 2^(xa + xb), xa = ea' - 1075
    W = b.add_word(_zext(b, ca.e_eff, _EW), _zext(b, cb.e_eff, _EW))[0]
    W = b.sub_word(W, _const_word(b, 2150, _EW))[0]
    P63 = _pack_from_p106(b, P106, W)

    invalid = b.OR(  # 0 * inf
        b.AND(ca.is_inf, cb.is_zero), b.AND(cb.is_inf, ca.is_zero)
    )
    any_inf = b.OR(ca.is_inf, cb.is_inf)
    res63 = b.mux_word(any_inf, P63, _inf63(b))
    b.output_word(_nan_special(b, A, B, ca, cb, invalid, res63 + [sign]))
    return b.build()


def gen_fp_div() -> Netlist:
    """in1 / in2 -> out (binary64, RNE).  FP-div.txt is a missing blob in
    the reference corpus; this generator provides it.  Restoring long
    division on left-normalized significands with remainder sticky."""
    b = Builder("gen_fp_div")
    A = b.input_word(64)
    B = b.input_word(64)
    ca, cb = _Cls(b, A), _Cls(b, B)
    sign = b.XOR(ca.sign, cb.sign)

    fa, xa = _normalize_sig(b, ca)
    fb, xb = _normalize_sig(b, cb)

    # q = floor((fa << 55) / fb) in [2^54, 2^56): restoring long division.
    # Preload the remainder with the dividend's top 52 bits (= fa >> 1,
    # guaranteed < fb since both are left-normalized), then 56 digit steps.
    zero = b.const(0)
    fbx = list(fb) + [zero]  # 54-bit compare width
    R = list(fa[1:53]) + [zero, zero]  # 54 bits
    Q: List[int] = [None] * 56
    stream = [fa[0]] + [zero] * 55  # remaining dividend bits, MSB-first
    for i, bit in enumerate(stream):
        Rp = [bit] + R[:-1]
        Dm, ge = b.sub_word(Rp, fbx)
        Q[55 - i] = ge
        R = b.mux_word(ge, Rp, Dm)
    sticky = _or_tree(b, R)
    num = [sticky] + Q + [zero]  # (q << 1) | sticky, 58 bits

    # value = num * 2^(xa - xb - 56); P106 = num << 48
    P106 = [zero] * 48 + num
    W = b.sub_word(xa, xb)[0]
    W = b.sub_word(W, _const_word(b, 56 + 48, _EW))[0]
    P63 = _pack_from_p106(b, P106, W)

    invalid = b.OR(  # inf/inf, 0/0
        b.AND(ca.is_inf, cb.is_inf), b.AND(ca.is_zero, cb.is_zero)
    )
    # x/inf -> 0, x/0 -> inf, inf/x -> inf
    res63 = b.mux_word(cb.is_zero, P63, _inf63(b))
    res63 = b.mux_word(ca.is_inf, res63, _inf63(b))
    res63 = b.mux_word(cb.is_inf, res63, _const_word(b, 0, 63))
    res63 = b.mux_word(ca.is_zero, res63, _const_word(b, 0, 63))
    # priority fixups: ca.is_zero/cb.is_inf zero wins over inf paths above
    # except the invalid/NaN combinations, which _nan_special handles
    b.output_word(_nan_special(b, A, B, ca, cb, invalid, res63 + [sign]))
    return b.build()


def gen_fp_sqrt() -> Netlist:
    """sqrt(in1) -> out (binary64, RNE).  FP-sqrt.txt is a missing blob in
    the reference corpus; this generator provides it.  Digit-by-digit
    (restoring) square root with remainder sticky."""
    b = Builder("gen_fp_sqrt")
    A = b.input_word(64)
    ca = _Cls(b, A)

    fa, xa = _normalize_sig(b, ca)  # value = fa * 2^xa, fa top bit set
    zero = b.const(0)
    # make the exponent even: if xa odd, shift significand left 1
    odd = xa[0]
    M0 = b.mux_word(odd, _zext(b, fa, 54), [zero] + list(fa))  # 54 bits
    # t' = xa - odd;  result exponent contribution (t' - 56)/2 - 1
    tp = b.sub_word(xa, _zext(b, [odd], _EW))[0]
    # M = M0 << 56 -> s = isqrt(M) in [2^54, 2^55.5): 112-bit radicand
    M = [zero] * 56 + M0 + [zero] * 2  # pad to 112 for 56 digit pairs

    # restoring sqrt: process digit pairs from the top
    s_bits: List[int] = []  # accumulated root, MSB-first in s_bits order
    R: List[int] = [zero] * 60  # remainder: Rp = 4R + pair needs 2 bits of headroom
    for i in range(56):
        hi2 = [M[110 - 2 * i], M[111 - 2 * i]]  # next two radicand bits (lsb first)
        Rp = hi2 + R[:-2]
        # trial = (s << 2) | 1
        trial = [b.const(1), zero] + s_bits[::-1] + [zero] * (
            len(R) - 2 - len(s_bits)
        )
        Dm, ge = b.sub_word(Rp, trial)
        R = b.mux_word(ge, Rp, Dm)
        s_bits.append(ge)
    s = s_bits[::-1]  # LSB-first, 56 bits
    sticky = _or_tree(b, R)
    num = [sticky] + s + [zero]  # 58 bits

    # value = num * 2^((t'-56)/2 - 1); P106 = num << 48
    half = b.sub_word(tp, _const_word(b, 56, _EW))[0]
    half = half[1:] + [half[-1]]  # arithmetic >> 1 (t'-56 is even)
    W = b.sub_word(half, _const_word(b, 49, _EW))[0]
    P106 = [zero] * 48 + num
    P63 = _pack_from_p106(b, P106, W)

    # specials: sqrt(+-0) = +-0; sqrt(x<0) = invalid; sqrt(+inf) = +inf
    invalid = b.AND(ca.sign, b.NOT(b.OR(ca.is_zero, ca.is_nan)))
    res63 = b.mux_word(ca.is_inf, P63, _inf63(b))
    res63 = b.mux_word(ca.is_zero, res63, _const_word(b, 0, 63))
    sign = b.AND(ca.sign, ca.is_zero)
    b.output_word(_nan_special(b, A, A, ca, ca, invalid, res63 + [sign]))
    return b.build()


def gen_fp_eq() -> Netlist:
    """FP-eq.txt interface: out bit0 = (in1 == in2) IEEE equality (NaN
    compares unequal, +-0 equal); upper 63 output bits are 0."""
    b = Builder("gen_fp_eq")
    A = b.input_word(64)
    B = b.input_word(64)
    ca, cb = _Cls(b, A), _Cls(b, B)
    neq = _or_tree(b, [b.XOR(x, y) for x, y in zip(A, B)])
    both_zero = b.AND(ca.is_zero, cb.is_zero)
    nan = b.OR(ca.is_nan, cb.is_nan)
    res = b.AND(b.NOT(nan), b.OR(b.NOT(neq), both_zero))
    b.output_word([res] + [b.const(0)] * 63)
    return b.build()


def gen_fp_f2i() -> Netlist:
    """FP-f2i.txt interface: double -> int64, saturating round-to-nearest-
    even (the reference circuit's pinned semantics, matching models.fp_f2i):
    NaN (any sign) and positive overflow/+inf -> INT64_MAX; negative
    overflow/-inf -> INT64_MIN."""
    b = Builder("gen_fp_f2i")
    A = b.input_word(64)
    ca = _Cls(b, A)
    zero = b.const(0)

    # |value| = K * 2^(s-63) with K = sig << 11 (64 bits, top bit set for
    # normals), s = e - 1023 (12-bit signed).  Integer part = K >> t with
    # t = 63 - s; keep guard/round in a 2-bit LSB extension and collect
    # sticky from the barrel shifter.
    s = b.sub_word(_zext(b, ca.exp, 12), _const_word(b, 1023, 12))[0]
    t = b.sub_word(_const_word(b, 63, 12), s)[0]  # 63 - s
    t_neg = t[11]  # s > 63: no shift (q's top bit set -> saturate)
    t_big = _or_tree(b, t[7:11])  # t >= 128: shift everything out
    amt = [b.AND(b.NOT(t_neg), b.OR(t[k], t_big)) for k in range(7)]
    K = [zero] * 11 + list(ca.sig)  # 64 bits
    V = [zero, zero] + K  # 66 bits: two guard positions below the integer
    Vs, sticky = _bsr_sticky(b, V, amt)
    guard, rnd, q = Vs[1], Vs[0], Vs[2:]
    round_up = b.AND(guard, b.OR(rnd, b.OR(sticky, q[0])))
    q, carry = _inc_word(b, q, round_up)

    nz_low = _or_tree(b, q[:63])
    pos_ovf = b.OR(carry, q[63])  # q > INT64_MAX
    neg_ovf = b.OR(carry, b.AND(q[63], nz_low))  # q > 2^63 (MIN magnitude)
    res = b.mux_word(ca.sign, q, b.neg_word(q))
    maxw = _const_word(b, (1 << 63) - 1, 64)
    minw = _const_word(b, 1 << 63, 64)
    res = b.mux_word(b.AND(b.NOT(ca.sign), pos_ovf), res, maxw)
    res = b.mux_word(b.AND(ca.sign, neg_ovf), res, minw)
    res = b.mux_word(ca.is_nan, res, maxw)
    b.output_word(res)
    return b.build()
