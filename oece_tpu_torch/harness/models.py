"""Pure-Python golden models for the harness circuits.

Parity role: the C++ golden models embedded in the reference's test harness
(ripple-carry adder test_adder.cpp:204-217, comparisons
test_comparator.cpp:235-269, 64-bit product test_multiplier.cpp:211-224,
parity test_parity.cpp:199-205) plus *computed* MD5/SHA-256/AES compression
functions — the reference hardcodes 4 vectors (test_md5.cpp:198-229,
test_sha256.cpp:201-243, test_aes.cpp:184-233); we additionally verify
against the sidecar vector files and arbitrary random blocks.

The port's own copy of ``oece_tpu.harness.models``, kept in step with it
(tests/test_torch_harness.py): the port imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

# ---------------------------------------------------------------------------
# bit helpers (utils parity: HexStr2UintVec src/utils.cpp:49-71 etc.)
# ---------------------------------------------------------------------------


def hex_to_bits_lsb(h: str) -> np.ndarray:
    """Hex string -> LSB-first bit vector (HexStr2UintVec parity):
    bytes in string order; within each byte, bit 0 first."""
    b = bytes.fromhex(h)
    out = np.zeros(len(b) * 8, dtype=np.int64)
    for i, byte in enumerate(b):
        for j in range(8):
            out[8 * i + j] = (byte >> j) & 1
    return out


def bits_lsb_to_hex(bits: np.ndarray) -> str:
    bits = np.asarray(bits).astype(np.int64)
    assert bits.size % 8 == 0
    by = bytearray()
    for i in range(bits.size // 8):
        v = 0
        for j in range(8):
            v |= int(bits[8 * i + j]) << j
        by.append(v)
    return by.hex()


def int_to_bits(v: int, n: int) -> np.ndarray:
    return np.array([(v >> i) & 1 for i in range(n)], dtype=np.int64)


def bits_to_int(bits) -> int:
    return sum(int(b) << i for i, b in enumerate(bits))


# ---------------------------------------------------------------------------
# MD5 compression (single 512-bit block, no padding)
# ---------------------------------------------------------------------------

_MD5_S = (
    [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4
)
_MD5_K = [int(abs(np.sin(i + 1)) * 2**32) & 0xFFFFFFFF for i in range(64)]
_MD5_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)


def md5_compress(block: bytes, iv=_MD5_IV) -> bytes:
    assert len(block) == 64
    M = struct.unpack("<16I", block)
    A, B, C, D = iv
    a, b, c, d = A, B, C, D
    for i in range(64):
        if i < 16:
            F = (b & c) | (~b & d)
            g = i
        elif i < 32:
            F = (d & b) | (~d & c)
            g = (5 * i + 1) % 16
        elif i < 48:
            F = b ^ c ^ d
            g = (3 * i + 5) % 16
        else:
            F = c ^ (b | ~d)
            g = (7 * i) % 16
        F = (F + a + _MD5_K[i] + M[g]) & 0xFFFFFFFF
        a, d, c = d, c, b
        rot = _MD5_S[i]
        b = (b + ((F << rot | F >> (32 - rot)) & 0xFFFFFFFF)) & 0xFFFFFFFF
    out = (
        (A + a) & 0xFFFFFFFF,
        (B + b) & 0xFFFFFFFF,
        (C + c) & 0xFFFFFFFF,
        (D + d) & 0xFFFFFFFF,
    )
    return struct.pack("<4I", *out)


# ---------------------------------------------------------------------------
# SHA-256 compression (single block, no padding)
# ---------------------------------------------------------------------------

_SHA_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
SHA256_IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def sha256_compress(block: bytes, iv=SHA256_IV) -> bytes:
    assert len(block) == 64
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & 0xFFFFFFFF)
    a, b, c, d, e, f, g, h = iv
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + _SHA_K[i] + w[i]) & 0xFFFFFFFF
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & 0xFFFFFFFF
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & 0xFFFFFFFF, c, b, a, (t1 + t2) & 0xFFFFFFFF
    out = [(x + y) & 0xFFFFFFFF for x, y in zip(iv, (a, b, c, d, e, f, g, h))]
    return struct.pack(">8I", *out)


# ---------------------------------------------------------------------------
# AES-128 (encrypt one block; also expanded-key form: 11 round keys)
# ---------------------------------------------------------------------------

_SBOX = None


def _aes_sbox():
    global _SBOX
    if _SBOX is not None:
        return _SBOX
    # generate algebraically: inverse in GF(2^8) + affine transform
    p = 0x11B
    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            v, a, b = 0, x, y
            # gf multiply
            r = 0
            aa, bb = a, b
            while bb:
                if bb & 1:
                    r ^= aa
                aa <<= 1
                if aa & 0x100:
                    aa ^= p
                bb >>= 1
            if r == 1:
                inv[x] = y
                break
    sbox = []
    for x in range(256):
        b = inv[x] if x else 0
        s = 0
        for i in range(8):
            bit = (
                (b >> i)
                ^ (b >> ((i + 4) % 8))
                ^ (b >> ((i + 5) % 8))
                ^ (b >> ((i + 6) % 8))
                ^ (b >> ((i + 7) % 8))
                ^ (0x63 >> i)
            ) & 1
            s |= bit << i
        sbox.append(s)
    _SBOX = sbox
    return sbox


def _gf_mul(a, b):
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


def aes_expand_key(key: bytes) -> List[bytes]:
    """FIPS-197 key schedule for Nk in {4, 6, 8} (AES-128/192/256):
    4*(Nr+1) words -> Nr+1 16-byte round keys."""
    sbox = _aes_sbox()
    nk = len(key) // 4
    assert nk in (4, 6, 8), f"bad AES key length {len(key)}"
    nr = nk + 6
    w = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
    rcon = 1
    for i in range(nk, 4 * (nr + 1)):
        t = list(w[i - 1])
        if i % nk == 0:
            t = t[1:] + t[:1]
            t = [sbox[x] for x in t]
            t[0] ^= rcon
            rcon = _gf_mul(rcon, 2)
        elif nk > 6 and i % nk == 4:
            t = [sbox[x] for x in t]
        w.append([a ^ b for a, b in zip(w[i - nk], t)])
    return [bytes(sum(w[4 * r : 4 * r + 4], [])) for r in range(nr + 1)]


def aes128_expand_key(key: bytes) -> List[bytes]:
    return aes_expand_key(key)


def aes128_encrypt_with_round_keys(pt: bytes, rks: List[bytes]) -> bytes:
    sbox = _aes_sbox()
    s = list(pt)  # FIPS layout: byte i fills state column-major (r + 4c = i)

    def add_rk(state, rk):
        return [a ^ b for a, b in zip(state, rk)]

    def sub(state):
        return [sbox[x] for x in state]

    def shift_rows(state):
        # state is byte-index i = r + 4c (FIPS layout: input bytes fill columns)
        out = [0] * 16
        for r in range(4):
            for c in range(4):
                out[r + 4 * c] = state[r + 4 * ((c + r) % 4)]
        return out

    def mix(state):
        out = [0] * 16
        for c in range(4):
            col = state[4 * c : 4 * c + 4]
            out[4 * c + 0] = _gf_mul(col[0], 2) ^ _gf_mul(col[1], 3) ^ col[2] ^ col[3]
            out[4 * c + 1] = col[0] ^ _gf_mul(col[1], 2) ^ _gf_mul(col[2], 3) ^ col[3]
            out[4 * c + 2] = col[0] ^ col[1] ^ _gf_mul(col[2], 2) ^ _gf_mul(col[3], 3)
            out[4 * c + 3] = _gf_mul(col[0], 3) ^ col[1] ^ col[2] ^ _gf_mul(col[3], 2)
        return out

    nr = len(rks) - 1
    s = add_rk(s, rks[0])
    for rnd in range(1, nr):
        s = mix(shift_rows(sub(s)))
        s = add_rk(s, rks[rnd])
    s = shift_rows(sub(s))
    s = add_rk(s, rks[nr])
    return bytes(s)


def aes128_encrypt(pt: bytes, key: bytes) -> bytes:
    return aes128_encrypt_with_round_keys(pt, aes128_expand_key(key))


def aes_encrypt(pt: bytes, key: bytes) -> bytes:
    """AES-128/192/256 by key length (FIPS-197-checked, tests/test_golden)."""
    return aes128_encrypt_with_round_keys(pt, aes_expand_key(key))


# ---------------------------------------------------------------------------
# Integer division golden models (new-Bristol arith suite, circuits/gen.py
# gen_udivide / gen_divide; edge semantics documented there)
# ---------------------------------------------------------------------------


def udiv(a: int, b: int, width: int = 64) -> int:
    """Unsigned quotient as the reference's udivide64.txt computes it
    (empirically pinned, tools/probe_conventions.py): a NON-RESTORING
    divider on ``width``-bit two's-complement registers — quotient bit =
    NOT sign(partial remainder).  Equals true ``a // b`` whenever
    b in [1, 2^(width-1)); division by zero yields the prefix-sign pattern
    (all-ones when a < 2^(width-1)).  For b >= 2^(width-1) the reference
    circuit's output is a synthesis artifact we do not model — the TB
    keeps its random divisors below that bound."""
    mask = (1 << width) - 1
    top = 1 << (width - 1)
    a, b = a & mask, b & mask
    r = 0
    q = 0
    for i in range(width - 1, -1, -1):
        bit = (a >> i) & 1
        if r & top:
            r = (((r << 1) | bit) + b) & mask
        else:
            r = (((r << 1) | bit) - b) & mask
        q |= (0 if (r & top) else 1) << i
    return q


def sdiv(a: int, b: int, width: int = 64) -> int:
    """Signed quotient truncated toward zero: |a| / |b| through the same
    non-restoring core with sign fix — matches the reference's divide64.txt
    on ALL inputs (probed incl. /0 and INT_MIN edge cases): /0 gives -1 for
    a >= 0 and +1 for a < 0; INT_MIN / -1 wraps to INT_MIN."""
    mask = (1 << width) - 1
    sa = (a >> (width - 1)) & 1
    sb = (b >> (width - 1)) & 1
    aa = ((-a) if sa else a) & mask
    ab = ((-b) if sb else b) & mask
    q = udiv(aa, ab, width)
    return ((-q) if sa ^ sb else q) & mask


# ---------------------------------------------------------------------------
# SHA-1 compression (reference corpus old_bristol_ckts/crypto/sha-1.txt; the
# reference's sha-1-test.txt is a saved 404 page with no usable vectors —
# test_sha256.cpp:60 — so vectors here come from this hashlib-checked model)
# ---------------------------------------------------------------------------

SHA1_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)


def _rotl32(x, n):
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def sha1_compress(block: bytes, iv=SHA1_IV) -> bytes:
    assert len(block) == 64
    w = [int.from_bytes(block[4 * i : 4 * i + 4], "big") for i in range(16)]
    for i in range(16, 80):
        w.append(_rotl32(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1))
    a, b, c, d, e = iv
    for i in range(80):
        if i < 20:
            f, k = (b & c) | (~b & d), 0x5A827999
        elif i < 40:
            f, k = b ^ c ^ d, 0x6ED9EBA1
        elif i < 60:
            f, k = (b & c) | (b & d) | (c & d), 0x8F1BBCDC
        else:
            f, k = b ^ c ^ d, 0xCA62C1D6
        t = (_rotl32(a, 5) + f + e + k + w[i]) & 0xFFFFFFFF
        e, d, c, b, a = d, c, _rotl32(b, 30), a, t
    out = [(x + y) & 0xFFFFFFFF for x, y in zip(iv, (a, b, c, d, e))]
    return b"".join(int.to_bytes(x, 4, "big") for x in out)


# ---------------------------------------------------------------------------
# DES golden model (reference corpus old_bristol_ckts/crypto/
# DES-{expanded,non-expanded}.txt, SURVEY.md §2.9 — data-only there, no TB).
# Bit numbering follows FIPS 46-3: bit 1 = MSB of the first byte.
# ---------------------------------------------------------------------------

_DES_IP = (
    58, 50, 42, 34, 26, 18, 10, 2, 60, 52, 44, 36, 28, 20, 12, 4,
    62, 54, 46, 38, 30, 22, 14, 6, 64, 56, 48, 40, 32, 24, 16, 8,
    57, 49, 41, 33, 25, 17, 9, 1, 59, 51, 43, 35, 27, 19, 11, 3,
    61, 53, 45, 37, 29, 21, 13, 5, 63, 55, 47, 39, 31, 23, 15, 7,
)
_DES_FP = (
    40, 8, 48, 16, 56, 24, 64, 32, 39, 7, 47, 15, 55, 23, 63, 31,
    38, 6, 46, 14, 54, 22, 62, 30, 37, 5, 45, 13, 53, 21, 61, 29,
    36, 4, 44, 12, 52, 20, 60, 28, 35, 3, 43, 11, 51, 19, 59, 27,
    34, 2, 42, 10, 50, 18, 58, 26, 33, 1, 41, 9, 49, 17, 57, 25,
)
_DES_E = (
    32, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9, 8, 9, 10, 11, 12, 13,
    12, 13, 14, 15, 16, 17, 16, 17, 18, 19, 20, 21, 20, 21, 22, 23, 24, 25,
    24, 25, 26, 27, 28, 29, 28, 29, 30, 31, 32, 1,
)
_DES_P = (
    16, 7, 20, 21, 29, 12, 28, 17, 1, 15, 23, 26, 5, 18, 31, 10,
    2, 8, 24, 14, 32, 27, 3, 9, 19, 13, 30, 6, 22, 11, 4, 25,
)
_DES_PC1 = (
    57, 49, 41, 33, 25, 17, 9, 1, 58, 50, 42, 34, 26, 18,
    10, 2, 59, 51, 43, 35, 27, 19, 11, 3, 60, 52, 44, 36,
    63, 55, 47, 39, 31, 23, 15, 7, 62, 54, 46, 38, 30, 22,
    14, 6, 61, 53, 45, 37, 29, 21, 13, 5, 28, 20, 12, 4,
)
_DES_PC2 = (
    14, 17, 11, 24, 1, 5, 3, 28, 15, 6, 21, 10,
    23, 19, 12, 4, 26, 8, 16, 7, 27, 20, 13, 2,
    41, 52, 31, 37, 47, 55, 30, 40, 51, 45, 33, 48,
    44, 49, 39, 56, 34, 53, 46, 42, 50, 36, 29, 32,
)
_DES_SHIFTS = (1, 1, 2, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2, 2, 1)
_DES_SBOX = (
    (
        (14, 4, 13, 1, 2, 15, 11, 8, 3, 10, 6, 12, 5, 9, 0, 7),
        (0, 15, 7, 4, 14, 2, 13, 1, 10, 6, 12, 11, 9, 5, 3, 8),
        (4, 1, 14, 8, 13, 6, 2, 11, 15, 12, 9, 7, 3, 10, 5, 0),
        (15, 12, 8, 2, 4, 9, 1, 7, 5, 11, 3, 14, 10, 0, 6, 13),
    ),
    (
        (15, 1, 8, 14, 6, 11, 3, 4, 9, 7, 2, 13, 12, 0, 5, 10),
        (3, 13, 4, 7, 15, 2, 8, 14, 12, 0, 1, 10, 6, 9, 11, 5),
        (0, 14, 7, 11, 10, 4, 13, 1, 5, 8, 12, 6, 9, 3, 2, 15),
        (13, 8, 10, 1, 3, 15, 4, 2, 11, 6, 7, 12, 0, 5, 14, 9),
    ),
    (
        (10, 0, 9, 14, 6, 3, 15, 5, 1, 13, 12, 7, 11, 4, 2, 8),
        (13, 7, 0, 9, 3, 4, 6, 10, 2, 8, 5, 14, 12, 11, 15, 1),
        (13, 6, 4, 9, 8, 15, 3, 0, 11, 1, 2, 12, 5, 10, 14, 7),
        (1, 10, 13, 0, 6, 9, 8, 7, 4, 15, 14, 3, 11, 5, 2, 12),
    ),
    (
        (7, 13, 14, 3, 0, 6, 9, 10, 1, 2, 8, 5, 11, 12, 4, 15),
        (13, 8, 11, 5, 6, 15, 0, 3, 4, 7, 2, 12, 1, 10, 14, 9),
        (10, 6, 9, 0, 12, 11, 7, 13, 15, 1, 3, 14, 5, 2, 8, 4),
        (3, 15, 0, 6, 10, 1, 13, 8, 9, 4, 5, 11, 12, 7, 2, 14),
    ),
    (
        (2, 12, 4, 1, 7, 10, 11, 6, 8, 5, 3, 15, 13, 0, 14, 9),
        (14, 11, 2, 12, 4, 7, 13, 1, 5, 0, 15, 10, 3, 9, 8, 6),
        (4, 2, 1, 11, 10, 13, 7, 8, 15, 9, 12, 5, 6, 3, 0, 14),
        (11, 8, 12, 7, 1, 14, 2, 13, 6, 15, 0, 9, 10, 4, 5, 3),
    ),
    (
        (12, 1, 10, 15, 9, 2, 6, 8, 0, 13, 3, 4, 14, 7, 5, 11),
        (10, 15, 4, 2, 7, 12, 9, 5, 6, 1, 13, 14, 0, 11, 3, 8),
        (9, 14, 15, 5, 2, 8, 12, 3, 7, 0, 4, 10, 1, 13, 11, 6),
        (4, 3, 2, 12, 9, 5, 15, 10, 11, 14, 1, 7, 6, 0, 8, 13),
    ),
    (
        (4, 11, 2, 14, 15, 0, 8, 13, 3, 12, 9, 7, 5, 10, 6, 1),
        (13, 0, 11, 7, 4, 9, 1, 10, 14, 3, 5, 12, 2, 15, 8, 6),
        (1, 4, 11, 13, 12, 3, 7, 14, 10, 15, 6, 8, 0, 5, 9, 2),
        (6, 11, 13, 8, 1, 4, 10, 7, 9, 5, 0, 15, 14, 2, 3, 12),
    ),
    (
        (13, 2, 8, 4, 6, 15, 11, 1, 10, 9, 3, 14, 5, 0, 12, 7),
        (1, 15, 13, 8, 10, 3, 7, 4, 12, 5, 6, 11, 0, 14, 9, 2),
        (7, 11, 4, 1, 9, 12, 14, 2, 0, 6, 10, 13, 15, 3, 5, 8),
        (2, 1, 14, 7, 4, 10, 8, 13, 15, 12, 9, 0, 3, 5, 6, 11),
    ),
)


def _bits_msb(data: bytes) -> list:
    return [(byte >> (7 - i)) & 1 for byte in data for i in range(8)]


def _bytes_msb(bits) -> bytes:
    out = bytearray()
    for i in range(0, len(bits), 8):
        b = 0
        for j in range(8):
            b = (b << 1) | bits[i + j]
        out.append(b)
    return bytes(out)


def _perm(bits, table):
    return [bits[i - 1] for i in table]


def des_expand_key(key: bytes) -> list:
    """FIPS 46-3 key schedule: 64-bit key (parity bits ignored) -> 16
    48-bit round keys, each returned as 6 bytes."""
    cd = _perm(_bits_msb(key), _DES_PC1)
    c, d = cd[:28], cd[28:]
    rks = []
    for s in _DES_SHIFTS:
        c = c[s:] + c[:s]
        d = d[s:] + d[:s]
        rks.append(_bytes_msb(_perm(c + d, _DES_PC2)))
    return rks


def _des_f_bits(r_bits, k_bits):
    x = [a ^ b for a, b in zip(_perm(r_bits, _DES_E), k_bits)]
    out = []
    for s in range(8):
        b6 = x[6 * s : 6 * s + 6]
        row = 2 * b6[0] + b6[5]
        col = 8 * b6[1] + 4 * b6[2] + 2 * b6[3] + b6[4]
        v = _DES_SBOX[s][row][col]
        out += [(v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1]
    return _perm(out, _DES_P)


def des_encrypt_with_round_keys(pt: bytes, rks: list) -> bytes:
    bits = _perm(_bits_msb(pt), _DES_IP)
    l, r = bits[:32], bits[32:]
    for rk in rks:
        k_bits = _bits_msb(rk)
        f = _des_f_bits(r, k_bits)
        l, r = r, [a ^ b for a, b in zip(l, f)]
    return _bytes_msb(_perm(r + l, _DES_FP))


def des_encrypt(pt: bytes, key: bytes) -> bytes:
    return des_encrypt_with_round_keys(pt, des_expand_key(key))


# ---------------------------------------------------------------------------
# IEEE-754 binary64 golden models (reference corpus new_bristol_ckts/fp/
# FP-{add,mul,eq,f2i}.txt, SURVEY.md §2.9 — data-only there, no TB, no
# vectors).  Exact integer-arithmetic spec, round-to-nearest-even, full
# subnormal/inf support.  Special-value conventions are pinned empirically
# against the reference circuits (tools/probe_conventions.py): NaN inputs
# propagate payload+sign with the quiet bit forced (second operand wins),
# invalid operations (inf-inf, 0*inf, 0/0, inf/inf, sqrt(-x)) produce
# 0x7FFFFFFFFFFFFFFF, and f2i is saturating round-to-nearest-even.
# ---------------------------------------------------------------------------

_F64_MASK = (1 << 64) - 1


def _f64_fields(x: int):
    return (x >> 63) & 1, (x >> 52) & 0x7FF, x & ((1 << 52) - 1)


def _f64_is_nan(x: int) -> bool:
    s, e, m = _f64_fields(x)
    return e == 0x7FF and m != 0


def _f64_is_inf(x: int) -> bool:
    s, e, m = _f64_fields(x)
    return e == 0x7FF and m == 0


def _f64_sig_exp(x: int):
    """(significand, exponent of its LSB): value = sig * 2^exp; sig < 2^53."""
    s, e, m = _f64_fields(x)
    if e == 0:
        return m, -1074
    return m | (1 << 52), e - 1075


def _round_pack(sign: int, num: int, d: int) -> int:
    """Round-to-nearest-even packing of the exact value (+/-) num * 2^-d,
    num > 0, into a binary64 pattern (handles subnormal/overflow)."""
    # biased exponent of the leading bit
    eb = (num.bit_length() - 1) - d + 1023
    if eb >= 1:
        # normal candidate: mantissa = round(num / 2^(lead-52))
        shift = num.bit_length() - 53
    else:
        # subnormal: fixed scale 2^-1074 => round(num * 2^(1074-d))
        shift = -(1074 - d)
    if shift <= 0:
        m = num << -shift
    else:
        q, r = num >> shift, num & ((1 << shift) - 1)
        half = 1 << (shift - 1)
        m = q + (1 if (r > half or (r == half and (q & 1))) else 0)
    if eb >= 1:
        if m == 1 << 53:  # rounding carried out
            m >>= 1
            eb += 1
        if eb >= 2047:
            return (sign << 63) | (0x7FF << 52)  # overflow -> inf
        return (sign << 63) | (eb << 52) | (m & ((1 << 52) - 1))
    # subnormal path: m < 2^52 stays subnormal; m == 2^52 promotes, and the
    # packed integer add handles that seamlessly
    return (sign << 63) | m


_FP_INVALID = 0x7FFFFFFFFFFFFFFF  # the reference circuits' invalid-op result
_FP_QUIET = 1 << 51


def _fp_prop_nan(a: int, b: int) -> int:
    """Reference-circuit NaN propagation (probed against FP-add/FP-mul.txt):
    the second operand wins when both are NaN; payload and sign are kept,
    the quiet bit is forced."""
    src = b if _f64_is_nan(b) else a
    return src | _FP_QUIET


def fp_add(a: int, b: int) -> int:
    """bit64 + bit64 -> bit64, IEEE-754 RNE with the reference FP-add.txt's
    special-value conventions (tools/probe_conventions.py): NaN inputs
    propagate via _fp_prop_nan; inf + (-inf) -> 0x7FFF...F."""
    if _f64_is_nan(a) or _f64_is_nan(b):
        return _fp_prop_nan(a, b)
    sa, ea, ma = _f64_fields(a)
    sb, eb, mb = _f64_fields(b)
    if _f64_is_inf(a) or _f64_is_inf(b):
        if _f64_is_inf(a) and _f64_is_inf(b) and sa != sb:
            return _FP_INVALID
        return a if _f64_is_inf(a) else b
    fa, xa = _f64_sig_exp(a)
    fb, xb = _f64_sig_exp(b)
    d = -min(xa, xb)
    num = (fa << (xa + d)) * (-1 if sa else 1) + (fb << (xb + d)) * (-1 if sb else 1)
    if num == 0:
        # exact cancellation -> +0, except (-0) + (-0) = -0
        return (1 << 63) if (sa and sb) else 0
    sign = 1 if num < 0 else 0
    return _round_pack(sign, abs(num), d)


def fp_mul(a: int, b: int) -> int:
    """bit64 * bit64 -> bit64, IEEE-754 RNE with the reference FP-mul.txt's
    special-value conventions: NaN propagation via _fp_prop_nan, 0 * inf ->
    0x7FFF...F."""
    if _f64_is_nan(a) or _f64_is_nan(b):
        return _fp_prop_nan(a, b)
    sa, ea, ma = _f64_fields(a)
    sb, eb, mb = _f64_fields(b)
    sign = sa ^ sb
    fa, xa = _f64_sig_exp(a)
    fb, xb = _f64_sig_exp(b)
    if _f64_is_inf(a) or _f64_is_inf(b):
        if (not _f64_is_inf(a) and fa == 0) or (not _f64_is_inf(b) and fb == 0):
            return _FP_INVALID  # inf * 0
        return (sign << 63) | (0x7FF << 52)
    num = fa * fb
    if num == 0:
        return sign << 63
    return _round_pack(sign, num, -(xa + xb))


def fp_eq(a: int, b: int) -> int:
    """IEEE equality: bit-equal or both zeros; NaN != anything.  Returns the
    64-bit word the FP-eq.txt interface carries (result in bit 0)."""
    if _f64_is_nan(a) or _f64_is_nan(b):
        return 0
    if (a & ~(1 << 63) & _F64_MASK) == 0 and (b & ~(1 << 63) & _F64_MASK) == 0:
        return 1  # +-0 == +-0
    return int(a == b)


_I64_MAX = (1 << 63) - 1
_I64_MIN = 1 << 63


def fp_f2i(a: int) -> int:
    """double -> int64 as the reference FP-f2i.txt computes it (empirically
    pinned): round-to-nearest-even, saturating — NaN (any sign) and positive
    overflow/+inf -> INT64_MAX, negative overflow/-inf -> INT64_MIN."""
    if _f64_is_nan(a):
        return _I64_MAX
    sa, ea, ma = _f64_fields(a)
    if _f64_is_inf(a):
        return _I64_MIN if sa else _I64_MAX
    f, x = _f64_sig_exp(a)  # |value| = f * 2^x exactly
    if x >= 0:
        v = f << x
    else:
        sh = -x
        q, r = f >> sh, f & ((1 << sh) - 1)
        half = 1 << (sh - 1)
        v = q + (1 if (r > half or (r == half and (q & 1))) else 0)
    if not sa:
        return _I64_MAX if v > _I64_MAX else v
    return _I64_MIN if v >= _I64_MIN else (-v) & _F64_MASK


def fp_div(a: int, b: int) -> int:
    """bit64 / bit64 -> bit64, IEEE-754 RNE (FP-div.txt is a missing blob in
    the reference; provided here with the family's special-value
    conventions: NaN propagation via _fp_prop_nan, 0/0 and inf/inf ->
    0x7FFF...F)."""
    if _f64_is_nan(a) or _f64_is_nan(b):
        return _fp_prop_nan(a, b)
    sa, ea, ma = _f64_fields(a)
    sb, eb, mb = _f64_fields(b)
    sign = sa ^ sb
    ia, ib = _f64_is_inf(a), _f64_is_inf(b)
    fa, xa = _f64_sig_exp(a)
    fb, xb = _f64_sig_exp(b)
    if ia or ib:
        if ia and ib:
            return _FP_INVALID
        return (sign << 63) | ((0x7FF << 52) if ia else 0)
    if fb == 0:
        return _FP_INVALID if fa == 0 else (sign << 63) | (0x7FF << 52)  # 0/0 | x/0
    if fa == 0:
        return sign << 63
    # exact quotient as fraction: fa*2^xa / (fb*2^xb); scale numerator so the
    # integer quotient has >= 56 bits, then fold the remainder into sticky
    k = 120
    q, r = divmod(fa << k, fb)
    num = (q << 1) | (1 if r else 0)
    return _round_pack(sign, num, -(xa - xb - k - 1))


def fp_sqrt(a: int) -> int:
    """sqrt(bit64) -> bit64, IEEE-754 RNE (FP-sqrt.txt is a missing blob in
    the reference; provided here with the family's special-value
    conventions).  sqrt(-x) = 0x7FFF...F (invalid), sqrt(-0) = -0."""
    if _f64_is_nan(a):
        return _fp_prop_nan(a, a)
    sa, ea, ma = _f64_fields(a)
    fa, xa = _f64_sig_exp(a)
    if fa == 0:
        return sa << 63  # +-0
    if sa:
        return _FP_INVALID
    if _f64_is_inf(a):
        return a
    # value = fa * 2^xa; make exponent even, take integer sqrt of
    # fa << (xa - e2) with enough precision, sticky from inexactness
    k = 120
    e2 = xa - k
    if e2 & 1:
        e2 -= 1
    m = fa << (xa - e2)
    import math

    s = math.isqrt(m)
    num = (s << 1) | (1 if s * s != m else 0)
    # value = s * 2^(e2/2) = num * 2^(e2/2 - 1)
    return _round_pack(0, num, 1 - e2 // 2)


# ---------------------------------------------------------------------------
# Keccak-f[1600] and SHA-512 (referenced by the corpus CMakeLists but
# missing large blobs upstream — examples/new_bristol_ckts/crypto/
# {Keccak_f,sha512}.txt, SURVEY.md §2.9; generated here).
# ---------------------------------------------------------------------------

_KECCAK_RC = []


def _keccak_rcs():
    global _KECCAK_RC
    if _KECCAK_RC:
        return _KECCAK_RC
    # LFSR-generated round constants (FIPS 202 §3.2.5)
    r = 1
    rcs = []
    for _ in range(24):
        rc = 0
        for j in range(7):
            if r & 1:
                rc |= 1 << ((1 << j) - 1)
            r = ((r << 1) ^ (0x71 if r & 0x80 else 0)) & 0xFF
        rcs.append(rc)
    _KECCAK_RC = rcs
    return rcs


_KECCAK_ROT = [[0] * 5 for _ in range(5)]


def _keccak_rots():
    # rho offsets (FIPS 202 §3.2.2)
    x, y = 1, 0
    for t in range(24):
        _KECCAK_ROT[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return _KECCAK_ROT


def keccak_f(state: bytes) -> bytes:
    """Keccak-f[1600] permutation on the 200-byte state (lanes little-
    endian: lane (x, y) at bytes 8*(x + 5y))."""
    assert len(state) == 200
    rot = _keccak_rots()
    A = [[int.from_bytes(state[8 * (x + 5 * y) : 8 * (x + 5 * y) + 8], "little")
          for y in range(5)] for x in range(5)]
    m = (1 << 64) - 1

    def rotl(v, n):
        n %= 64
        return ((v << n) | (v >> (64 - n))) & m

    for rc in _keccak_rcs():
        # theta
        C = [A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4] for x in range(5)]
        D = [C[(x - 1) % 5] ^ rotl(C[(x + 1) % 5], 1) for x in range(5)]
        A = [[A[x][y] ^ D[x] for y in range(5)] for x in range(5)]
        # rho + pi
        B = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                B[y][(2 * x + 3 * y) % 5] = rotl(A[x][y], rot[x][y])
        # chi
        A = [[B[x][y] ^ ((~B[(x + 1) % 5][y] & m) & B[(x + 2) % 5][y])
              for y in range(5)] for x in range(5)]
        # iota
        A[0][0] ^= rc
    out = bytearray(200)
    for x in range(5):
        for y in range(5):
            out[8 * (x + 5 * y) : 8 * (x + 5 * y) + 8] = A[x][y].to_bytes(8, "little")
    return bytes(out)


_SHA512_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)
SHA512_IV = _SHA512_IV

_SHA512_K = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]


def _rotr64(x, n):
    return ((x >> n) | (x << (64 - n))) & ((1 << 64) - 1)


def sha512_compress(block: bytes, iv=_SHA512_IV) -> bytes:
    assert len(block) == 128
    m = (1 << 64) - 1
    w = [int.from_bytes(block[8 * i : 8 * i + 8], "big") for i in range(16)]
    for i in range(16, 80):
        s0 = _rotr64(w[i - 15], 1) ^ _rotr64(w[i - 15], 8) ^ (w[i - 15] >> 7)
        s1 = _rotr64(w[i - 2], 19) ^ _rotr64(w[i - 2], 61) ^ (w[i - 2] >> 6)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & m)
    a, b, c, d, e, f, g, h = iv
    for i in range(80):
        S1 = _rotr64(e, 14) ^ _rotr64(e, 18) ^ _rotr64(e, 41)
        ch = (e & f) ^ (~e & g & m)
        t1 = (h + S1 + ch + _SHA512_K[i] + w[i]) & m
        S0 = _rotr64(a, 28) ^ _rotr64(a, 34) ^ _rotr64(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & m
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & m, c, b, a, (t1 + t2) & m
    out = [(x + y) & m for x, y in zip(iv, (a, b, c, d, e, f, g, h))]
    return b"".join(int.to_bytes(x, 8, "big") for x in out)
