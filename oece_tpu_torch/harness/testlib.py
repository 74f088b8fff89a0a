"""Test harness: golden-model differential tests per circuit family.

Parity with the reference's ``oecetestlib`` (SURVEY.md §2.5): each
``test_X(fname, num_loops, set, method)`` builds inputs, computes expected
outputs with a golden model, runs the circuit in PLAINTEXT mode and compares,
then (optionally) in ENCRYPTED mode with per-level verify and compares —
the exact two-tier flow of e.g. src/test_sha256.cpp:284-341.

Batching: the reference loops test cases serially; here all ``num_loops``
cases evaluate as ONE batch (the batch dimension is the bootstrap GEMMs'
gate axis), so more test loops make the hardware *more* efficient.

The port's counterpart of ``oece_tpu.harness.testlib`` on the port's
``Circuit``: ``run_harness`` and every family test take an explicit
``device`` ("cuda" by default, as every entry point of the port), and
otherwise give the JAX package's results (tests/test_torch_testlib.py).

Bit-order conventions (established empirically against the known-answer
vectors; see tests/test_harness.py):
  * adders/comparators/multipliers: LSB-first integers per input word.
  * md5 / AES (old Bristol): plain MSB-first bitstring of the byte string
    ("convention D"; the reference's reversal at test_md5.cpp:250-254).
  * sha256 (new Bristol): whole value as a big-endian integer, bits
    LSB-first ("convention C"), message and chaining input alike.
  * comparators: output = (in1 cmp in2), signed variants on int32.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np

from ..circuits.bristol import parse_bristol
from ..circuits.asm import parse_asm
from ..runtime.evaluator import Circuit
from . import models

def _default_circuits_dir() -> str:
    """Priority: $OECE_CIRCUITS, then the generated in-repo corpus
    (examples/, written by tools/gen_corpus.py)."""
    env = os.environ.get("OECE_CIRCUITS")
    if env:
        return env
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "examples",
    )


DEFAULT_CIRCUITS_DIR = _default_circuits_dir()


# ---------------------------------------------------------------------------


def bits_lsb(v: np.ndarray, n: int) -> np.ndarray:
    v = np.atleast_1d(np.asarray(v, dtype=np.uint64))
    return ((v[:, None] >> np.arange(n, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)


def unbits_lsb(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b).astype(np.uint64)
    return (b << np.arange(b.shape[1], dtype=np.uint64)).sum(1)


def bits_c(x: bytes) -> np.ndarray:
    """Whole big-endian value as an integer, bits LSB-first == byte string
    reversed with LSB-first bits per byte (sha256 new-Bristol convention)."""
    return models.hex_to_bits_lsb(x[::-1].hex())


def bits_c_inv(bits: np.ndarray) -> bytes:
    return bytes.fromhex(models.bits_lsb_to_hex(np.asarray(bits)))[::-1]


def bits_d(x: bytes) -> np.ndarray:
    """Plain MSB-first bitstring (md5/AES convention)."""
    a = models.hex_to_bits_lsb(x.hex())
    return np.concatenate([a[8 * i : 8 * i + 8][::-1] for i in range(len(a) // 8)])


def bits_d_inv(bits: np.ndarray) -> bytes:
    bits = np.asarray(bits)
    a = np.concatenate([bits[8 * i : 8 * i + 8][::-1] for i in range(len(bits) // 8)])
    return bytes.fromhex(models.bits_lsb_to_hex(a))


@dataclasses.dataclass
class HarnessResult:
    name: str
    n_cases: int
    plain_passed: int
    enc_passed: int
    enc_run: bool
    bad_gates_fixed: int
    seconds: float

    @property
    def passed(self) -> bool:
        return self.plain_passed == self.n_cases and (
            not self.enc_run or self.enc_passed == self.n_cases
        )

    def summary(self) -> str:
        s = (
            f"{self.name}: plaintext {self.plain_passed}/{self.n_cases} passed"
        )
        if self.enc_run:
            s += f", encrypted {self.enc_passed}/{self.n_cases} passed"
            if self.bad_gates_fixed:
                s += f" ({self.bad_gates_fixed} bad gates fixed)"
        return s + f" [{self.seconds:.1f}s]"


def _load(fname: str) -> "Netlist":
    if fname.endswith(".out"):
        return parse_asm(fname)
    return parse_bristol(fname)


def run_harness(
    name: str,
    fname: str,
    in_words: List[np.ndarray],
    expected_words: List[np.ndarray],
    set: str = "STD128_OPT",
    method: str = "GINX",
    encrypted: bool = True,
    verify: bool = True,
    recover: bool = False,
    seed: int = 0,
    circuit: Optional[Circuit] = None,
    verbose: bool = False,
    netlist=None,
    device: str = "cuda",
) -> HarnessResult:
    """Two-tier differential run (plaintext then encrypted+verify) on
    ``circuit``, or on a new Circuit on ``device``; nothing here keeps the
    Circuit, so its keys are freed when the run ends."""
    t0 = time.time()
    c = circuit or Circuit(
        set=set, method=method, seed=seed, generate_keys=encrypted, device=device
    )
    if netlist is not None:
        c.LoadNetlist(netlist)
    else:
        c.ReadFile(fname)
    T = in_words[0].shape[0]

    def compare(outs) -> int:
        ok = np.ones(T, dtype=bool)
        for got, want in zip(outs, expected_words):
            ok &= np.all(np.asarray(got) == want, axis=1)
        return int(ok.sum())

    # plaintext pass
    c.Reset()
    c.setVerify(False)
    c.setPlaintext(True)
    c.setEncrypted(False)
    c.SetInput(in_words)
    c.Clock(verbose=verbose)
    plain_passed = compare(c.GetOutput())

    enc_passed = 0
    bad = 0
    if encrypted:
        c.Reset()
        c.setPlaintext(not verify)
        c.setEncrypted(True)
        c.setVerify(verify)
        if recover and not verify:
            # pure-encrypted-mode margin recovery (evaluator.setRecovery):
            # no plaintext model consulted during the encrypted pass
            c.setRecovery(True)
        c.SetInput(in_words)
        c.Clock(verbose=verbose)
        enc_passed = compare(c.GetOutput())
        bad = sum(c.bad_gate_counts.values())
        if recover and not verify:
            bad += sum(
                v for k, v in c.recover_counts.items() if k != "HARD"
            )
    return HarnessResult(
        name=name,
        n_cases=T,
        plain_passed=plain_passed,
        enc_passed=enc_passed,
        enc_run=encrypted,
        bad_gates_fixed=bad,
        seconds=time.time() - t0,
    )


# ---------------------------------------------------------------------------
# Per-family harnesses (reference: test_{adder,...}.cpp)
# ---------------------------------------------------------------------------


def test_adder(fname: str, num_loops: int = 4, width: Optional[int] = None, **kw) -> HarnessResult:
    """Random ripple-carry addition (test_adder.cpp:180-217 semantics)."""
    nl = _load(fname)
    w1, w2 = nl.input_bits[0], nl.input_bits[1]
    wo = nl.output_bits[0]
    rng = np.random.default_rng(kw.pop("data_seed", 1234))
    a = rng.integers(0, 1 << min(w1, 63), num_loops, dtype=np.uint64)
    b = rng.integers(0, 1 << min(w2, 63), num_loops, dtype=np.uint64)
    total = (a + b) & (np.uint64(2**wo - 1) if wo < 64 else np.uint64(0xFFFFFFFFFFFFFFFF))
    return run_harness(
        f"adder[{os.path.basename(fname)}]",
        fname,
        [bits_lsb(a, w1), bits_lsb(b, w2)],
        [bits_lsb(total, wo)],
        **kw,
    )


def test_comparator(fname: str, num_loops: int = 4, **kw) -> HarnessResult:
    """Comparisons; first case forces equality (test_comparator.cpp:196-201);
    signed/lteq selected by filename substring (test_comparator.cpp:228-269)."""
    nl = _load(fname)
    w = nl.input_bits[0]
    rng = np.random.default_rng(kw.pop("data_seed", 99))
    a = rng.integers(0, 1 << w, num_loops, dtype=np.uint64)
    b = rng.integers(0, 1 << w, num_loops, dtype=np.uint64)
    b[0] = a[0]  # forced equality case
    signed = "signed" in fname and "unsigned" not in fname
    lteq = "lteq" in fname
    if signed:
        sa = a.astype(np.int32 if w == 32 else np.int64).astype(np.int64)
        sb = b.astype(np.int32 if w == 32 else np.int64).astype(np.int64)
    else:
        sa, sb = a.astype(np.int64), b.astype(np.int64)
    res = (sa <= sb) if lteq else (sa < sb)
    return run_harness(
        f"comparator[{os.path.basename(fname)}]",
        fname,
        [bits_lsb(a, w), bits_lsb(b, w)],
        [res.astype(np.int64)[:, None]],
        **kw,
    )


def test_multiplier(fname: str, num_loops: int = 4, **kw) -> HarnessResult:
    """w x w -> 2w product (test_multiplier.cpp:211-224 semantics)."""
    nl = _load(fname)
    w = nl.input_bits[0]
    wo = nl.output_bits[0]
    rng = np.random.default_rng(kw.pop("data_seed", 7))
    a = rng.integers(0, 1 << w, num_loops, dtype=np.uint64)
    b = rng.integers(0, 1 << w, num_loops, dtype=np.uint64)
    if wo <= 64:
        prod = (a * b) & np.uint64((1 << wo) - 1 if wo < 64 else 0xFFFFFFFFFFFFFFFF)
        expected = bits_lsb(prod, wo)
    else:
        expected = np.stack(
            [models.int_to_bits(int(x) * int(y), wo) for x, y in zip(a, b)]
        )
    return run_harness(
        f"multiplier[{os.path.basename(fname)}]",
        fname,
        [bits_lsb(a, w), bits_lsb(b, w)],
        [expected],
        **kw,
    )


def test_parity(fname: str, num_loops: int = 4, **kw) -> HarnessResult:
    """Two-phase generate->check flow (test_parity.cpp:176-369): phase 1
    computes the parity of a random 8-bit value with 9th input 0; phase 2
    feeds the generated parity bit back as the 9th input and checks the
    odd-parity detector output."""
    nl = _load(fname)
    rng = np.random.default_rng(kw.pop("data_seed", 5))
    v = rng.integers(0, 256, num_loops, dtype=np.uint64)
    par = np.array([bin(int(x)).count("1") & 1 for x in v], dtype=np.int64)
    inp1 = np.concatenate([bits_lsb(v, 8), np.zeros((num_loops, 1), np.int64)], axis=1)
    # Out0 = even indicator (1-par), Out1 = odd indicator (par)
    r1 = run_harness(
        f"parity-gen[{os.path.basename(fname)}]",
        fname,
        [inp1],
        [np.stack([1 - par, par], axis=1)],
        **kw,
    )
    # phase 2: 9th bit = generated odd-parity bit -> total parity now even:
    # odd indicator must be 0, even indicator 1
    inp2 = np.concatenate([bits_lsb(v, 8), par[:, None]], axis=1)
    r2 = run_harness(
        f"parity-check[{os.path.basename(fname)}]",
        fname,
        [inp2],
        [np.stack([np.ones_like(par), np.zeros_like(par)], axis=1)],
        **kw,
    )
    return HarnessResult(
        name=f"parity[{os.path.basename(fname)}]",
        n_cases=r1.n_cases + r2.n_cases,
        plain_passed=r1.plain_passed + r2.plain_passed,
        enc_passed=r1.enc_passed + r2.enc_passed,
        enc_run=r1.enc_run,
        bad_gates_fixed=r1.bad_gates_fixed + r2.bad_gates_fixed,
        seconds=r1.seconds + r2.seconds,
    )


_ARITH64_MODELS = {
    # basename fragment -> (n_inputs, golden(a, b, width) -> int result)
    "adder64": (2, lambda a, b, w: a + b),
    "sub64": (2, lambda a, b, w: a - b),
    "neg64": (1, lambda a, b, w: -a),
    "zero_equal": (1, lambda a, b, w: int(a == 0)),
    "mult64": (2, lambda a, b, w: a * b),
    "mult2_64": (2, lambda a, b, w: a * b),
    "udivide64": (2, lambda a, b, w: models.udiv(a, b, w)),
    "divide64": (2, lambda a, b, w: models.sdiv(a, b, w)),
}


def test_arith64(fname: str, num_loops: int = 4, **kw) -> HarnessResult:
    """Generic golden-model harness for the new-Bristol arith suite
    (adder64/sub64/neg64/zero_equal/mult64/mult2_64/udivide64/divide64;
    SURVEY.md §2.9), dispatched by filename.  No reference TB covers these —
    the reference ships them as data only.  Interface conventions pinned
    against the reference files (tools/probe_conventions.py): mult2_64
    declares TWO 64-bit output words in (high, low) order; udivide64 is a
    non-restoring divider whose output is well-defined for divisors below
    2^63 (random divisors are drawn from that domain; /0 is pinned)."""
    base = os.path.basename(fname)
    key = next((k for k in _ARITH64_MODELS if k in base), None)
    if key is None:
        raise ValueError(f"unknown arith64 circuit {base}")
    n_in, golden = _ARITH64_MODELS[key]
    nl = _load(fname)
    w = nl.input_bits[0]
    wo = nl.output_bits[0]
    rng = np.random.default_rng(kw.pop("data_seed", 17))
    a = rng.integers(0, 1 << 64, num_loops, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, num_loops, dtype=np.uint64)
    if key == "udivide64":
        b &= np.uint64((1 << 63) - 1)  # see docstring: divisor domain
    if "divide" in key and num_loops >= 2:
        b[1] = 0  # pin a division-by-zero case
    mask = (1 << 64) - 1
    if key == "zero_equal" and num_loops >= 2:
        a[1] = 0  # pin the equal-zero case
    exp_int = [golden(int(x) & mask, int(y) & mask, w) for x, y in zip(a, b)]
    if key == "mult2_64" and len(nl.output_bits) == 2:
        expected_words = [
            np.stack([models.int_to_bits((v >> 64) & mask, 64) for v in exp_int]),
            np.stack([models.int_to_bits(v & mask, 64) for v in exp_int]),
        ]
    else:
        expected_words = [
            np.stack([models.int_to_bits(v & ((1 << wo) - 1), wo) for v in exp_int])
        ]
    in_words = [bits_lsb(a, w)] + ([bits_lsb(b, w)] if n_in == 2 else [])
    return run_harness(f"arith64[{base}]", fname, in_words, expected_words, **kw)


def _read_kat(path: str) -> List[tuple]:
    """Parse md5-test.txt / sha-256-test.txt sidecar vectors."""
    pairs, cur = [], None
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if ln.startswith("in="):
                cur = ln[3:]
            elif ln.startswith("out=") and cur is not None:
                pairs.append((bytes.fromhex(cur), bytes.fromhex(ln[4:])))
                cur = None
    return pairs


def test_md5(fname: str, num_loops: int = 4, **kw) -> HarnessResult:
    """MD5 compression KATs (sidecar md5-test.txt when present,
    test_md5.cpp:198-229) plus random blocks, all verified against the
    computed golden model."""
    kat_path = os.path.join(os.path.dirname(fname), "md5-test.txt")
    blocks = [b for b, _ in _read_kat(kat_path)] if os.path.exists(kat_path) else []
    rng = np.random.default_rng(kw.pop("data_seed", 3))
    while len(blocks) < num_loops:
        blocks.append(rng.bytes(64))
    blocks = blocks[:num_loops]
    inp = np.stack([bits_d(b) for b in blocks])
    exp = np.stack([bits_d(models.md5_compress(b)) for b in blocks])
    return run_harness(f"md5[{os.path.basename(fname)}]", fname, [inp], [exp], **kw)


_FP_MODELS = {
    "FP-add": (2, lambda a, b: models.fp_add(a, b)),
    "FP-mul": (2, lambda a, b: models.fp_mul(a, b)),
    "FP-div": (2, lambda a, b: models.fp_div(a, b)),
    "FP-sqrt": (1, lambda a, b: models.fp_sqrt(a)),
    "FP-eq": (2, lambda a, b: models.fp_eq(a, b)),
    "FP-f2i": (1, lambda a, b: models.fp_f2i(a)),
}


def _fp_operands(num_loops: int, seed: int) -> np.ndarray:
    """Deterministic binary64 operand mix: IEEE specials first, then random
    bit patterns (dense NaN/inf/subnormal coverage), then random normals."""
    import struct

    def f2b(f):
        return struct.unpack("<Q", struct.pack("<d", f))[0]

    specials = [0.0, -0.0, 1.0, -1.0, float("inf"), -float("inf"), float("nan"),
                5e-324, 1e-310, 1.7976931348623157e308, 0.5, -2.5]
    vals = [f2b(v) for v in specials]
    rng = np.random.default_rng(seed)
    need = max(0, 2 * num_loops - len(vals))
    vals += [int(x) for x in rng.integers(0, 1 << 64, need // 2 + 1, dtype=np.uint64)]
    vals += [f2b(float(x)) for x in rng.normal(0, 1e3, need // 2 + 1)]
    return np.array(vals[: 2 * num_loops], dtype=np.uint64)


_FP_GENS = {
    "FP-add": "gen_fp_add",
    "FP-mul": "gen_fp_mul",
    "FP-div": "gen_fp_div",
    "FP-sqrt": "gen_fp_sqrt",
    "FP-eq": "gen_fp_eq",
    "FP-f2i": "gen_fp_f2i",
}


def test_fp(fname: str, num_loops: int = 4, **kw) -> HarnessResult:
    """IEEE-754 binary64 family (new_bristol_ckts/fp/FP-*.txt; data-only in
    the reference, with FP-div/FP-sqrt missing blobs — those two fall back
    to the circuits/fp.py generators, like sha512/keccak).  Operands include
    NaN/inf/subnormal cases."""
    base = os.path.basename(fname)
    key = next((k for k in _FP_MODELS if k in base), None)
    if key is None:
        raise ValueError(f"unknown FP circuit {base}")
    n_in, golden = _FP_MODELS[key]
    from ..circuits import fp as fp_mod

    nl = _load_or_gen(fname, getattr(fp_mod, _FP_GENS[key]))
    ops = _fp_operands(num_loops, kw.pop("data_seed", 21))
    a, b = ops[0::2][:num_loops], ops[1::2][:num_loops]
    if key == "FP-sqrt":
        a = np.abs(a.view(np.int64)).view(np.uint64)  # mostly non-negative
        a[0] = 0x4010000000000000  # sqrt(4) = 2
    mask = (1 << 64) - 1
    exp_int = [golden(int(x), int(y)) & mask for x, y in zip(a, b)]
    expected = np.stack([models.int_to_bits(v, 64) for v in exp_int])
    in_words = [bits_lsb(a, 64)] + ([bits_lsb(b, 64)] if n_in == 2 else [])
    return run_harness(f"fp[{base}]", fname, in_words, [expected], netlist=nl, **kw)


def test_aes_new(fname: str, num_loops: int = 2, **kw) -> HarnessResult:
    """New-Bristol AES trio (aes_{128,192,256}.txt: in1 = key, in2 = block;
    data-only in the reference).  Key size from the circuit header; first
    vector is the FIPS-197 example for that size.  All words use the
    whole-value little-endian convention (bits_c), pinned empirically
    against the reference files (tools/probe_conventions.py)."""
    nl = _load(fname)
    kbits = nl.input_bits[0]
    assert kbits in (128, 192, 256), f"unexpected AES key width {kbits}"
    rng = np.random.default_rng(kw.pop("data_seed", 15))
    pts = [bytes.fromhex("00112233445566778899aabbccddeeff")]
    keys = [bytes(range(kbits // 8))]
    while len(pts) < num_loops:
        pts.append(rng.bytes(16))
        keys.append(rng.bytes(kbits // 8))
    pts, keys = pts[:num_loops], keys[:num_loops]
    exp = np.stack([bits_c(models.aes_encrypt(p, k)) for p, k in zip(pts, keys)])
    inp_k = np.stack([bits_c(k) for k in keys])
    inp_pt = np.stack([bits_c(p) for p in pts])
    return run_harness(
        f"aes[{os.path.basename(fname)}]", fname, [inp_k, inp_pt], [exp], **kw
    )


def test_des(fname: str, num_loops: int = 2, **kw) -> HarnessResult:
    """DES: expanded (pt + 768-bit round keys) or non-expanded (pt + 64-bit
    key) selected by filename, against the FIPS-46-3-checked golden model
    (models.des_encrypt).  Circuit data-only in the reference; real TB here.
    First vector is the classic FIPS pair 0123456789ABCDEF/133457799BBCDFF1."""
    expanded = "non-expanded" not in fname and "expanded" in fname
    rng = np.random.default_rng(kw.pop("data_seed", 14))
    pts = [bytes.fromhex("0123456789ABCDEF")]
    keys = [bytes.fromhex("133457799BBCDFF1")]
    while len(pts) < num_loops:
        pts.append(rng.bytes(8))
        keys.append(rng.bytes(8))
    pts, keys = pts[:num_loops], keys[:num_loops]
    exp = np.stack([bits_d(models.des_encrypt(p, k)) for p, k in zip(pts, keys)])
    inp_pt = np.stack([bits_d(p) for p in pts])
    if expanded:
        inp_k = np.stack([bits_d(b"".join(models.des_expand_key(k))) for k in keys])
    else:
        inp_k = np.stack([bits_d(k) for k in keys])
    return run_harness(
        f"des[{os.path.basename(fname)}]", fname, [inp_pt, inp_k], [exp], **kw
    )


def test_sha1(fname: str, num_loops: int = 4, **kw) -> HarnessResult:
    """SHA-1 compression (old-Bristol sha-1.txt interface: 512 -> 160, fixed
    IV).  The reference ships the circuit but no usable vectors (its
    sha-1-test.txt is a saved 404 page, test_sha256.cpp:60); vectors here
    come from the hashlib-checked golden model, md5-style bits_d convention."""
    kat_path = os.path.join(os.path.dirname(fname), "sha-1-test.txt")
    blocks = [b for b, _ in _read_kat(kat_path)] if os.path.exists(kat_path) else []
    rng = np.random.default_rng(kw.pop("data_seed", 8))
    while len(blocks) < num_loops:
        blocks.append(rng.bytes(64))
    blocks = blocks[:num_loops]
    inp = np.stack([bits_d(b) for b in blocks])
    exp = np.stack([bits_d(models.sha1_compress(b)) for b in blocks])
    return run_harness(f"sha1[{os.path.basename(fname)}]", fname, [inp], [exp], **kw)


def _load_or_gen(fname: str, genf):
    """Parse the corpus file when present, else generate the netlist (the
    giant sha512/Keccak_f circuits are not checked in; tools/gen_corpus.py
    --big writes them)."""
    if os.path.exists(fname):
        return None  # run_harness parses the file
    return genf()


def test_sha512(fname: str, num_loops: int = 4, **kw) -> HarnessResult:
    """SHA-512 compression ((1024-bit block, 512-bit state) -> 512; the
    reference corpus lists sha512.txt but the blob is missing).  bits_c
    convention; golden model is hashlib-checked."""
    from ..circuits.gen import gen_sha512_compress

    nl = _load_or_gen(fname, gen_sha512_compress)
    rng = np.random.default_rng(kw.pop("data_seed", 19))
    blocks = [b"\x00" * 128] + [rng.bytes(128) for _ in range(num_loops - 1)]
    blocks = blocks[:num_loops]
    iv_bytes = b"".join(int.to_bytes(x, 8, "big") for x in models.SHA512_IV)
    inp_m = np.stack([bits_c(b) for b in blocks])
    inp_iv = np.stack([bits_c(iv_bytes)] * len(blocks))
    exp = np.stack([bits_c(models.sha512_compress(b)) for b in blocks])
    return run_harness(
        f"sha512[{os.path.basename(fname)}]", fname, [inp_m, inp_iv], [exp],
        netlist=nl, **kw
    )


def test_keccak(fname: str, num_loops: int = 4, **kw) -> HarnessResult:
    """Keccak-f[1600] permutation (Keccak_f.txt is a missing blob in the
    reference corpus).  State convention: bits_lsb of the 200-byte state;
    golden model is hashlib-SHA3-checked."""
    from ..circuits.gen import gen_keccak_f

    nl = _load_or_gen(fname, gen_keccak_f)
    rng = np.random.default_rng(kw.pop("data_seed", 20))
    states = [b"\x00" * 200] + [rng.bytes(200) for _ in range(num_loops - 1)]
    states = states[:num_loops]
    inp = np.stack([models.hex_to_bits_lsb(s.hex()) for s in states])
    exp = np.stack(
        [models.hex_to_bits_lsb(models.keccak_f(s).hex()) for s in states]
    )
    return run_harness(
        f"keccak[{os.path.basename(fname)}]", fname, [inp], [exp],
        netlist=nl, **kw
    )


def test_sha256(fname: str, num_loops: int = 4, **kw) -> HarnessResult:
    """SHA-256 compression KATs (sha-256-test.txt, test_sha256.cpp:201-243)
    plus random blocks; new-Bristol circuit takes (block, chaining-state)."""
    for cand in ("sha-256-test.txt",):
        kat_path = os.path.join(os.path.dirname(fname), cand)
        if not os.path.exists(kat_path):
            kat_path = os.path.join(
                DEFAULT_CIRCUITS_DIR, "old_bristol_ckts", "crypto", cand
            )
    blocks = [b for b, _ in _read_kat(kat_path)] if os.path.exists(kat_path) else []
    rng = np.random.default_rng(kw.pop("data_seed", 4))
    while len(blocks) < num_loops:
        blocks.append(rng.bytes(64))
    blocks = blocks[:num_loops]
    iv_bytes = b"".join(int.to_bytes(x, 4, "big") for x in models.SHA256_IV)
    inp_m = np.stack([bits_c(b) for b in blocks])
    inp_iv = np.stack([bits_c(iv_bytes)] * len(blocks))
    exp = np.stack([bits_c(models.sha256_compress(b)) for b in blocks])
    return run_harness(
        f"sha256[{os.path.basename(fname)}]", fname, [inp_m, inp_iv], [exp], **kw
    )


def test_aes(fname: str, num_loops: int = 2, **kw) -> HarnessResult:
    """AES-128: expanded (pt + 1408-bit round keys) or non-expanded
    (pt + 128-bit key) selected by filename (test_aes.cpp:184-233), verified
    against the computed AES model (the reference's vectors are unvalidated;
    ours are FIPS-197-checked)."""
    expanded = "non-expanded" not in fname and "expanded" in fname
    rng = np.random.default_rng(kw.pop("data_seed", 6))
    pts = [bytes.fromhex("00112233445566778899aabbccddeeff")]
    keys = [bytes.fromhex("000102030405060708090a0b0c0d0e0f")]
    while len(pts) < num_loops:
        pts.append(rng.bytes(16))
        keys.append(rng.bytes(16))
    pts, keys = pts[:num_loops], keys[:num_loops]
    exp = np.stack([bits_d(models.aes128_encrypt(p, k)) for p, k in zip(pts, keys)])
    inp_pt = np.stack([bits_d(p) for p in pts])
    if expanded:
        inp_k = np.stack(
            [bits_d(b"".join(models.aes128_expand_key(k))) for k in keys]
        )
    else:
        inp_k = np.stack([bits_d(k) for k in keys])
    return run_harness(
        f"aes[{os.path.basename(fname)}]", fname, [inp_pt, inp_k], [exp], **kw
    )
