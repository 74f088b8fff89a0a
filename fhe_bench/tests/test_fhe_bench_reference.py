"""The plain reference against known answers, the bootstrap counts the
benchmark reports, and the roofline arithmetic at a hand-checked shape."""

import numpy as np
import pytest

from fhe_bench import reference, roofline
from fhe_bench import run as bench_run
from fhe_bench.tests.conftest import ROOT

ADDER = str(ROOT / "examples/old_bristol_ckts/arith/adder_32bit.txt")
MULT = str(ROOT / "examples/old_bristol_ckts/arith/mult_32x32.txt")
AES = str(ROOT / "examples/new_bristol_ckts/crypto/aes_128.txt")


def lsb_bits(values, width):
    return np.array([[(int(v) >> i) & 1 for i in range(width)] for v in values])


def value(bits):
    return [sum(int(b) << i for i, b in enumerate(row)) for row in bits]


@pytest.mark.parametrize("path, op, out_bits", [
    (ADDER, lambda a, b: a + b, 33),
    (MULT, lambda a, b: a * b, 64),
])
def test_arithmetic_known_answers(path, op, out_bits):
    circ = reference.parse(path)
    rng = np.random.default_rng(7)
    a = [0, 2**32 - 1, 1, *rng.integers(0, 2**32, 13)]
    b = [0, 2**32 - 1, 2**32 - 1, *rng.integers(0, 2**32, 13)]
    (out,) = reference.evaluate(circ, [lsb_bits(a, 32), lsb_bits(b, 32)])
    assert out.shape == (16, out_bits)
    assert value(out) == [op(int(x), int(y)) for x, y in zip(a, b)]


def test_aes128_fips197():
    """FIPS-197 appendix C.1 through aes_128.txt (key, then block; whole
    values big-endian, bits LSB first)."""
    circ = reference.parse(AES)

    def bits(x: bytes):
        v = int.from_bytes(x, "big")
        return np.array([[(v >> i) & 1 for i in range(8 * len(x))]])

    (out,) = reference.evaluate(circ, [bits(bytes(range(16))),
                                       bits(bytes.fromhex("00112233445566778899aabbccddeeff"))])
    got = value(out)[0].to_bytes(16, "big").hex()
    assert got == "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("path, T, xor_mode, want", [
    (AES, 1, "native", 203160),
    (ADDER, 4, "native", 628),
    (MULT, 1, "native", 7104),
    (MULT, 4, "native", 28416),
    (ADDER, 1, "compound", 63 + 31 + 3 * 63),
])
def test_bootstrap_counts(path, T, xor_mode, want):
    circ = reference.parse(path)
    assert bench_run.bootstraps_per_request(circ, {"T": T, "xor_mode": xor_mode}) == want


def test_phase_errors_and_decrypt():
    q, s = 1024, np.array([1, -1, 0, 1])
    a = np.array([[5, 7, 100, 1000], [3, 0, 9, 1]])
    bits = np.array([1, 0])
    err = np.array([-9, 40])
    b = (a @ s + bits * (q // 4) + err) % q
    cts = np.concatenate([a, b[:, None]], axis=1)
    assert reference.decrypt(cts, s, q).tolist() == [1, 0]
    assert reference.phase_errors(cts, s, bits, q).tolist() == [-9, 40]
    # against the other bit the error is a quarter of q away
    assert reference.phase_errors(cts, s, 1 - bits, q).tolist() == [-9 + 256, 40 - 256]


STD128_OPT = {"n": 502, "N": 1024, "B_r": 2}


def test_roofline_ginx_hand_checked():
    """STD128_OPT, d = 2, B = 4: 4 gates x 502 steps x 2 x (2*2 rows x 2
    polys x 4 limbs x 1024**2 MACs) x 2 ops = 269.5 G ops at 1,979 TOPS
    = 136.2 us; bytes 502 x 65,536 + 2 x 4 x 2 x 1024 x 4 = 32.96 MB at
    3.35 TB/s = 9.84 us: operations bound it."""
    t, what = roofline.ginx_call(STD128_OPT, 2, 4)
    ops = 4 * 502 * 2 * (4 * 2 * 4 * 1024**2) * 2
    assert ops == 269_509_197_824
    assert what == "operations"
    assert t == pytest.approx(ops / 1979e12)
    assert t == pytest.approx(136.19e-6, rel=1e-4)
    assert roofline.rgsw_bytes(STD128_OPT, 2) == 32768
    # one gate-step: 67.1 M MACs (16 N x N products x 4 limbs)
    assert 2 * roofline.product_macs(STD128_OPT, 2) == 16 * 4 * 1024**2


def test_roofline_ap_matches_the_step_bound():
    """Half of the GINX pair per live (gate, step): at B = 2048 with about
    half of the select bits set, 31-35 us a step, beside PERF.md's 31.5 us
    bound for #13 on its run's select bits."""
    import torch

    from fhe_bench.spans import ap_live

    p = dict(STD128_OPT)
    a2N = torch.randint(0, 2048, (2048, 502), generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    pairs, steps = ap_live(a2N, p)
    assert steps == 502 * 11
    assert pairs == pytest.approx(2048 * 502 * 11 / 2, rel=0.01)
    t, what = roofline.ap_call(p, 2, 2048, pairs, steps)
    assert what == "operations"
    assert 31e-6 < t / steps < 35e-6


def test_ap_live_counts_bits_of_the_negated_amount():
    p = {"N": 4, "B_r": 2}  # 2N = 8, d_r = 3
    a2N = np.array([[0, 1], [7, 4]])
    import torch

    from fhe_bench.spans import ap_live

    # -a mod 8 = [[0, 7], [1, 4]]: gate 0 selects (1, 0..2), gate 1 (0, 0) and (1, 2)
    assert ap_live(torch.as_tensor(a2N), p) == (5, 4)
