"""oece_tpu_torch.fhe.modmath against oece_tpu.fhe.modmath, bit for bit, on
the same int32 arrays (seeded random values plus the edge values)."""

import numpy as np
import pytest
import torch

from oece_tpu.fhe import modmath as ref
from oece_tpu_torch.fhe import modmath
from oece_tpu_torch.fhe.params import Q27

Q = Q27


def _same(fn_ref, fn_port, x: np.ndarray, *args):
    want = np.asarray(fn_ref(x, *args))
    got = fn_port(torch.from_numpy(x), *args).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got


def test_red31():
    rng = np.random.default_rng(1)
    edge = np.array([0, 1, Q - 1, Q, Q + 1, 2 * Q, (1 << 27) - 1, 1 << 27, 2**31 - 1], np.int32)
    x = np.concatenate([edge, rng.integers(0, 2**31, 4096).astype(np.int32)])
    got = _same(ref.red31, modmath.red31, x, Q)
    assert got.min() >= 0 and got.max() < Q


def test_mod_q():
    rng = np.random.default_rng(2)
    edge = np.array([0, 1, -1, Q - 1, -(Q - 1), Q, -Q, 2**30, -(2**30), 3 * Q, -3 * Q], np.int32)
    x = np.concatenate([edge, rng.integers(-(2**30), 2**30 + 1, 4096).astype(np.int32)])
    got = _same(ref.mod_q, modmath.mod_q, x, Q)
    np.testing.assert_array_equal(got, x.astype(np.int64) % Q)


def test_mul_pow8_mod():
    rng = np.random.default_rng(3)
    x = np.concatenate([np.array([0, 1, Q - 1, (1 << 19) - 1, 1 << 19], np.int32),
                        rng.integers(0, Q, 4096).astype(np.int32)])
    got = _same(ref.mul_pow8_mod, modmath.mul_pow8_mod, x, Q)
    np.testing.assert_array_equal(got, (x.astype(np.int64) << 8) % Q)


def test_combine_limbs_mod_q():
    rng = np.random.default_rng(4)
    r = rng.integers(-(2**27), 2**27 + 1, (512, 4)).astype(np.int32)
    r[0] = 2**27
    r[1] = -(2**27)
    r[2] = 0
    got = _same(ref.combine_limbs_mod_q, modmath.combine_limbs_mod_q, r, Q)
    exact = sum(r[:, l].astype(object) * (1 << (8 * l)) for l in range(4)) % Q
    np.testing.assert_array_equal(got, exact.astype(np.int64))


@pytest.mark.parametrize("m_log2", [10, 11, 15])
def test_mod_switch_from_q27(m_log2):
    rng = np.random.default_rng(5 + m_log2)
    x = np.concatenate([np.array([0, 1, Q // 2, Q - 1], np.int32),
                        rng.integers(0, Q, 4096).astype(np.int32)])
    got = _same(ref.mod_switch_from_q27, modmath.mod_switch_from_q27, x, m_log2, Q)
    want = (x.astype(np.int64) * (1 << m_log2) * 2 + Q) // (2 * Q)
    np.testing.assert_array_equal(got, want)


def test_to_limbs_i8():
    rng = np.random.default_rng(6)
    x = np.concatenate([np.array([0, 127, 128, 255, 256, Q - 1, 2 * Q - 1], np.int64),
                        rng.integers(0, 2 * Q, 2048)])
    got = modmath.to_limbs_i8(torch.from_numpy(x.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, ref.to_limbs_i8(x))
