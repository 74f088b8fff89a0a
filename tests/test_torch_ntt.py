"""The port's negacyclic NTT (fhe/ntt.py, its copy of the NumPy reference,
and fhe/ntt_dev.py, the batched torch transforms) against
oece_tpu.fhe.ntt, bit for bit (tolerance 0), on the CPU."""

import numpy as np
import pytest
import torch

from oece_tpu.fhe import golden as jgolden
from oece_tpu.fhe import ntt as jntt
from oece_tpu_torch.fhe import ntt, ntt_dev
from oece_tpu_torch.fhe.params import Q27


@pytest.mark.parametrize("N", [64, 128, 512, 1024])
def test_host_copy_matches_jax(N):
    rng = np.random.default_rng(N)
    a = rng.integers(0, Q27, (3, N))
    b = rng.integers(0, Q27, (3, N))
    assert ntt.find_psi(N) == jntt.find_psi(N)
    np.testing.assert_array_equal(ntt.ntt_forward(a), jntt.ntt_forward(a))
    np.testing.assert_array_equal(ntt.ntt_inverse(a), jntt.ntt_inverse(a))
    np.testing.assert_array_equal(ntt.negacyclic_mul_ntt(a, b), jntt.negacyclic_mul_ntt(a, b))


@pytest.mark.parametrize("N", [64, 256, 1024])
def test_dev_matches_host(N):
    """Forward, inverse and product: ntt_dev == oece_tpu.fhe.ntt, and the
    product == golden.negacyclic_mul."""
    rng = np.random.default_rng(7 + N)
    a = rng.integers(0, Q27, (4, N), dtype=np.int64)
    b = rng.integers(0, Q27, (4, N), dtype=np.int64)
    a[0] = 0
    a[1] = Q27 - 1
    fa = ntt_dev.ntt_forward_dev(torch.from_numpy(a).to(torch.int32))
    np.testing.assert_array_equal(fa.numpy(), jntt.ntt_forward(a))
    np.testing.assert_array_equal(ntt_dev.ntt_inverse_dev(fa).numpy(), a)
    np.testing.assert_array_equal(ntt_dev.ntt_inverse_dev(torch.from_numpy(a)).numpy(), jntt.ntt_inverse(a))
    want = np.stack([jgolden.negacyclic_mul(x, y, Q27) for x, y in zip(a, b)])
    got = ntt_dev.negacyclic_mul_ntt_dev(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_step_product_ntt():
    """One step's product in NTT form == the sum over rows of golden
    negacyclic products of the digits with the key, mod Q."""
    rng = np.random.default_rng(3)
    B, R, M, N = 2, 3, 2, 128
    dig = rng.integers(-128, 128, (B, R, N), dtype=np.int64)
    key = rng.integers(0, Q27, (R, M, N), dtype=np.int64)
    key_ntt = ntt_dev.ntt_forward_dev(torch.from_numpy(key.reshape(R * M, N))).view(R, M, N)
    got = ntt_dev.step_product_ntt(torch.from_numpy(dig).to(torch.int8), key_ntt)
    want = np.zeros((B, M, N), np.int64)
    for b in range(B):
        for m in range(M):
            for r in range(R):
                want[b, m] += jgolden.negacyclic_mul(dig[b, r] % Q27, key[r, m], Q27)
    np.testing.assert_array_equal(got.numpy(), want % Q27)
