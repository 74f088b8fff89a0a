"""Key generation of the port (oece_tpu_torch.fhe.devkeygen) on the CPU.

``assemble(..., layout="rev2")`` fed the JAX keygen's own threefry draws
(the PRF splits of oece_tpu.fhe.devkeygen) must reproduce
``_keygen_jit(..., "rev2")`` bit for bit (tests/test_torch_rev.py holds
the "rev" layout); the port's own ``sample`` (torch.Generator) must give
working keys."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import devkeygen as jdevkeygen
from oece_tpu.fhe import golden
from oece_tpu.fhe.params import BinGate as JGate
from oece_tpu_torch.fhe import boot, devkeygen, keys, lwe
from oece_tpu_torch.fhe.params import MICRO, MICRO_A, STD128_OPT
from test_torch_copies import jax_params

STD_N2 = dataclasses.replace(STD128_OPT, name="STD128_OPT_N2", n=2)
TRUTH = [
    lambda a, b: a & b, lambda a, b: a | b, lambda a, b: 1 - (a & b),
    lambda a, b: 1 - (a | b), lambda a, b: a ^ b, lambda a, b: 1 - (a ^ b),
]


def _jax_draws(p, seed_words):
    """(s, z, A, E, Aks, Eks) exactly as _keygen_jit samples them."""
    ks, s, z = jdevkeygen._prf_root_and_secrets(jax_params(p), jnp.asarray(seed_words))
    d = p.d_g_used
    A = jdevkeygen._uniform_mod(ks[2], (p.n, 2, 2 * d, p.N), p.Q)
    E = jdevkeygen._gauss(ks[3], p.sigma, (p.n, 2, 2 * d, p.N))
    Aks = jdevkeygen._uniform_mod(ks[6], (p.N * p.d_ks, p.n), p.Q_ks)
    Eks = jdevkeygen._gauss(ks[7], p.sigma, (p.N * p.d_ks,))
    return [torch.from_numpy(np.array(x)) for x in (s, z, A, E, Aks, Eks)]


@pytest.mark.parametrize("params", [MICRO, MICRO_A, STD_N2], ids=lambda p: p.name)
def test_assemble_matches_jax_keygen(params):
    words = jdevkeygen._seed_words(1234)
    s, z, rev2, ksk = jdevkeygen._keygen_jit(jax_params(params), jnp.asarray(words), "rev2")
    kt = devkeygen.assemble(params, *_jax_draws(params, words), layout="rev2")
    np.testing.assert_array_equal(kt.rev2.numpy(), np.asarray(rev2))
    np.testing.assert_array_equal(kt.ksk.numpy(), np.asarray(ksk))
    tv = np.stack([golden.make_test_vector(jax_params(params), JGate[g.name]) for g in keys.GATE_ORDER])
    np.testing.assert_array_equal(kt.tv_table.numpy(), tv)


def test_negacyclic_by_ternary_matches_golden():
    p = MICRO
    rng = np.random.default_rng(3)
    A = rng.integers(0, p.Q, (3, p.N))
    z = rng.integers(-1, 2, p.N)
    got = devkeygen.negacyclic_by_ternary(
        torch.from_numpy(A.astype(np.int32)), torch.from_numpy(z.astype(np.int32)), p.Q
    ).numpy()
    want = np.stack([golden.negacyclic_mul(a, z, p.Q) for a in A])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", [MICRO, MICRO_A], ids=lambda p: p.name)
def test_own_sampling_gives_working_keys(params):
    words = np.arange(8, dtype=np.uint32)
    sk, kt = devkeygen.device_keygen(params, words, "cpu", layout="rev2")
    sk2, kt2 = devkeygen.device_keygen(params, words, "cpu", layout="rev2")
    np.testing.assert_array_equal(sk.s, sk2.s)  # deterministic in the seed
    assert torch.equal(kt.rev2, kt2.rev2) and torch.equal(kt.ksk, kt2.ksk)
    assert set(np.unique(sk.s)) <= {-1, 0, 1}
    rng = np.random.default_rng(9)
    B = 24
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    gids = np.arange(B, dtype=np.int32) % 6
    c1 = torch.from_numpy(lwe.encrypt_bits(sk, m1, rng))
    c2 = torch.from_numpy(lwe.encrypt_bits(sk, m2, rng))
    out = boot.eval_bin_gate_batch(kt, torch.from_numpy(gids), c1, c2)
    want = np.array([TRUTH[g](int(a), int(b)) for g, a, b in zip(gids, m1, m2)])
    np.testing.assert_array_equal(lwe.decrypt_bits(sk, out.numpy()), want)
    # chained second generation
    out2 = boot.eval_bin_gate_batch(kt, torch.from_numpy(gids), out, c1)
    want2 = np.array([TRUTH[g](int(a), int(b)) for g, a, b in zip(gids, want, m1)])
    np.testing.assert_array_equal(lwe.decrypt_bits(sk, out2.numpy()), want2)


def test_ap_and_ginx_keygen_share_secrets():
    """One seed gives the GINX and the AP keygen the same LWE secret, ring
    secret and key-switch key: each draws from its own named streams
    (tests/test_devkeygen.py::test_device_keygen_ap_shares_secrets_with_ginx
    pins the same for the JAX package)."""
    p = dataclasses.replace(MICRO_A, name="MICRO_AP2", B_r=2)
    words = np.array([13, 0, 0, 0, 0, 0, 0, 7], dtype=np.uint32)
    g = devkeygen.sample(p, devkeygen.seed_generators(words, "cpu"))
    a = devkeygen.sample_ap(p, devkeygen.seed_generators(words, "cpu"))
    for x, y in zip(g[:2] + g[4:], a[:2] + a[4:]):  # s, z, Aks, Eks
        assert torch.equal(x, y)
    assert g[2].shape != a[2].shape  # the refresh-key masks differ by method
    sk_g, kt_g = devkeygen.device_keygen(p, words, "cpu", layout="rev2")
    sk_a, kt_a = devkeygen.device_keygen_ap(p, words, "cpu")
    np.testing.assert_array_equal(sk_g.s, sk_a.s)
    assert torch.equal(kt_g.ksk, kt_a.ksk)
    assert kt_a.rev2 is None and kt_g.ap_ext is None
    other = devkeygen.sample(p, devkeygen.seed_generators(words + 1, "cpu"))
    assert not torch.equal(other[1], g[1])
