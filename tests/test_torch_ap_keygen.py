"""Binary-base AP key generation of the port (oece_tpu_torch.fhe.devkeygen)
on the CPU.

``assemble_ap`` fed the JAX AP keygen's own threefry draws must reproduce
``device_keygen_ap``'s keys bit for bit (ap_ext unpacked from the windows,
ksk); the port's own ``device_keygen_ap`` must give working gates."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import devkeygen as jdevkeygen
from oece_tpu.fhe import golden
from oece_tpu.fhe.params import BinFHEMethod as JMethod
from oece_tpu_torch.fhe import ap, boot, devkeygen, keys, lwe
from oece_tpu_torch.fhe.params import MICRO, MICRO_A, STD128_OPT, BinFHEMethod
from test_torch_copies import jax_params, port_bootstrap_key

MICRO_AP2 = dataclasses.replace(MICRO_A, name="MICRO_AP2", B_r=2)
STD_AP_N2 = dataclasses.replace(STD128_OPT, name="STD128_OPT_AP_N2", n=2)
TRUTH = [
    lambda a, b: a & b, lambda a, b: a | b, lambda a, b: 1 - (a & b),
    lambda a, b: 1 - (a | b), lambda a, b: a ^ b, lambda a, b: 1 - (a ^ b),
]


def _jax_ap_draws(p, seed_words):
    """(s, z, A, E, Aks, Eks) exactly as _keygen_ap_jit samples them."""
    ks, s, z = jdevkeygen._prf_root_and_secrets(jax_params(p), jnp.asarray(seed_words))
    shape = (p.n * p.d_r, 2 * p.d_g_used, p.N)
    A = jdevkeygen._uniform_mod(ks[4], shape, p.Q)
    E = jdevkeygen._gauss(ks[5], p.sigma, shape)
    Aks = jdevkeygen._uniform_mod(ks[6], (p.N * p.d_ks, p.n), p.Q_ks)
    Eks = jdevkeygen._gauss(ks[7], p.sigma, (p.N * p.d_ks,))
    return [torch.from_numpy(np.array(x)) for x in (s, z, A, E, Aks, Eks)]


@pytest.mark.parametrize("params", [MICRO_AP2, STD_AP_N2], ids=lambda p: p.name)
def test_assemble_ap_matches_jax_keygen(params):
    p = params
    sk, _, dkeys = jdevkeygen.device_keygen_ap(jax_params(p), seed=1234)
    kt = devkeygen.assemble_ap(p, *_jax_ap_draws(p, jdevkeygen._seed_words(1234)))
    want = keys.from_jax(dkeys)
    assert kt.method == want.method == BinFHEMethod.AP
    np.testing.assert_array_equal(kt.ap_ext.numpy(), want.ap_ext.numpy())
    np.testing.assert_array_equal(kt.ksk.numpy(), np.asarray(dkeys.ksk))
    np.testing.assert_array_equal(kt.tv_table.numpy(), np.asarray(dkeys.tv_table))


def test_ap_refresh_keys_match_golden_layout():
    """Each step key is RGSW(X^{(s_i * 2^j) mod 2N}) in golden.rgsw_encrypt's
    row layout: with zero noise and a zero ring secret, row j < d holds the
    monomial times gadget j in its a slot, row d+j in its b slot."""
    p = MICRO_AP2
    d, steps = p.d_g_used, p.n * p.d_r
    s = torch.tensor(np.resize([-1, 0, 1], p.n), dtype=torch.int32)
    z = torch.zeros(p.N, dtype=torch.int32)
    A = torch.zeros((steps, 2 * d, p.N), dtype=torch.int32)
    rows = devkeygen.ap_refresh_keys(p, s, z, A, torch.zeros_like(A)).numpy()
    for i in range(p.n):
        for j in range(p.d_r):
            c = (int(s[i]) * 2**j) % (2 * p.N)
            mono = np.zeros(p.N, dtype=np.int64)
            mono[c % p.N] = 1 if c < p.N else p.Q - 1
            for g in range(d):
                mg = mono * ((pow(p.B_g, g, p.Q) << p.g_shift) % p.Q) % p.Q
                np.testing.assert_array_equal(rows[i * p.d_r + j, g, 0], mg)
                np.testing.assert_array_equal(rows[i * p.d_r + j, d + g, 1], mg)
                assert not rows[i * p.d_r + j, g, 1].any()


def test_own_ap_keygen_gives_working_gates():
    p = MICRO_AP2
    words = np.arange(8, dtype=np.uint32)
    sk, kt = devkeygen.device_keygen_ap(p, words, "cpu")
    sk2, kt2 = devkeygen.device_keygen_ap(p, words, "cpu")
    np.testing.assert_array_equal(sk.s, sk2.s)  # deterministic in the seed
    assert torch.equal(kt.ap_ext, kt2.ap_ext) and torch.equal(kt.ksk, kt2.ksk)
    rng = np.random.default_rng(9)
    B = 18
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    gids = np.arange(B, dtype=np.int32) % 6
    c1 = torch.from_numpy(lwe.encrypt_bits(sk, m1, rng))
    c2 = torch.from_numpy(lwe.encrypt_bits(sk, m2, rng))
    plain0 = ap.PLAIN_LAUNCHES
    out = boot.eval_bin_gate_batch(kt, torch.from_numpy(gids), c1, c2)
    assert ap.PLAIN_LAUNCHES == plain0 + 1
    want = np.array([TRUTH[g](int(a), int(b)) for g, a, b in zip(gids, m1, m2)])
    np.testing.assert_array_equal(lwe.decrypt_bits(sk, out.numpy()), want)


def test_ap_keygen_refuses_generic_base():
    """Device AP keygen is binary-base only, as in the JAX package; golden's
    generic-base keys (B_r = 32) are packed with every digit value (they
    used to be refused; tests/test_torch_ap_generic.py runs them)."""
    with pytest.raises(ValueError, match="B_r=32"):
        devkeygen.device_keygen_ap(MICRO, np.zeros(8, np.uint32))
    jp = jax_params(MICRO)
    sk = golden.lwe_keygen(jp, np.random.default_rng(0))
    bk = golden.bootstrap_keygen(jp, sk, np.random.default_rng(1), JMethod.AP)
    kt = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    assert kt.ap_ext.shape == (MICRO.n * MICRO.d_r * MICRO.B_r, 2 * MICRO.d_g_used, 8, 2 * MICRO.N)
