"""Whole gate bootstraps through the port's standard-form GINX rotation on
the CPU, bit for bit (tolerance 0): ``boot.eval_bin_gate_batch`` on
``ginx_ext`` keys against the JAX ``eval_bin_gate_batch`` on ``ginx_pallas``
keys (interpret mode) and ``golden.eval_bin_gate``, all six gates; and the
plain rotation against ``golden.blind_rotate_ginx`` from ciphertexts."""

import jax.numpy as jnp
import numpy as np
import pytest

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import golden as jgolden
from oece_tpu.fhe import lwe as jlwe
from oece_tpu.fhe import params as jparams
from oece_tpu_torch.fhe import boot, keys, std
from test_torch_std import _t, both, jax_fast
from test_torch_copies import port_bootstrap_key
from test_torch_std_rotation import _a2N


def test_plain_rotation_matches_golden_blind_rotate():
    """From a ciphertext: the test-vector accumulator and n = 16 steps of
    MICRO golden keys, against golden.blind_rotate_ginx itself."""
    jp, pp = both("MICRO")
    rng = np.random.default_rng(8)
    sk = jgolden.lwe_keygen(jp, rng)
    bk = jgolden.bootstrap_keygen(jp, sk, rng, jparams.BinFHEMethod.GINX)
    kt = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    B = 4
    a2N = _a2N(jp, rng, B, jp.n)
    b2N = rng.integers(0, 2 * jp.N, B)
    tv = np.stack([jgolden.make_test_vector(jp, g) for g in jboot.GATE_ORDER[:B]])
    acc0 = boot.acc_init(_t(tv.astype(np.int32)), _t(b2N), pp.N, pp.Q)
    got = std.blind_rotate_std(acc0, kt.ginx_ext, _t(a2N), pp).numpy()
    for b in range(B):
        ct_2N = np.concatenate([a2N[b], [b2N[b]]]).astype(np.int64)
        np.testing.assert_array_equal(got[b], jgolden.blind_rotate_ginx(jp, bk, ct_2N, tv[b]))


@pytest.fixture(scope="module", params=["MICRO", "MICRO_A"])
def golden_keys(request):
    jp, pp = both(request.param)
    rng = np.random.default_rng(33)
    sk = jgolden.lwe_keygen(jp, rng)
    bk = jgolden.bootstrap_keygen(jp, sk, rng, jparams.BinFHEMethod.GINX)
    return jp, pp, sk, bk


def test_gate_bootstrap_matches_jax_and_golden(golden_keys, monkeypatch):
    monkeypatch.setattr(jboot, "PALLAS_INTERPRET", True)
    jp, pp, sk, bk = golden_keys
    rng = np.random.default_rng(4)
    B = 12
    gids = (np.arange(B) % 6).astype(np.int32)
    c1 = jlwe.encrypt_bits(sk, rng.integers(0, 2, B), rng)
    c2 = jlwe.encrypt_bits(sk, rng.integers(0, 2, B), rng)
    dk = jboot.pack_bootstrap_key(bk, use_pallas=True)
    assert dk.ginx_pallas is not None
    want = np.asarray(jax_fast(jboot.eval_bin_gate_batch)(dk, jnp.asarray(gids), jnp.asarray(c1), jnp.asarray(c2)))
    kt = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    plain0 = std.PLAIN_LAUNCHES
    got = boot.eval_bin_gate_batch(kt, _t(gids), _t(c1), _t(c2)).numpy()
    assert std.PLAIN_LAUNCHES == plain0 + 1
    np.testing.assert_array_equal(got, want)
    for b, gi in enumerate(gids):
        gold = jgolden.eval_bin_gate(
            jp, bk, jboot.GATE_ORDER[gi], c1[b].astype(np.int64), c2[b].astype(np.int64)
        )
        np.testing.assert_array_equal(got[b], gold)
    # and the keys from JAX's windows run the same
    got_j = boot.eval_bin_gate_batch(keys.from_jax(dk), _t(gids), _t(c1), _t(c2)).numpy()
    np.testing.assert_array_equal(got_j, want)
