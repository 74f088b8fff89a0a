"""Batched gate bootstrapping of the port (oece_tpu_torch.fhe.boot, .lwe) on
the CPU against the JAX package's main path and the golden model, bit for
bit: whole gate batches (all six gates) on JAX device-keygen rev2 keys and
on golden keys, and each stage around the rotation on its own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import devkeygen as jdevkeygen
from oece_tpu.fhe import golden
from oece_tpu.fhe import lwe as jlwe
from oece_tpu.fhe.params import BinFHEMethod as JMethod
from oece_tpu.fhe.params import BinGate as JGate
from oece_tpu_torch.fhe import boot, keys, lwe
from oece_tpu_torch.fhe.params import MICRO, MICRO_A
from test_torch_copies import jax_params, port_bootstrap_key


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=[MICRO, MICRO_A], ids=lambda p: p.name)
def setup(request):
    p = request.param
    sk, _, dkeys = jdevkeygen.device_keygen(jax_params(p), seed=21, layout="rev2")
    return p, sk, dkeys, keys.from_jax(dkeys)


def _gate_inputs(sk, rng, B):
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    gids = (np.arange(B) % 6).astype(np.int32)
    return gids, jlwe.encrypt_bits(sk, m1, rng), jlwe.encrypt_bits(sk, m2, rng)


def test_gate_batch_matches_jax(setup, monkeypatch):
    monkeypatch.setattr(jboot, "PALLAS_INTERPRET", True)
    p, sk, dkeys, kt = setup
    rng = np.random.default_rng(4)
    gids, c1, c2 = _gate_inputs(sk, rng, 12)
    want = np.asarray(jboot.eval_bin_gate_batch(
        dkeys, jnp.asarray(gids), jnp.asarray(c1), jnp.asarray(c2)
    ))
    got = boot.eval_bin_gate_batch(kt, _t(gids), _t(c1), _t(c2)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", [MICRO, MICRO_A], ids=lambda p: p.name)
def test_gate_batch_matches_golden_rot_form(params):
    p = jax_params(params)
    rng = np.random.default_rng(52)
    sk = golden.lwe_keygen(p, rng)
    bk = golden.bootstrap_keygen(p, sk, rng, JMethod.GINX)
    kt = keys.pack_rotated_form(port_bootstrap_key(bk), "cpu")
    gids, c1, c2 = _gate_inputs(sk, rng, 6)
    got = boot.eval_bin_gate_batch(kt, _t(gids), _t(c1), _t(c2)).numpy()
    for b, gi in enumerate(gids):
        gate = JGate[keys.GATE_ORDER[gi].name]
        prep = golden.gate_prepare(gate, c1[b].astype(np.int64), c2[b].astype(np.int64), p.q)
        want = golden.bootstrap(p, bk, prep, gate, form="rot")
        np.testing.assert_array_equal(got[b], want)


def test_stages_match_jax(setup):
    p, sk, dkeys, kt = setup
    rng = np.random.default_rng(5)
    B = 9
    gids, c1, c2 = _gate_inputs(sk, rng, B)
    # gate prep and the q -> 2N / Q_ks -> q mod switches
    prep = np.asarray(jboot.prepare_gates(jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(gids), p.q))
    np.testing.assert_array_equal(boot.prepare_gates(_t(c1), _t(c2), _t(gids), p.q).numpy(), prep)
    lq, l2n = int(np.log2(p.q)), int(np.log2(2 * p.N))
    for frm, to in ((lq, l2n), (15, lq)):
        x = rng.integers(0, 1 << frm, (B, p.n + 1)).astype(np.int32)
        np.testing.assert_array_equal(
            boot.mod_switch_pow2(_t(x), frm, to).numpy(),
            np.asarray(jboot._mod_switch_pow2(jnp.asarray(x), frm, to)),
        )
    # accumulator init, sample extract and the key switch
    tv = np.asarray(dkeys.tv_table)[gids]
    b2N = rng.integers(0, 2 * p.N, B).astype(np.int32)
    np.testing.assert_array_equal(
        boot.acc_init(_t(tv), _t(b2N), p.N, p.Q).numpy(),
        np.asarray(jboot._acc_init(jnp.asarray(tv), jnp.asarray(b2N), p.N, p.Q)),
    )
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)
    acc[0, 0] = 0
    np.testing.assert_array_equal(
        boot.sample_extract(_t(acc), p.Q).numpy(),
        np.asarray(jboot.sample_extract(jnp.asarray(acc), p.Q)),
    )
    ct = rng.integers(0, p.Q_ks, (B, p.N + 1)).astype(np.int32)
    np.testing.assert_array_equal(
        boot.key_switch_dev(_t(ct), kt).numpy(),
        np.asarray(jboot.key_switch_dev(jnp.asarray(ct), dkeys)),
    )
    np.testing.assert_array_equal(
        boot.monomial_rotate(_t(acc), _t(b2N), p.N, p.Q).numpy(),
        np.asarray(jboot.monomial_rotate(jnp.asarray(acc), jnp.asarray(b2N), p.N, p.Q)),
    )


def test_digit_decompositions_match_jax():
    rng = np.random.default_rng(6)
    p = MICRO_A
    x = np.concatenate([np.array([0, 1, p.Q // 2, (p.Q + 1) // 2, p.Q - 1]),
                        rng.integers(0, p.Q, 2048)]).astype(np.int32)
    cases = [
        (boot.gadget_digits_dev(_t(x), p.B_g, 4), jboot.gadget_digits_dev(jnp.asarray(x), p.B_g, 4)),
        (boot.gadget_digits_approx_dev(_t(x), p.Q, p.B_g, 2, p.g_shift),
         jboot.gadget_digits_approx_dev(jnp.asarray(x), p.Q, p.B_g, 2, p.g_shift)),
    ]
    ks = rng.integers(0, p.Q_ks, 2048).astype(np.int32)
    cases.append((boot.signed_digits_dev(_t(ks), p.B_ks, p.d_ks),
                  jboot.signed_digits_dev(jnp.asarray(ks), p.B_ks, p.d_ks)))
    for got, want in cases:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lwe_ops_match_jax(setup):
    p, sk, _, _ = setup
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, 64)
    cts = jlwe.encrypt_bits(sk, bits, rng)
    cts[:8, -1] = (cts[:8, -1] + rng.integers(-p.q // 4, p.q // 4, 8)) % p.q  # drifted phases
    s = np.asarray(sk.s, dtype=np.int32)
    np.testing.assert_array_equal(
        lwe.eval_not_batch(_t(cts), p.q).numpy(), np.asarray(jlwe.eval_not_batch(cts, p.q))
    )
    got = lwe.decrypt_bits_dev(_t(s), _t(cts), p.q).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlwe.decrypt_bits_dev(jnp.asarray(s), jnp.asarray(cts), p.q)))
    np.testing.assert_array_equal(got, jlwe.decrypt_bits(sk, cts))
    np.testing.assert_array_equal(got[8:], bits[8:])
    for g_, w_ in zip(lwe.phase_margin_dev(_t(s), _t(cts), p.q),
                      jlwe.phase_margin_dev(jnp.asarray(s), jnp.asarray(cts), p.q)):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
