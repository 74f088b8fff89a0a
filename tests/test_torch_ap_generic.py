"""The generic-base AP method (B_r = 32: MICRO and TOY) in the port against
the JAX package, bit for bit (tolerance 0), on the CPU.

  * MICRO golden AP keys: the port's packing, its own host keygen from the
    same generator and ``keys.from_jax`` of the JAX package's ``ap_kext``
    give the same ap_ext (every digit value); ``ap.blind_rotate_ap_generic``
    equals ``boot.blind_rotate_ap_dev`` on them, and at TOY's shapes on
    random key bytes with the steps cut;
  * a seeded MICRO AP ``Circuit`` equals the JAX package's in verify mode
    (host keys drawn from the circuit's generator in both, as the JAX
    package does for a generic base): outputs, ciphertext arena, counts
    and the generator's state, on the host branch; on the device branch
    the decryptions and counts;
  * ``BinFHEContext`` at TOY AP (its golden keygen in the JAX package
    takes minutes): KeyGen, BTKeyGen and single gates decrypt right.

The context's whole call sequence at MICRO AP against the JAX context is
tests/test_torch_context.py::test_generic_base_ap_raises."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import golden as jgolden
from oece_tpu.fhe import params as jparams
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu_torch.fhe import ap, golden, hostkeygen, keys
from oece_tpu_torch.fhe import params as pparams
from oece_tpu_torch.fhe.context import BinFHEContext
from oece_tpu_torch.runtime.evaluator import Circuit
from test_torch_copies import jax_params, port_bootstrap_key
from test_torch_std import one_torch_thread  # noqa: F401

ADDER = os.path.join(
    os.path.dirname(__file__), "..", "examples", "simple_ckts", "adder_2bit", "adder_2bit.out"
)


@pytest.fixture(scope="module")
def micro_keys():
    """Golden MICRO AP keys (seed 5), the JAX package's jnp packing, and
    the generator's state after them."""
    rng = np.random.default_rng(5)
    jsk = jgolden.lwe_keygen(jparams.MICRO, rng)
    bk = jgolden.bootstrap_keygen(jparams.MICRO, jsk, rng, jparams.BinFHEMethod.AP)
    return bk, jboot.pack_bootstrap_key(bk, use_pallas=False), rng.integers(0, 2**62)


def test_generic_keys_match_golden(micro_keys):
    bk, dk, after = micro_keys
    p = pparams.MICRO
    kt = keys.from_jax(dk)
    assert kt.ap_ext.shape == (p.n * p.d_r * p.B_r, 2 * p.d_g_used, 8, 2 * p.N)
    packed = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    rng = np.random.default_rng(5)
    sk = golden.lwe_keygen(p, rng)
    host = hostkeygen.bootstrap_keygen(p, sk, rng, pparams.BinFHEMethod.AP, "cpu")
    assert rng.integers(0, 2**62) == after  # golden's draws, in golden's order
    for got in (packed, host):
        assert torch.equal(got.ap_ext, kt.ap_ext)
        assert torch.equal(got.ksk, kt.ksk) and torch.equal(got.tv_table, kt.tv_table)


@pytest.mark.parametrize("B", [1, 7])
def test_generic_rotation_matches_jax(micro_keys, B):
    _, dk, _ = micro_keys
    p = pparams.MICRO
    rng = np.random.default_rng(B)
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)
    a2N = rng.integers(0, 2 * p.N, (B, p.n)).astype(np.int32)
    a2N[0, : p.n // 2] = 0  # digit 0 in half the steps: the accumulator stays
    want = np.asarray(jax.jit(jboot.blind_rotate_ap_dev)(jnp.asarray(acc), jnp.asarray(a2N), dk))
    n0 = ap.GENERIC_LAUNCHES
    got = ap.blind_rotate_ap_generic(torch.from_numpy(acc), keys.from_jax(dk).ap_ext,
                                     torch.from_numpy(a2N), p)
    assert ap.GENERIC_LAUNCHES == n0 + 1
    np.testing.assert_array_equal(got.numpy(), want)
    zero = ap.blind_rotate_ap_generic(torch.from_numpy(acc), keys.from_jax(dk).ap_ext,
                                      torch.zeros_like(torch.from_numpy(a2N)), p)
    np.testing.assert_array_equal(zero.numpy(), acc)


def test_generic_rotation_toy_shapes():
    """TOY's widths (N = 512, R = 8, B_r = 32, d_r = 2) with n cut to 2 and
    random key bytes: the rotation agrees with the JAX package's for any
    key values."""
    p = pparams.dataclasses.replace(pparams.TOY, n=2)
    jp = jax_params(p)
    rng = np.random.default_rng(9)
    R = 2 * p.d_g_used
    kext = rng.integers(-128, 128, (p.n, p.d_r, p.B_r, R, 2, 4, 2 * p.N), dtype=np.int8)
    dk = jboot.DeviceBootKeys(params=jp, method=jparams.BinFHEMethod.AP, ginx_kext=None,
                              ap_kext=jnp.asarray(kext), ksk=jnp.zeros((1,), jnp.int8),
                              tv_table=jnp.zeros((6, p.N), jnp.int32))
    B = 3
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)
    a2N = rng.integers(0, 2 * p.N, (B, p.n)).astype(np.int32)
    want = np.asarray(jax.jit(jboot.blind_rotate_ap_dev)(jnp.asarray(acc), jnp.asarray(a2N), dk))
    ext = torch.from_numpy(kext.reshape(-1, R, 8, 2 * p.N))
    got = ap.blind_rotate_ap_generic(torch.from_numpy(acc), ext, torch.from_numpy(a2N), p)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="bad shapes"):
        ap.blind_rotate_ap_generic(torch.from_numpy(acc), ext[:-1], torch.from_numpy(a2N), p)


@pytest.mark.parametrize("level_jit", ["0", "1"])
def test_generic_circuit_matches_jax(monkeypatch, level_jit):
    """adder_2bit in verify mode, T = 3, MICRO AP seed 13, one input's b
    shifted by q/2 in case 1 (repairs follow): the host branch bit for bit,
    the device branch in decryptions and counts (its re-encryptions draw
    from another generator)."""
    monkeypatch.setenv("OECE_LEVEL_JIT", level_jit)
    jc = JaxCircuit(set="MICRO", method="AP", seed=13)
    tc = Circuit(set="MICRO", method="AP", seed=13, device="cpu")
    assert jc.dkeys.ap_kext is not None and tc.keys.ap_ext is not None
    np.testing.assert_array_equal(tc.sk.s, jc.sk.s)
    assert torch.equal(tc.keys.ap_ext, keys.from_jax(jc.dkeys).ap_ext)
    rng = np.random.default_rng(2)
    ins = [rng.integers(0, 2, (3, 2)), rng.integers(0, 2, (3, 2))]
    for c in (jc, tc):
        c.ReadFile(ADDER)
        c.setVerify(True)
        c.SetInput(ins)
    slot = int(tc._slot[int(tc.netlist.inputs[0][0])])
    jc._ct_arena = jc._ct_arena.at[slot, 1, -1].add(jc.params.q // 2)
    tc._ct_arena[slot, 1, -1] += tc.params.q // 2
    n0 = ap.GENERIC_LAUNCHES
    jc.Clock()
    tc.Clock()
    assert ap.GENERIC_LAUNCHES > n0 and tc._dev_branch == (level_jit == "1")
    for a, b in zip(jc.GetOutput(), tc.GetOutput()):
        np.testing.assert_array_equal(a, b)
    want = ins[0] @ (1 << np.arange(2)) + ins[1] @ (1 << np.arange(2))
    np.testing.assert_array_equal(tc.GetOutput()[0] @ (1 << np.arange(3)), want)
    assert tc.bad_gate_counts == jc.bad_gate_counts and sum(tc.bad_gate_counts.values()) > 0
    assert tc.bad_gate_levels == jc.bad_gate_levels
    assert tc.gate_counts == jc.gate_counts
    assert tc._rng.bit_generator.state == jc._rng.bit_generator.state
    if level_jit == "0":
        np.testing.assert_array_equal(tc._ct_arena.numpy(), np.asarray(jc._ct_arena))


def test_toy_context_gates():
    """BinFHEContext at TOY, method AP (B_r = 32): golden's draws with the
    products on the device, every digit value kept, and single gates that
    decrypt right."""
    p = pparams.TOY
    tc = BinFHEContext(device="cpu").GenerateBinFHEContext("TOY", "AP", seed=3)
    sk = tc.KeyGen()
    tc.BTKeyGen(sk)
    assert tc.keys.ap_ext.shape == (p.n * p.d_r * p.B_r, 2 * p.d_g_used, 8, 2 * p.N)
    for gate, (a, b), want in (("AND", (1, 1), 1), ("XOR", (1, 0), 1), ("NOR", (0, 1), 0)):
        out = tc.EvalBinGate(gate, tc.Encrypt(sk, a), tc.Encrypt(sk, b))
        assert tc.Decrypt(sk, out) == want, gate
