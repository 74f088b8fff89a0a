"""The port's AP method end to end on the CPU, bit for bit:

  * gate batches (all six gates) on JAX device-keygen AP keys against the
    JAX package's ``eval_bin_gate_batch`` (AP megakernel in interpret
    mode), and on golden AP keys against ``golden.eval_bin_gate``;
  * the port's ``Circuit(method="AP")`` against the JAX main-path
    ``Circuit(method="AP")`` (device AP keygen, interpret mode), with the
    JAX circuit's keys, secret and a copy of its generator injected:
    ciphertext arena, outputs, gate counts and verify repairs.
"""

import copy
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.circuits.asm import parse_asm
from oece_tpu.circuits.gen import gen_adder
from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import golden
from oece_tpu.fhe import lwe as jlwe
from oece_tpu.fhe.params import BinFHEMethod as JMethod
from oece_tpu.fhe.params import BinGate as JGate
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu_torch.fhe import ap, boot, keys, rot
from oece_tpu_torch.fhe.golden import LWESecretKey
from oece_tpu_torch.fhe.params import MICRO_A, BinFHEMethod
from oece_tpu_torch.runtime.evaluator import Circuit
from test_torch_copies import jax_params, port_bootstrap_key
from test_torch_std import one_torch_thread  # noqa: F401

MICRO_AP2 = dataclasses.replace(MICRO_A, name="MICRO_AP2", B_r=2)
ADDER = os.path.join(
    os.path.dirname(__file__), "..", "examples", "simple_ckts", "adder_2bit", "adder_2bit.out"
)
CIRCUITS = {
    "adder_2bit": (lambda: parse_asm(ADDER), 4),
    "adder4": (lambda: gen_adder(4), 3),
}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_circuit():
    """One JAX main-path AP circuit (keygen once); each test loads its own
    netlist into it."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OECE_FORCE_DEVICE_KEYGEN", "1")
    mp.setattr(jboot, "PALLAS_INTERPRET", True)
    jc = JaxCircuit(set=jax_params(MICRO_AP2), method="AP", seed=5)
    assert jc.dkeys.ap_pallas is not None
    yield jc, keys.from_jax(jc.dkeys)
    mp.undo()


def _gate_inputs(sk, rng, B):
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    gids = (np.arange(B) % 6).astype(np.int32)
    return gids, jlwe.encrypt_bits(sk, m1, rng), jlwe.encrypt_bits(sk, m2, rng)


def test_gate_batch_matches_jax(jax_circuit):
    jc, kt = jax_circuit
    rng = np.random.default_rng(4)
    gids, c1, c2 = _gate_inputs(jc.sk, rng, 12)
    want = np.asarray(jboot.eval_bin_gate_batch(
        jc.dkeys, jnp.asarray(gids), jnp.asarray(c1), jnp.asarray(c2)
    ))
    got = boot.eval_bin_gate_batch(kt, _t(gids), _t(c1), _t(c2)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gate_batch_matches_golden():
    jp = jax_params(MICRO_AP2)
    rng = np.random.default_rng(53)
    sk = golden.lwe_keygen(jp, rng)
    bk = golden.bootstrap_keygen(jp, sk, rng, JMethod.AP)
    kt = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    gids, c1, c2 = _gate_inputs(sk, rng, 6)
    got = boot.eval_bin_gate_batch(kt, _t(gids), _t(c1), _t(c2)).numpy()
    for b, gi in enumerate(gids):
        want = golden.eval_bin_gate(
            jp, bk, JGate[keys.GATE_ORDER[gi].name], c1[b].astype(np.int64), c2[b].astype(np.int64)
        )
        np.testing.assert_array_equal(got[b], want)


def _twin(jc, kt, nl):
    jc.LoadNetlist(nl)
    tc = Circuit(
        set=MICRO_AP2, method="AP", device="cpu", keys=kt,
        sk=LWESecretKey(s=jc.sk.s, params=MICRO_AP2), rng=copy.deepcopy(jc._rng),
    )
    tc.LoadNetlist(nl)
    for c in (jc, tc):
        c.setVerify(True)
    return tc


def _inputs(nl, T, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, (T, len(w))) for w in nl.inputs]


def _assert_same(jc, tc):
    for a, b in zip(jc.GetOutput(), tc.GetOutput()):
        np.testing.assert_array_equal(a, b)
    assert len(jc.GetOutput()) == len(tc.GetOutput())
    assert tc.gate_counts == jc.gate_counts
    assert tc.bad_gate_counts == jc.bad_gate_counts
    assert tc.bad_gate_levels == jc.bad_gate_levels
    np.testing.assert_array_equal(tc._ct_arena.numpy(), np.asarray(jc._ct_arena))


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_verify_run_matches_jax(jax_circuit, name):
    jc, kt = jax_circuit
    build, T = CIRCUITS[name]
    nl = build()
    tc = _twin(jc, kt, nl)
    ins = _inputs(nl, T, seed=len(name))
    jc.SetInput(ins)
    tc.SetInput(ins)
    plain0, rot_plain0 = ap.PLAIN_LAUNCHES, rot.PLAIN_LAUNCHES
    jc.Clock()
    tc.Clock()
    _assert_same(jc, tc)
    assert ap.PLAIN_LAUNCHES > plain0  # the CPU runs the plain AP rotation
    assert rot.PLAIN_LAUNCHES == rot_plain0
    assert tc.trace.total_bootstraps == jc.trace.total_bootstraps


def test_induced_repair_matches_jax(jax_circuit):
    """+q/2 on one input's b flips the gates reading it: verify repairs
    them, drawing the fresh encryptions from the shared generator in the
    same order."""
    jc, kt = jax_circuit
    build, T = CIRCUITS["adder_2bit"]
    nl = build()
    tc = _twin(jc, kt, nl)
    ins = _inputs(nl, T, seed=11)
    jc.SetInput(ins)
    tc.SetInput(ins)
    slot = int(jc._slot[int(nl.inputs[0][0])])
    jc._ct_arena = jc._ct_arena.at[slot, 0, -1].add(jc.params.q // 2)
    tc._ct_arena[slot, 0, -1] += tc.params.q // 2
    jc.Clock()
    tc.Clock()
    assert sum(tc.bad_gate_counts.values()) > 0
    _assert_same(jc, tc)


def test_port_ap_keygen_runs_circuit():
    c = Circuit(set=MICRO_AP2, method="AP", seed=3, device="cpu")
    assert c.keys.method == BinFHEMethod.AP and c.keys.ap_ext is not None
    c.ReadFile(ADDER)
    c.setVerify(True)
    cases = [(x, y) for x in range(4) for y in range(4)]
    c.SetInput([np.array([[x & 1, x >> 1] for x, _ in cases]),
                np.array([[y & 1, y >> 1] for _, y in cases])])
    c.Clock()
    (out,) = c.GetOutput()
    np.testing.assert_array_equal((out << np.arange(out.shape[1])).sum(1), [x + y for x, y in cases])


def test_method_and_keys_must_agree(jax_circuit):
    _, kt = jax_circuit
    with pytest.raises(ValueError, match="AP keys"):
        Circuit(set=MICRO_AP2, method="GINX", device="cpu", keys=kt)
    # a generic base (MICRO, B_r = 32) takes golden's host keys, every digit value
    c = Circuit(set="MICRO", method="AP", seed=1, device="cpu")
    p = c.params
    assert c.keys.ap_ext.shape == (p.n * p.d_r * p.B_r, 2 * p.d_g_used, 8, 2 * p.N)
