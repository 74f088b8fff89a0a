"""The port's ``Circuit`` on the CPU against the JAX package's main-path
``Circuit`` (device-keygen rev2 keys, the rotation megakernel in interpret
mode, the eager level loop): with the JAX circuit's keys, secret and a copy
of its generator injected, whole runs must agree bit for bit — ciphertext
arena, outputs, gate counts and verify repairs."""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from oece_tpu.circuits.asm import parse_asm
from oece_tpu.circuits.gen import gen_adder, gen_parity
from oece_tpu.circuits.netlist import Netlist
from oece_tpu.fhe import boot as jboot
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu_torch.fhe import keys, rot
from oece_tpu_torch.fhe.golden import LWESecretKey
from oece_tpu_torch.runtime.evaluator import Circuit

ADDER = os.path.join(
    os.path.dirname(__file__), "..", "examples", "simple_ckts", "adder_2bit", "adder_2bit.out"
)
CIRCUITS = {
    "adder_2bit": (lambda: parse_asm(ADDER), 4),
    "adder4": (lambda: gen_adder(4), 3),
    "parity8": (lambda: gen_parity(8), 2),
}


@pytest.fixture(scope="module", params=["MICRO_A", "MICRO"])
def jax_circuit(request):
    """One JAX main-path circuit per parameter set (keygen once); each test
    loads its own netlist into it."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OECE_FORCE_DEVICE_KEYGEN", "1")
    mp.setattr(jboot, "PALLAS_INTERPRET", True)
    jc = JaxCircuit(set=request.param, method="GINX", seed=5)
    assert jc.dkeys.ginx_rev2 is not None
    yield jc, keys.from_jax(jc.dkeys)
    mp.undo()


def _twin(jc, kt, nl: Netlist, plaintext: bool, encrypted: bool, verify: bool, xor_mode="native"):
    jc.LoadNetlist(nl)
    sk = LWESecretKey(s=jc.sk.s, params=kt.params)
    tc = Circuit(set=jc.params.name, device="cpu", keys=kt, sk=sk, rng=copy.deepcopy(jc._rng),
                 xor_mode=xor_mode)
    tc.LoadNetlist(nl)
    for c in (jc, tc):
        c.setPlaintext(plaintext)
        c.setEncrypted(encrypted)
        c.setVerify(verify)
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
    if jc.encrypted_flag:
        np.testing.assert_array_equal(tc._ct_arena.numpy(), np.asarray(jc._ct_arena))


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_verify_run_matches_jax(jax_circuit, name):
    jc, kt = jax_circuit
    build, T = CIRCUITS[name]
    nl = build()
    tc = _twin(jc, kt, nl, True, True, True)
    ins = _inputs(nl, T, seed=len(name))
    jc.SetInput(ins)
    tc.SetInput(ins)
    np.testing.assert_array_equal(tc._ct_arena.numpy(), np.asarray(jc._ct_arena))
    plain0 = rot.PLAIN_LAUNCHES
    jc.Clock()
    tc.Clock()
    _assert_same(jc, tc)
    assert rot.PLAIN_LAUNCHES > plain0  # the CPU runs the plain rotation
    assert tc.trace.summary()["levels"] == jc.trace.summary()["levels"]
    assert tc.trace.total_bootstraps == jc.trace.total_bootstraps


@pytest.mark.parametrize("name", ["adder_2bit", "adder4"])
def test_induced_repair_matches_jax(jax_circuit, name):
    """+q/2 on one input's b flips the AND-family gates reading it: verify
    repairs them, drawing the fresh encryptions from the shared generator
    in the same order (tests/test_evaluator.py's corruption)."""
    jc, kt = jax_circuit
    build, T = CIRCUITS[name]
    nl = build()
    tc = _twin(jc, kt, nl, True, True, True)
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


def test_plaintext_only_matches_jax(jax_circuit):
    jc, kt = jax_circuit
    build, T = CIRCUITS["adder4"]
    nl = build()
    tc = _twin(jc, kt, nl, True, False, False)
    ins = _inputs(nl, 8, seed=3)
    jc.SetInput(ins)
    tc.SetInput(ins)
    jc.Clock()
    tc.Clock()
    _assert_same(jc, tc)
    a = (ins[0] << np.arange(4)).sum(1)
    b = (ins[1] << np.arange(4)).sum(1)
    np.testing.assert_array_equal((tc.GetOutput()[0] << np.arange(5)).sum(1), a + b)


def test_encrypted_recovery_off_matches_jax(jax_circuit):
    """Pure-encrypted runs with setRecovery(False): the JAX package's
    recovery-off configuration, the only pure-encrypted mode ported."""
    jc, kt = jax_circuit
    nl = gen_adder(4)
    tc = _twin(jc, kt, nl, False, True, False)
    for c in (jc, tc):
        c.setRecovery(False)
    ins = _inputs(nl, 2, seed=4)
    jc.SetInput(ins)
    tc.SetInput(ins)
    jc.Clock()
    tc.Clock()
    _assert_same(jc, tc)


def test_port_keygen_runs_circuit():
    c = Circuit(set="MICRO_A", seed=3, device="cpu")
    c.ReadFile(ADDER)
    c.setVerify(True)
    cases = [(x, y) for x in range(4) for y in range(4)]
    xa = np.array([[x & 1, x >> 1] for x, _ in cases])
    xb = np.array([[y & 1, y >> 1] for _, y in cases])
    c.SetInput([xa, xb])
    c.Clock()
    (out,) = c.GetOutput()
    np.testing.assert_array_equal((out << np.arange(out.shape[1])).sum(1), [x + y for x, y in cases])
    assert c.gate_counts["AND"] == 3 * 16


def test_unported_features_raise(monkeypatch):
    """The generic-base AP method still raises; recovery, compound XOR,
    DFF state and the automatic recovery of a pure-encrypted Clock() now
    run, and match the JAX package's main-path Circuit bit for bit on the
    host branch (MICRO keys, secret and generator injected)."""
    with pytest.raises(NotImplementedError, match="AP method"):
        Circuit(set="MICRO", method="AP", device="cpu")
    monkeypatch.setenv("OECE_FORCE_DEVICE_KEYGEN", "1")
    monkeypatch.setenv("OECE_AUTO_RECOVER", "1")
    monkeypatch.delenv("OECE_LEVEL_JIT", raising=False)
    monkeypatch.setattr(jboot, "PALLAS_INTERPRET", True)
    jc = JaxCircuit(set="MICRO", method="GINX", seed=1)
    kt = keys.from_jax(jc.dkeys)
    nl = gen_adder(2)
    dff = dataclasses.replace(nl, dff_d=nl.outputs[0][:1], dff_q=nl.inputs[0][:1])
    for xor_mode, net, modes in (("native", nl, "recovery"), ("native", nl, "auto"),
                                 ("compound", nl, "verify"), ("native", dff, "verify")):
        jc.xor_mode = xor_mode
        jc.recover_flag, jc._recover_explicit = False, False
        tc = _twin(jc, kt, net, modes == "verify", True, modes == "verify", xor_mode)
        if modes == "recovery":
            for c in (jc, tc):
                c.setRecovery(True)
        for cycle in range(2 if net is dff else 1):
            ins = _inputs(net, 2, seed=cycle)
            jc.SetInput(ins)
            tc.SetInput(ins)
            jc.Clock()
            tc.Clock()
            _assert_same(jc, tc)
        assert tc.recover_flag == jc.recover_flag == (modes != "verify")
        assert tc.recover_counts == jc.recover_counts and tc.max_phase_err == jc.max_phase_err
        assert ("XOR_BOOTSTRAPS" in tc.gate_counts) == (xor_mode == "compound")
    assert tc._state_ct is not None  # the DFF netlist latched its state


def test_cuda_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Circuit(set="MICRO", device="cuda")
