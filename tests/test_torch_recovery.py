"""Recovery in the port's ``Circuit`` against the JAX package's main-path
``Circuit`` (device-keygen rev2 keys at MICRO_A, the rotation megakernel
in interpret mode), with its keys, secret and a copy of its generator
injected.

Host branch (``OECE_LEVEL_JIT=0``, the CPU's default), bit for bit:
``_recover_fix`` on crafted drifted and broken ciphertexts, and whole
pure-encrypted runs with automatic recovery, with a threshold low enough
to repair, and with recovery opted out by ``setRecovery(False)`` and by
``OECE_AUTO_RECOVER=0``: ciphertext arena, outputs, counts, worst margin
and the generator's state afterwards.

Device branch (``OECE_LEVEL_JIT=1`` on both sides): the port's device
checks against the JAX package's fused level program, which draws from
another generator, so decryptions and repair counts must agree (the
ciphertexts only up to the first repair), and the host generator must end
in the same state.  ``lwe.encrypt_bits_dev`` is checked on its own."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.circuits.asm import parse_asm
from oece_tpu.circuits.gen import gen_adder
from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import lwe as jlwe
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu_torch.fhe import keys, lwe
from oece_tpu_torch.fhe.golden import LWESecretKey
from oece_tpu_torch.fhe.params import get_params
from oece_tpu_torch.runtime.evaluator import Circuit
from test_torch_std import one_torch_thread  # noqa: F401

ADDER = os.path.join(
    os.path.dirname(__file__), "..", "examples", "simple_ckts", "adder_2bit", "adder_2bit.out"
)


@pytest.fixture(scope="module")
def jax_circuit():
    mp = pytest.MonkeyPatch()
    mp.setenv("OECE_FORCE_DEVICE_KEYGEN", "1")
    mp.setattr(jboot, "PALLAS_INTERPRET", True)
    jc = JaxCircuit(set="MICRO_A", method="GINX", seed=41)
    yield jc, keys.from_jax(jc.dkeys)
    mp.undo()


def twin(jc, kt, nl, plaintext, encrypted, verify, xor_mode="native"):
    """The port's Circuit on the JAX circuit's keys, secret and a copy of
    its generator, both loaded with ``nl`` and set to the same modes."""
    jc.LoadNetlist(nl)
    jc.recover_flag, jc._recover_explicit = False, False
    jc.recover_threshold = jc.params.q // 16
    jc.xor_mode = xor_mode
    jc._jax_key = None  # its device key is drawn anew, as the port's generator
    sk = LWESecretKey(s=jc.sk.s, params=kt.params)
    tc = Circuit(set=jc.params.name, device="cpu", keys=kt, sk=sk, rng=copy.deepcopy(jc._rng),
                 xor_mode=xor_mode)
    tc.LoadNetlist(nl)
    for c in (jc, tc):
        c.setPlaintext(plaintext)
        c.setEncrypted(encrypted)
        c.setVerify(verify)
    return tc


def inputs(nl, T, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, (T, len(w))) for w in nl.inputs]


def shift_b(jc, tc, wire: int, case: int, amount: int) -> None:
    """Add ``amount`` to the b of one input ciphertext on both sides."""
    slot = int(jc._slot[wire])
    jc._ct_arena = jc._ct_arena.at[slot, case, -1].add(amount)
    tc._ct_arena[slot, case, -1] += amount


def assert_same(jc, tc, arena=True, margin=True):
    """Outputs, every count, the generator's state and (host branch) the
    ciphertext arena and worst margin."""
    assert len(jc.GetOutput()) == len(tc.GetOutput())
    for a, b in zip(jc.GetOutput(), tc.GetOutput()):
        np.testing.assert_array_equal(a, b)
    assert tc.gate_counts == jc.gate_counts
    assert tc.bad_gate_counts == jc.bad_gate_counts
    assert tc.bad_gate_levels == jc.bad_gate_levels
    assert tc.recover_counts == jc.recover_counts
    assert tc.recover_flag == jc.recover_flag
    assert tc._rng.bit_generator.state == jc._rng.bit_generator.state
    if margin:
        assert tc.max_phase_err == jc.max_phase_err
    if arena:
        np.testing.assert_array_equal(tc._ct_arena.numpy(), np.asarray(jc._ct_arena))


def sums(c):
    (out,) = c.GetOutput()
    return list((out << np.arange(out.shape[1])).sum(1))


@pytest.mark.parametrize("case", ["drift", "hard"])
def test_recover_fix_matches_jax(jax_circuit, case):
    """tests/test_recovery.py's crafted ciphertexts through both
    ``_recover_fix``: a drift of 28 (above q/16, below q/8) is repaired to
    the same bits with fresh encryptions from the shared generator; a phase
    near q/2 counts as HARD."""
    jc, kt = jax_circuit
    tc = twin(jc, kt, gen_adder(2), False, True, False)
    q, n = jc.params.q, jc.params.n
    rng = np.random.default_rng(1)
    B = 8
    if case == "drift":
        bits = rng.integers(0, 2, B)
        a = rng.integers(0, q, (B, n))
        b = (a @ np.asarray(jc.sk.s, np.int64) + bits * (q // 4) + 28) % q
        cts = np.concatenate([a, b[:, None]], axis=1).astype(np.int32)
    else:
        bits = np.zeros(B, np.int64)
        cts = jlwe.encrypt_bits(jc.sk, bits, rng)
        cts[:, -1] = (cts[:, -1] + q // 2) % q
    ops = np.zeros(B, np.int64)
    jc._batch = tc._batch = 1
    jout = jc._recover_fix(ops, jnp.asarray(cts)[:, None, :])
    tout = tc._recover_fix(ops, torch.from_numpy(cts)[:, None, :])
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tc.recover_counts == jc.recover_counts
    assert tc.max_phase_err == jc.max_phase_err
    assert tc._rng.bit_generator.state == jc._rng.bit_generator.state
    if case == "drift":
        assert tc.recover_counts == {"AND": B} and tc.max_phase_err == 28
        got = jlwe.decrypt_bits(jc.sk, tout.numpy().reshape(B, -1))
        np.testing.assert_array_equal(got, bits)
    else:
        assert tc.recover_counts.get("HARD") == B


@pytest.mark.parametrize("mode", ["auto", "threshold", "setRecovery(False)", "OECE_AUTO_RECOVER=0"])
def test_pure_encrypted_recovery_matches_jax(jax_circuit, monkeypatch, mode):
    """Pure-encrypted adder runs on the host branch: recovery switched on
    at Clock() by default, on with a threshold of 2 (below the bootstraps'
    own noise, so it repairs and draws from the generator), and opted out
    both ways; the JAX package's runs bit for bit."""
    jc, kt = jax_circuit
    monkeypatch.setenv("OECE_LEVEL_JIT", "0")
    monkeypatch.setenv("OECE_AUTO_RECOVER", "0" if mode == "OECE_AUTO_RECOVER=0" else "1")
    nl = gen_adder(4)
    tc = twin(jc, kt, nl, False, True, False)
    for c in (jc, tc):
        if mode == "threshold":
            c.setRecovery(True, threshold=2)
        elif mode == "setRecovery(False)":
            c.setRecovery(False)
    ins = inputs(nl, 3, seed=2)
    jc.SetInput(ins)
    tc.SetInput(ins)
    jc.Clock()
    tc.Clock()
    assert_same(jc, tc)
    assert tc.recover_flag == (mode in ("auto", "threshold"))
    if mode == "threshold":
        assert sum(tc.recover_counts.values()) > 0
    if tc.recover_flag:
        assert tc.max_phase_err > 0
    a = (ins[0] << np.arange(4)).sum(1)
    b = (ins[1] << np.arange(4)).sum(1)
    assert sums(tc) == list(a + b)


@pytest.mark.parametrize("T", [1, 3])
def test_device_verify_repair_matches_jax(jax_circuit, monkeypatch, T):
    """tests/test_evaluator.py's induced failure (b + q/2 on one input of
    case 0) under OECE_LEVEL_JIT=1: the device checks repair the same
    gates at the same levels as the JAX package's fused program."""
    jc, kt = jax_circuit
    monkeypatch.setenv("OECE_LEVEL_JIT", "1")
    nl = parse_asm(ADDER)
    tc = twin(jc, kt, nl, True, True, True)
    ins = [np.array([[1, 0], [0, 1], [1, 1]])[:T], np.array([[1, 1], [1, 0], [0, 1]])[:T]]
    jc.SetInput(ins)
    tc.SetInput(ins)
    shift_b(jc, tc, int(nl.inputs[0][0]), 0, jc.params.q // 2)
    jc.Clock()
    tc.Clock()
    assert tc._dev_branch
    assert_same(jc, tc, arena=False)
    assert tc.bad_gate_counts and tc.bad_gate_levels
    assert sum(sum(d.values()) for d in tc.bad_gate_levels.values()) == sum(tc.bad_gate_counts.values())
    assert sums(tc) == [1 + 3, 2 + 1, 3 + 2][:T]


@pytest.mark.parametrize("drift", [False, True])
def test_device_recovery_matches_jax(jax_circuit, monkeypatch, drift):
    """tests/test_recovery.py's input-side case under OECE_LEVEL_JIT=1: a
    drift of q/12 on one input is caught on the prep and re-encrypted
    before its bootstrap (IN_* counts), as the JAX package's fused program
    does; without it no repair."""
    jc, kt = jax_circuit
    monkeypatch.setenv("OECE_LEVEL_JIT", "1")
    nl = parse_asm(ADDER)
    tc = twin(jc, kt, nl, False, True, False)
    for c in (jc, tc):
        c.setRecovery(True)
    ins = [np.array([[1, 0]]), np.array([[1, 1]])]
    jc.SetInput(ins)
    tc.SetInput(ins)
    if drift:
        shift_b(jc, tc, int(nl.inputs[0][0]), 0, jc.params.q // 12)
    jc.Clock()
    tc.Clock()
    assert_same(jc, tc, arena=False, margin=False)
    assert tc.max_phase_err > 0
    assert any(k.startswith("IN_") for k in tc.recover_counts) == bool(drift)
    assert sums(tc) == [1 + 3]


def test_encrypt_bits_dev():
    """m in 0..3 decrypts to its quarter with |e| within 6 sigma; the same
    generator seed gives the same ciphertexts, another seed others."""
    p = get_params("MICRO")
    s = torch.from_numpy(np.random.default_rng(0).integers(-1, 2, p.n)).to(torch.int32)
    m = torch.arange(4096) % 4

    def enc(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return lwe.encrypt_bits_dev(s, m, g, p)

    ct = enc(7)
    assert ct.dtype == torch.int32 and ct.shape == (4096, p.n + 1)
    assert int(ct.min()) >= 0 and int(ct.max()) < p.q
    phase = lwe.phase_dev(s, ct, p.q)
    np.testing.assert_array_equal((((phase + p.q // 8) // (p.q // 4)) % 4).numpy(), m.numpy())
    e = (phase - m * (p.q // 4) + p.q // 2) % p.q - p.q // 2
    assert int(e.abs().max()) <= 6 * p.sigma and float(e.float().std()) > p.sigma / 2
    torch.testing.assert_close(enc(7), ct, rtol=0, atol=0)
    assert not torch.equal(enc(8), ct)
    bits = lwe.decrypt_bits_dev(s, ct[m < 2], p.q)
    np.testing.assert_array_equal(bits.numpy(), m[m < 2].numpy())
