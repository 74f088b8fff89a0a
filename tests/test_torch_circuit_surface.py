"""The parts of the JAX package's ``Circuit`` surface that the port honours
or refuses by name: ``OECE_AUTO_RECOVER=0`` runs pure-encrypted circuits
with recovery off and ``=1`` with it on, as the JAX package does, bit for
bit; ``generate_keys``
skips key generation; ``mesh=`` and ``setMesh`` refuse anything but a
parallel.mesh.Mesh, the checkpoint arguments of ``Clock`` run and leave
no file behind, and ``OECE_BAD_TRACE=1`` records the verify repairs'
lanes (each once raised NotImplementedError; tests/test_torch_mesh.py,
test_torch_checkpoint.py and test_torch_bad_trace.py hold them to the JAX
package)."""

import copy

import numpy as np
import pytest

from oece_tpu.circuits.gen import gen_adder
from oece_tpu.fhe import boot as jboot
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu_torch.fhe import keys
from oece_tpu_torch.fhe.golden import LWESecretKey
from oece_tpu_torch.runtime.evaluator import Circuit


@pytest.fixture(scope="module")
def jax_circuit():
    """One JAX main-path circuit at MICRO_A (device keygen, interpret-mode
    megakernel) and its keys in the port's form."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OECE_FORCE_DEVICE_KEYGEN", "1")
    mp.setattr(jboot, "PALLAS_INTERPRET", True)
    jc = JaxCircuit(set="MICRO_A", method="GINX", seed=7)
    yield jc, keys.from_jax(jc.dkeys)
    mp.undo()


def _inputs(nl, T, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, (T, len(w))) for w in nl.inputs]


def test_auto_recover_off_matches_jax(jax_circuit, monkeypatch):
    """A pure-encrypted Clock() under OECE_AUTO_RECOVER=0, without
    setRecovery: the JAX package runs it with recovery off, and so does the
    port, with the same ciphertexts and decryptions."""
    jc, kt = jax_circuit
    monkeypatch.setenv("OECE_AUTO_RECOVER", "0")
    nl = gen_adder(4)
    jc.LoadNetlist(nl)
    tc = Circuit(set="MICRO_A", device="cpu", keys=kt, sk=LWESecretKey(s=jc.sk.s, params=kt.params),
                 rng=copy.deepcopy(jc._rng))
    tc.LoadNetlist(nl)
    for c in (jc, tc):
        c.setPlaintext(False)
        c.setEncrypted(True)
    ins = _inputs(nl, 3, seed=9)
    jc.SetInput(ins)
    tc.SetInput(ins)
    jc.Clock()
    tc.Clock()
    assert not jc.recover_flag
    for a, b in zip(jc.GetOutput(), tc.GetOutput()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tc._ct_arena.numpy(), np.asarray(jc._ct_arena))
    a = (ins[0] << np.arange(4)).sum(1)
    b = (ins[1] << np.arange(4)).sum(1)
    np.testing.assert_array_equal((tc.GetOutput()[0] << np.arange(5)).sum(1), a + b)


def test_auto_recover_on_still_raises(jax_circuit, monkeypatch):
    """A pure-encrypted Clock() under OECE_AUTO_RECOVER=1, without
    setRecovery: both packages switch recovery on at Clock() and run the
    host branch's output-side margin checks, bit for bit (it used to
    raise in the port)."""
    jc, kt = jax_circuit
    monkeypatch.setenv("OECE_AUTO_RECOVER", "1")
    monkeypatch.delenv("OECE_LEVEL_JIT", raising=False)
    nl = gen_adder(4)
    jc.LoadNetlist(nl)
    jc.recover_flag, jc._recover_explicit = False, False
    tc = Circuit(set="MICRO_A", device="cpu", keys=kt, sk=LWESecretKey(s=jc.sk.s, params=kt.params),
                 rng=copy.deepcopy(jc._rng))
    tc.LoadNetlist(nl)
    for c in (jc, tc):
        c.setPlaintext(False)
        c.setEncrypted(True)
    ins = _inputs(nl, 3, seed=10)
    jc.SetInput(ins)
    tc.SetInput(ins)
    assert not tc.recover_flag
    jc.Clock()
    tc.Clock()
    assert jc.recover_flag and tc.recover_flag
    for a, b in zip(jc.GetOutput(), tc.GetOutput()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tc._ct_arena.numpy(), np.asarray(jc._ct_arena))
    assert tc.recover_counts == jc.recover_counts and tc.max_phase_err == jc.max_phase_err > 0
    assert tc._rng.bit_generator.state == jc._rng.bit_generator.state


def test_bad_trace_raises(monkeypatch):
    """OECE_BAD_TRACE=1 fills the lane trace in verify mode (it used to
    raise): one record per repaired lane."""
    monkeypatch.setenv("OECE_BAD_TRACE", "1")
    c = Circuit(set="MICRO", seed=1, device="cpu")
    nl = gen_adder(2)
    c.LoadNetlist(nl)
    c.setVerify(True)
    c.SetInput(_inputs(nl, 2, seed=1))
    c.Clock()
    assert len(c.bad_gate_lanes) == sum(c.bad_gate_counts.values())
    c.Reset()
    c.setVerify(False)  # plaintext only: the JAX package ignores the variable
    c.setEncrypted(False)
    c.SetInput(_inputs(nl, 2, seed=1))
    c.Clock()


def test_mesh_and_checkpoint_raise(tmp_path):
    """A mesh that is not a parallel.mesh.Mesh is refused (a Mesh once
    raised NotImplementedError); checkpointing runs and removes its file
    when the evaluation ends."""
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        Circuit(set="MICRO", seed=1, device="cpu", mesh=object())
    c = Circuit(set="MICRO", seed=1, device="cpu", mesh=None)
    c.setMesh(None)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        c.setMesh(object())
    nl = gen_adder(2)
    c.LoadNetlist(nl)
    c.setEncrypted(False)
    c.SetInput(_inputs(nl, 2, seed=2))
    ck = tmp_path / "ckpt.npz"
    c.Clock(checkpoint_path=str(ck), checkpoint_every=1)
    assert c.GetOutput() and not ck.exists()
    c.Reset()
    c.SetInput(_inputs(nl, 2, seed=2))
    c.Clock(checkpoint_path=None, checkpoint_every=0)
    assert c.GetOutput()


def test_generate_keys_false_matches_jax():
    """generate_keys=False skips key generation in both packages: a
    plaintext run needs no keys and gives the JAX package's outputs; keys
    can still be injected."""
    nl = gen_adder(3)
    ins = _inputs(nl, 5, seed=3)
    jc = JaxCircuit(set="MICRO", seed=2, generate_keys=False)
    tc = Circuit(set="MICRO", seed=2, device="cpu", generate_keys=False)
    assert jc.sk is None and tc.sk is None and tc.keys is None
    for c in (jc, tc):
        c.LoadNetlist(nl)
        c.SetInput(ins)
        c.Clock()
    for a, b in zip(jc.GetOutput(), tc.GetOutput()):
        np.testing.assert_array_equal(a, b)
    tc.Reset()
    tc.setEncrypted(True)
    with pytest.raises(RuntimeError, match="no keys"):
        tc.SetInput(ins)
