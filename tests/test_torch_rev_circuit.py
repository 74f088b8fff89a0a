"""The port's ``Circuit`` under ``OECE_LAYOUT=rev`` on the CPU against the
JAX package's (device-keygen ginx_rev keys, its prebuilt-step scan with
Pallas #9 and #10 in interpret mode): with the JAX circuit's keys, secret
and a copy of its generator injected, whole verify runs agree bit for bit
(ciphertext arena, outputs, gate counts, verify repairs).  The port's own
keygen follows ``OECE_LAYOUT`` as the JAX ``Circuit`` does."""

import numpy as np
import pytest

from oece_tpu.fhe import boot as jboot
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu_torch.fhe import keys, rev, rot
from oece_tpu_torch.runtime.evaluator import Circuit
from test_torch_evaluator import ADDER, CIRCUITS, _assert_same, _inputs, _twin


@pytest.fixture(scope="module", params=["MICRO_A", "MICRO"])
def jax_rev_circuit(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("OECE_FORCE_DEVICE_KEYGEN", "1")
    mp.setenv("OECE_LAYOUT", "rev")
    mp.setattr(jboot, "PALLAS_INTERPRET", True)
    jc = JaxCircuit(set=request.param, method="GINX", seed=5)
    assert jc.dkeys.ginx_rev is not None
    yield jc, keys.from_jax(jc.dkeys)
    mp.undo()


@pytest.mark.parametrize("name", ["adder_2bit", "adder4"])
def test_rev_verify_run_matches_jax(jax_rev_circuit, name):
    jc, kt = jax_rev_circuit
    build, T = CIRCUITS[name]
    nl = build()
    tc = _twin(jc, kt, nl, True, True, True)
    ins = _inputs(nl, T, seed=len(name))
    jc.SetInput(ins)
    tc.SetInput(ins)
    plain0, rot0 = rev.PLAIN_LAUNCHES, rot.PLAIN_LAUNCHES
    jc.Clock()
    tc.Clock()
    _assert_same(jc, tc)
    assert rev.PLAIN_LAUNCHES > plain0 and rot.PLAIN_LAUNCHES == rot0  # only the rev rotation


def test_rev_induced_repair_matches_jax(jax_rev_circuit):
    """+q/2 on one input's b flips the gates reading it: verify repairs them
    from the shared generator in the same order on both sides."""
    jc, kt = jax_rev_circuit
    build, T = CIRCUITS["adder_2bit"]
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


def test_port_keygen_follows_oece_layout(monkeypatch):
    monkeypatch.setenv("OECE_LAYOUT", "rev")
    c = Circuit(set="MICRO_A", seed=3, device="cpu")
    assert c.keys.rev is not None and c.keys.rev2 is None
    c.ReadFile(ADDER)
    c.setVerify(True)
    cases = [(x, y) for x in range(4) for y in range(4)]
    c.SetInput([np.array([[x & 1, x >> 1] for x, _ in cases]),
                np.array([[y & 1, y >> 1] for _, y in cases])])
    plain0 = rev.PLAIN_LAUNCHES
    c.Clock()
    assert rev.PLAIN_LAUNCHES > plain0
    (out,) = c.GetOutput()
    np.testing.assert_array_equal((out << np.arange(out.shape[1])).sum(1), [x + y for x, y in cases])
    monkeypatch.setenv("OECE_LAYOUT", "rev1")
    with pytest.raises(ValueError, match="unknown GINX key layout"):
        Circuit(set="MICRO", seed=1, device="cpu")
    monkeypatch.delenv("OECE_LAYOUT")
    c2 = Circuit(set="MICRO", seed=1, device="cpu")
    assert c2.keys.rev2 is not None and c2.keys.rev is None  # the default stays rev2
