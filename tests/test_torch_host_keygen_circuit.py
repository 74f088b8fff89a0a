"""The ``OECE_HOST_KEYGEN=1`` route of the port's ``Circuit`` on the CPU
against the JAX package's, bit for bit: golden host keys drawn from each
Circuit's own generator, packed as ginx_ext (port) and ginx_pallas (JAX,
Pallas kernels #1 and #4 in interpret mode)."""

import os

import numpy as np

from oece_tpu.fhe import boot as jboot
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu_torch.fhe import keys, rot, std
from oece_tpu_torch.runtime.evaluator import Circuit
from test_torch_context import _assert_same_keys

ADDER = os.path.join(
    os.path.dirname(__file__), "..", "examples", "simple_ckts", "adder_2bit", "adder_2bit.out"
)


def test_host_keygen_circuit_matches_jax(monkeypatch):
    """adder_2bit in verify mode at MICRO, keys from each Circuit's own
    generator under OECE_HOST_KEYGEN=1: the JAX Circuit runs Pallas #1/#4
    in interpret mode on ginx_pallas keys, the port the plain standard
    form on ginx_ext keys."""
    monkeypatch.setenv("OECE_HOST_KEYGEN", "1")
    monkeypatch.setattr(jboot, "PALLAS_INTERPRET", True)
    jc = JaxCircuit(set="MICRO", method="GINX", seed=19)
    assert jc.dkeys.ginx_pallas is not None
    tc = Circuit(set="MICRO", method="GINX", seed=19, device="cpu")
    assert tc.keys.ginx_ext is not None and tc.keys.rev2 is None
    _assert_same_keys(tc.keys, keys.from_jax(jc.dkeys))
    np.testing.assert_array_equal(tc.sk.s, jc.sk.s)
    jc.ReadFile(ADDER)
    tc.ReadFile(ADDER)
    rng = np.random.default_rng(3)
    ins = [rng.integers(0, 2, (6, 2)) for _ in range(2)]
    for c in (jc, tc):
        c.setVerify(True)
        c.SetInput(ins)
    np.testing.assert_array_equal(tc._ct_arena.numpy(), np.asarray(jc._ct_arena))
    launches = (std.PLAIN_LAUNCHES, rot.PLAIN_LAUNCHES)
    jc.Clock()
    tc.Clock()
    assert std.PLAIN_LAUNCHES > launches[0] and rot.PLAIN_LAUNCHES == launches[1]
    for a, b in zip(jc.GetOutput(), tc.GetOutput()):
        np.testing.assert_array_equal(a, b)
    (out,) = tc.GetOutput()
    sums = (out << np.arange(out.shape[1])).sum(1)
    x, y = [(w << np.arange(2)).sum(1) for w in ins]
    np.testing.assert_array_equal(sums, x + y)
    assert tc.bad_gate_counts == jc.bad_gate_counts
    assert tc.gate_counts == jc.gate_counts
    np.testing.assert_array_equal(tc._ct_arena.numpy(), np.asarray(jc._ct_arena))
