"""Compound XOR and DFF state in the port's ``Circuit`` against the JAX
package's main-path ``Circuit`` (MICRO_A device keys, interpret-mode
megakernel; keys, secret and a copy of its generator injected, as in
tests/test_torch_recovery.py).

``xor_mode="compound"``: each level's XOR/XNOR subset runs first as three
bootstraps with its own check, then the other gates; verify (clean and
with an induced repair) and recovery (default threshold, and a threshold
that repairs) match bit for bit on the host branch, ``XOR_BOOTSTRAPS``
included.  DFF state (tests/test_lut_dff.py's counter): plaintext cycles,
enable and ``Reset``, and encrypted verify cycles, bit for bit on the host
branch and in decryptions and counts on the device branch."""

import numpy as np
import pytest

from oece_tpu.circuits.gen import Builder, gen_adder
from oece_tpu.circuits.netlist import Op
from test_torch_recovery import assert_same, inputs, jax_circuit, shift_b, twin  # noqa: F401
from test_torch_std import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("induced", [False, True])
def test_compound_verify_matches_jax(jax_circuit, monkeypatch, induced):
    jc, kt = jax_circuit
    monkeypatch.setenv("OECE_LEVEL_JIT", "0")
    nl = gen_adder(4)
    tc = twin(jc, kt, nl, True, True, True, xor_mode="compound")
    T = 3
    ins = inputs(nl, T, seed=5)
    jc.SetInput(ins)
    tc.SetInput(ins)
    if induced:
        shift_b(jc, tc, int(nl.inputs[0][0]), 0, jc.params.q // 2)
    jc.Clock()
    tc.Clock()
    assert_same(jc, tc)
    n_xor = int(np.isin(nl.op, (int(Op.XOR), int(Op.XNOR))).sum())
    assert tc.gate_counts["XOR_BOOTSTRAPS"] == 3 * T * n_xor
    assert tc.trace.total_bootstraps == jc.trace.total_bootstraps
    assert (sum(tc.bad_gate_counts.values()) > 0) == induced
    a = (ins[0] << np.arange(4)).sum(1)
    b = (ins[1] << np.arange(4)).sum(1)
    (out,) = tc.GetOutput()
    np.testing.assert_array_equal((out << np.arange(5)).sum(1), a + b)


@pytest.mark.parametrize("threshold", [None, 2])
def test_compound_recovery_matches_jax(jax_circuit, monkeypatch, threshold):
    """Pure-encrypted compound runs with recovery; a threshold of 2 repairs
    outputs of the XOR subset and of the other gates, each check drawing
    its own fresh encryptions from the shared generator."""
    jc, kt = jax_circuit
    monkeypatch.setenv("OECE_LEVEL_JIT", "0")
    nl = gen_adder(4)
    tc = twin(jc, kt, nl, False, True, False, xor_mode="compound")
    for c in (jc, tc):
        c.setRecovery(True, threshold=threshold)
    ins = inputs(nl, 2, seed=6)
    jc.SetInput(ins)
    tc.SetInput(ins)
    jc.Clock()
    tc.Clock()
    assert_same(jc, tc)
    if threshold:
        assert tc.recover_counts.get("XOR", 0) > 0 and tc.recover_counts.get("AND", 0) > 0


def counter(width):
    """tests/test_lut_dff.py's width-bit synchronous counter: q += en."""
    b = Builder(f"counter{width}")
    (en,) = b.input_word(1)
    qs = [b.DFF() for _ in range(width)]
    carry = en
    for q in qs:
        d = b.XOR(q, carry)
        carry = b.AND(q, carry)
        b.dff_bind(q, d)
    b.output_word(qs)
    return b.build()


def read(c):
    return int(sum(int(v) << i for i, v in enumerate(c.GetOutput()[0][0])))


def test_dff_counter_plaintext_matches_jax(jax_circuit):
    jc, kt = jax_circuit
    tc = twin(jc, kt, counter(3), True, False, False)
    seen = []
    for _ in range(10):
        for c in (jc, tc):
            c.SetInput([np.array([[1]])])
            c.Clock()
        assert read(tc) == read(jc)
        seen.append(read(tc))
    assert seen == [0, 1, 2, 3, 4, 5, 6, 7, 0, 1]
    assert tc.gate_counts == jc.gate_counts


def test_dff_enable_and_reset_matches_jax(jax_circuit):
    jc, kt = jax_circuit
    tc = twin(jc, kt, counter(2), True, False, False)
    vals = []
    for en in [1, 0, 1, 1]:
        for c in (jc, tc):
            c.SetInput([np.array([[en]])])
            c.Clock()
        vals.append((read(tc), read(jc)))
    assert vals == [(0, 0), (1, 1), (1, 1), (2, 2)]
    for c in (jc, tc):
        c.Reset()  # the state clears
        c.SetInput([np.array([[1]])])
        c.Clock()
    assert read(tc) == read(jc) == 0


@pytest.mark.parametrize("branch", ["host", "device"])
def test_dff_counter_encrypted_matches_jax(jax_circuit, monkeypatch, branch):
    """Verify-mode cycles of the 2-bit counter: the latched ciphertexts go
    into the next cycle's arena after the input encryptions; after Reset
    the state is zero again.  Host branch bit for bit, device branch in
    decryptions, counts and the generator's state."""
    jc, kt = jax_circuit
    monkeypatch.setenv("OECE_LEVEL_JIT", "1" if branch == "device" else "0")
    tc = twin(jc, kt, counter(2), True, True, True)
    vals = []
    for cycle in range(5):
        if cycle == 4:
            for c in (jc, tc):
                c.Reset()
        for c in (jc, tc):
            c.SetInput([np.array([[1], [1]])])
            c.Clock()
        assert_same(jc, tc, arena=branch == "host")
        vals.append(read(tc))
    assert vals == [0, 1, 2, 3, 0]
    assert not tc.bad_gate_counts and tc._state_ct is not None
