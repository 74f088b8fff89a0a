"""``OECE_BAD_TRACE=1`` in the port's ``Circuit``: every verify repair's
lane (level, lane, case, op, wire, cycle), on both check branches.

tests/test_evaluator.py's lane test (adder_2bit at MICRO, case 1 of 2
corrupted by q/2 on one input bit) against the JAX package's Circuit on
the same keys (``OECE_HOST_KEYGEN=1`` draws them from the same seed): the
same records, bit for bit, once the port's ``cycle`` tag is set aside.
Under ``xor_mode="compound"`` the lanes are the gates' places in their
level's bootstrap order, also for the XOR subset that runs first (the JAX
package indexes that subset there, so it is not compared); every record
must sit in the corrupted case and read the corrupted wire, and a
sequential circuit tags each record with its Clock() cycle."""

import os

import numpy as np
import pytest

from oece_tpu.circuits.asm import parse_asm as jparse_asm
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu_torch.circuits.asm import parse_asm
from oece_tpu_torch.circuits.gen import Builder
from oece_tpu_torch.circuits.netlist import Op
from oece_tpu_torch.runtime.evaluator import Circuit

ADDER = os.path.join(
    os.path.dirname(__file__), "..", "examples", "simple_ckts", "adder_2bit", "adder_2bit.out"
)
IN1 = np.array([[1, 0], [0, 1]])
IN2 = np.array([[1, 1], [1, 0]])


def unbits(b):
    return (np.asarray(b) << np.arange(b.shape[1])).sum(1)


def _corrupted(c, w, in2=IN2):
    c.setVerify(True)
    c.SetInput([IN1, in2])
    slot = int(c._slot[w])
    if isinstance(c, JaxCircuit):
        c._ct_arena = c._ct_arena.at[slot, 1, -1].add(c.params.q // 2)
    else:
        c._ct_arena[slot, 1, -1] += c.params.q // 2


def _check_lanes(c, w, cycle=0):
    assert c.bad_gate_lanes, "the lane trace must record the induced repairs"
    assert len(c.bad_gate_lanes) == sum(c.bad_gate_counts.values())
    for rec in c.bad_gate_lanes:
        assert rec["case"] == 1 and rec["cycle"] == cycle, rec  # only case 1 was corrupted
        level = c.plan.levels[rec["level"]]
        assert rec["wire"] == int(level["boot_out"][rec["lane"]])
        assert rec["op"] == Op(int(level["boot_op"][rec["lane"]])).name
        ins = (int(level["boot_in0"][rec["lane"]]), int(level["boot_in1"][rec["lane"]]))
        assert w in ins, (rec, ins)  # the repaired gate reads the corrupted wire


@pytest.mark.parametrize("level_jit", [False, True])
def test_verify_repair_localized_by_lane(monkeypatch, level_jit):
    monkeypatch.setenv("OECE_LEVEL_JIT", "1" if level_jit else "0")
    monkeypatch.setenv("OECE_BAD_TRACE", "1")
    monkeypatch.setenv("OECE_HOST_KEYGEN", "1")
    jc = JaxCircuit(set="MICRO", method="GINX", seed=31)
    jc.LoadNetlist(jparse_asm(ADDER))
    tc = Circuit(set="MICRO", method="GINX", seed=31, device="cpu")
    tc.LoadNetlist(parse_asm(ADDER))
    w = int(tc.netlist.inputs[0][0])
    for c in (jc, tc):
        _corrupted(c, w)
        c.Clock()
    (out,) = tc.GetOutput()
    assert list(unbits(out)) == [1 + 3, 2 + 1]
    assert tc._dev_branch == level_jit
    _check_lanes(tc, w)
    assert [{k: v for k, v in r.items() if k != "cycle"} for r in tc.bad_gate_lanes] == jc.bad_gate_lanes
    assert tc.bad_gate_counts == jc.bad_gate_counts


@pytest.mark.parametrize("level_jit", [False, True])
def test_compound_xor_lanes(monkeypatch, level_jit):
    """The corrected decode: under compound XOR the XOR/XNOR subset of a
    level runs first, and its records still name the level's lane, op and
    wire.  In case 1 both bit-0 inputs are 0, so the compound XOR of the
    corrupted input goes wrong (both of its ANDs read 1) and is repaired."""
    monkeypatch.setenv("OECE_LEVEL_JIT", "1" if level_jit else "0")
    monkeypatch.setenv("OECE_BAD_TRACE", "1")
    tc = Circuit(set="MICRO", method="GINX", seed=31, device="cpu", xor_mode="compound")
    tc.LoadNetlist(parse_asm(ADDER))
    w = int(tc.netlist.inputs[0][0])
    _corrupted(tc, w, in2=np.array([[1, 1], [0, 1]]))
    tc.Clock()
    assert list(unbits(tc.GetOutput()[0])) == [1 + 3, 2 + 2]
    _check_lanes(tc, w)
    assert any(r["op"] in ("XOR", "XNOR") for r in tc.bad_gate_lanes)


@pytest.mark.parametrize("level_jit", [False, True])
def test_cycle_tags(monkeypatch, level_jit):
    """A 2-bit DFF counter in verify mode: the repairs of the cycle whose
    state input was corrupted carry that cycle's tag."""
    monkeypatch.setenv("OECE_LEVEL_JIT", "1" if level_jit else "0")
    monkeypatch.setenv("OECE_BAD_TRACE", "1")
    bld = Builder("counter2")
    (en,) = bld.input_word(1)
    qs = [bld.DFF() for _ in range(2)]
    carry = en
    for q in qs:
        d = bld.XOR(q, carry)
        carry = bld.AND(q, carry)
        bld.dff_bind(q, d)
    bld.output_word(qs)
    c = Circuit(set="MICRO", seed=5, device="cpu")
    c.LoadNetlist(bld.build())
    c.setVerify(True)
    for cycle in range(3):
        c.SetInput([np.array([[1], [1]])])
        if cycle == 2:
            slot = int(c._slot[int(c.netlist.inputs[0][0])])
            c._ct_arena[slot, 1, -1] += c.params.q // 2
        c.Clock()
    assert c.bad_gate_lanes and all(r["cycle"] == 2 and r["case"] == 1 for r in c.bad_gate_lanes)
    assert [int(unbits(o)[0]) for o in c.GetOutput()] == [2]  # the state before the third latch
