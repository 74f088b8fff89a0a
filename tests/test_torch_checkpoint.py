"""Mid-circuit checkpoint and resume in the port's ``Circuit``
(runtime/checkpoint.py): tests/test_checkpoint.py's three tests on both
check branches (``OECE_LEVEL_JIT=0`` the host branch, ``=1`` the device
branch), and a resumed run against the JAX package's uninterrupted one.

A resumed run must equal an uninterrupted one bit for bit, on both
branches: outputs, the ciphertext arena, the repair counts (by op and by
level), the lane trace, and the generators' states (numpy's, and the
device branch's torch.Generator).  One input of case 1 is shifted by q/2,
so verify repairs happen before the interruption (level 1) and their
counts, lanes and re-encryptions must survive it."""

import json
import os

import numpy as np
import pytest
import torch

from oece_tpu.circuits.gen import gen_adder as jgen_adder
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu_torch.circuits.gen import gen_adder
from oece_tpu_torch.runtime import checkpoint as ck_mod
from oece_tpu_torch.runtime.evaluator import Circuit


class Boom(RuntimeError):
    pass


@pytest.fixture(params=["0", "1"], ids=["host", "device"])
def branch(request, monkeypatch):
    monkeypatch.setenv("OECE_LEVEL_JIT", request.param)
    monkeypatch.setenv("OECE_BAD_TRACE", "1")
    return request.param


def _mk(seed=3, bits=4):
    c = Circuit(set="MICRO", method="GINX", seed=seed, device="cpu")
    c.LoadNetlist(gen_adder(bits))
    c.setVerify(True)
    return c


def _inputs():
    return [np.array([[1, 0, 1, 0], [0, 1, 1, 1]]), np.array([[1, 1, 0, 0], [1, 1, 1, 1]])]


def _corrupt(c):
    """b of input bit 0, case 1, shifted by q/2: its first consumers repair."""
    slot = int(c._slot[int(c.netlist.inputs[0][0])])
    c._ct_arena[slot, 1, -1] += c.params.q // 2


def _fail_before(c, level):
    """Make c's Clock() raise Boom before it runs ``level``; returns the
    real per-level method."""
    real_run = c._run_level

    def failing(lv):
        if c._cur_level == level:
            raise Boom()
        real_run(lv)

    c._run_level = failing
    return real_run


def _interrupted(c, ck, fail_at=2, every=1):
    """Clock() with a checkpoint every ``every`` levels, raising before
    level ``fail_at``; then Clock() again, which resumes."""
    real_run = _fail_before(c, fail_at)
    with pytest.raises(Boom):
        c.Clock(checkpoint_path=ck, checkpoint_every=every)
    assert os.path.exists(ck)
    c._run_level = real_run
    c.Clock(checkpoint_path=ck, checkpoint_every=every)
    assert not os.path.exists(ck)  # removed when the evaluation completed


def _assert_same_run(got, want):
    for a, b in zip(got.GetOutput(), want.GetOutput()):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(got._ct_arena, want._ct_arena)
    assert got.gate_counts == want.gate_counts
    assert got.bad_gate_counts == want.bad_gate_counts
    assert got.bad_gate_levels == want.bad_gate_levels
    assert got.bad_gate_lanes == want.bad_gate_lanes
    assert got._bootstraps_run == want._bootstraps_run
    assert got._rng.bit_generator.state == want._rng.bit_generator.state
    if want._gen is not None:
        assert torch.equal(got._gen.get_state(), want._gen.get_state())


def test_checkpoint_resume_matches_uninterrupted(tmp_path, branch):
    ck = str(tmp_path / "state.npz")
    ref = _mk()
    ref.SetInput(_inputs())
    _corrupt(ref)
    ref.Clock()
    assert sum(ref.bad_gate_counts.values()) > 0 and ref.bad_gate_lanes

    c = _mk()
    c.SetInput(_inputs())
    _corrupt(c)
    _interrupted(c, ck)
    assert c._dev_branch == (branch == "1")
    _assert_same_run(c, ref)
    # the resumed trace covers the remaining levels only
    assert c.trace.records[0].level == 2


def test_checkpoint_fingerprint_mismatch_ignored(tmp_path, branch):
    ck = str(tmp_path / "state.npz")
    c = _mk()
    c.SetInput(_inputs())
    _fail_before(c, 3)
    with pytest.raises(Boom):
        c.Clock(checkpoint_path=ck, checkpoint_every=1)
    assert os.path.exists(ck)
    # a different circuit must not resume from this checkpoint
    c2 = _mk(bits=5)
    c2.SetInput([np.array([[1, 0, 1, 0, 1]]), np.array([[1, 1, 0, 0, 1]])])
    assert ck_mod.maybe_resume(c2, ck) == 0
    # nor the same circuit on the other check branch (another generator)
    c3 = _mk()
    c3.SetInput(_inputs())
    c3._dev_branch = branch != "1"
    assert ck_mod.maybe_resume(c3, ck) == 0
    c3._dev_branch = branch == "1"
    c3._n_ct_slots += 1  # another slot map
    assert ck_mod.maybe_resume(c3, ck) == 0
    c3._n_ct_slots -= 1
    assert ck_mod.maybe_resume(c3, ck) == 3


def test_checkpoint_other_keys_or_modes_ignored(tmp_path, branch):
    """The same circuit, batch and flags under other keys (another seed),
    another XOR mode or another recovery setting must not resume: the
    saved ciphertexts would decrypt wrongly, or the gate and repair counts
    of two modes would mix."""
    ck = str(tmp_path / "state.npz")
    c = _mk()
    c.SetInput(_inputs())
    _fail_before(c, 3)
    with pytest.raises(Boom):
        c.Clock(checkpoint_path=ck, checkpoint_every=1)
    other_keys = _mk(seed=4)
    other_keys.SetInput(_inputs())
    assert ck_mod.maybe_resume(other_keys, ck) == 0
    compound = Circuit(set="MICRO", method="GINX", seed=3, device="cpu", xor_mode="compound")
    compound.LoadNetlist(gen_adder(4))
    compound.setVerify(True)
    compound.SetInput(_inputs())
    assert ck_mod.maybe_resume(compound, ck) == 0
    recover = _mk()
    recover.SetInput(_inputs())
    recover.setRecovery(True)
    assert ck_mod.maybe_resume(recover, ck) == 0
    same = _mk()
    same.SetInput(_inputs())
    same._dev_branch = c._dev_branch
    assert ck_mod.maybe_resume(same, ck) == 3


def test_trace_records_and_json(tmp_path, branch):
    c = _mk()
    c.SetInput(_inputs())
    c.Clock()
    tr = c.trace
    assert tr.mode == "verify"
    assert len(tr.records) == len(c.plan.levels)
    assert tr.total_bootstraps == c._bootstraps_run > 0
    doc = json.loads(tr.dump_json(str(tmp_path / "trace.json")))
    assert doc["summary"]["total_bootstraps"] == tr.total_bootstraps
    assert len(doc["levels"]) == len(tr.records)


@pytest.mark.parametrize("every", [1, 3])
def test_resumed_run_matches_jax(tmp_path, branch, monkeypatch, every):
    """The JAX package's uninterrupted Circuit (host golden keys, seed 3)
    against the port's interrupted and resumed one on the same keys
    (OECE_HOST_KEYGEN=1 draws them from the same generator): the host
    branch bit for bit, the device branch in outputs and counts."""
    monkeypatch.setenv("OECE_HOST_KEYGEN", "1")
    jc = JaxCircuit(set="MICRO", method="GINX", seed=3)
    jc.LoadNetlist(jgen_adder(4))
    jc.setVerify(True)
    jc.SetInput(_inputs())
    slot = int(jc._slot[int(jc.netlist.inputs[0][0])])
    jc._ct_arena = jc._ct_arena.at[slot, 1, -1].add(jc.params.q // 2)
    jc.Clock()
    c = _mk()
    c.SetInput(_inputs())
    _corrupt(c)
    _interrupted(c, str(tmp_path / "state.npz"), fail_at=4, every=every)
    for a, b in zip(c.GetOutput(), jc.GetOutput()):
        np.testing.assert_array_equal(a, b)
    assert c.bad_gate_counts == jc.bad_gate_counts and sum(c.bad_gate_counts.values()) > 0
    assert c.bad_gate_levels == jc.bad_gate_levels
    assert c.gate_counts == jc.gate_counts
    assert [{k: v for k, v in r.items() if k != "cycle"} for r in c.bad_gate_lanes] == jc.bad_gate_lanes
    assert c._rng.bit_generator.state == jc._rng.bit_generator.state
    if branch == "0":
        np.testing.assert_array_equal(c._ct_arena.numpy(), np.asarray(jc._ct_arena))
