"""The port's native C++ Bristol parser and levelizer
(oece_tpu_torch/circuits/native.py, built with g++ from the port's own
csrc/host/oece_native.cpp into build/oece_tpu_torch/) against the port's
Python versions and the JAX package's bristol/netlist, on the repo's
examples/ (tests/test_native.py reads the absent reference corpus)."""

import os

import numpy as np
import pytest

from oece_tpu.circuits.bristol import parse_bristol as jparse_bristol
from oece_tpu.circuits.netlist import levelize as jlevelize
from oece_tpu_torch.circuits import native
from oece_tpu_torch.circuits.bristol import parse_bristol
from oece_tpu_torch.circuits.netlist import levelize

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
FILES = [
    "old_bristol_ckts/arith/adder_32bit.txt",
    "old_bristol_ckts/arith/mult_32x32.txt",
    "new_bristol_ckts/arith/adder64.txt",
    "new_bristol_ckts/crypto/sha256.txt",
]


def _same_netlist(a, b):
    assert a.name == b.name and a.n_wires == b.n_wires
    for f in ("op", "in0", "in1", "out"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert [list(w) for w in a.inputs] == [list(w) for w in b.inputs]
    assert [list(w) for w in a.outputs] == [list(w) for w in b.outputs]


def _same_plan(a, b):
    assert a.depth == b.depth and len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        assert sorted(la) == sorted(lb)
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_built_from_the_ports_source():
    """The library is the port's own build: under build/oece_tpu_torch/,
    from csrc/host/oece_native.cpp, never native/liboece_native.so."""
    assert native.available(), native.BUILD_ERROR
    so = native.library_path()
    assert so.exists() and so.parent.name == "oece_tpu_torch" and so.parent.parent.name == "build"
    assert native.SRC.name == "oece_native.cpp" and native.SRC.parent.parent.name == "csrc"


@pytest.mark.parametrize("path", FILES)
def test_native_parse_matches_python(path, monkeypatch):
    full = os.path.join(EXAMPLES, path)
    nl_c = native.parse_bristol_native(full)
    assert nl_c is not None
    monkeypatch.setenv("OECE_NO_NATIVE", "1")
    nl_py = parse_bristol(full)
    _same_netlist(nl_c, nl_py)
    _same_netlist(nl_c, jparse_bristol(full))


def test_native_levelize_used_and_consistent(monkeypatch):
    full = os.path.join(EXAMPLES, "new_bristol_ckts/crypto/sha256.txt")
    nl = parse_bristol(full)
    calls = []
    real = native.levelize_native
    monkeypatch.setattr(native, "levelize_native", lambda n: calls.append(1) or real(n))
    plan_c = levelize(nl)  # the native levelizer, automatically
    assert calls
    monkeypatch.setattr(native, "levelize_native", lambda n: None)
    plan_py = levelize(nl)  # the Python loop
    _same_plan(plan_c, plan_py)
    _same_plan(plan_c, jlevelize(jparse_bristol(full)))
    s = plan_c.stats()
    assert s["bootstrap_gates"] == int(np.isin(nl.op, [0, 1, 2, 3, 4, 5]).sum())


def test_parse_error_raises(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("2 5\n1 2\n1 1\n\n2 1 0 1 9 AND\n2 1 2 3 4 FOO\n")
    with pytest.raises(ValueError):
        parse_bristol(str(bad))
