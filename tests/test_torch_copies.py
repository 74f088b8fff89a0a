"""The port's own copies of the JAX package's pure-NumPy modules, held to
their originals: the parameter table (fields, derived values, enums),
golden's samplers and test vectors (same ``np.random.Generator``, same
draws, same arrays; key generation's draws as fhe/hostkeygen.py takes
them), host encryption, the circuit parsers, levelizer, slot
allocator, assembler emitter and LUT lowering (on
examples/old_bristol_ckts/arith/adder_32bit.txt and adder_2bit.out), and
the trace records."""

import dataclasses
import os

import numpy as np
import pytest

from oece_tpu.circuits import asm as jasm
from oece_tpu.circuits import bristol as jbristol
from oece_tpu.circuits import lut as jlut
from oece_tpu.circuits import netlist as jnetlist
from oece_tpu.fhe import golden as jgolden
from oece_tpu.fhe import lwe as jlwe
from oece_tpu.fhe import params as jparams
from oece_tpu.utils import trace as jtrace
from oece_tpu_torch.circuits import asm, bristol, lut, netlist
from oece_tpu_torch.fhe import golden, hostkeygen, lwe, params
from oece_tpu_torch.utils import trace

EX = os.path.join(os.path.dirname(__file__), "..", "examples")
ADDER32 = os.path.join(EX, "old_bristol_ckts", "arith", "adder_32bit.txt")
ADDER2 = os.path.join(EX, "simple_ckts", "adder_2bit", "adder_2bit.out")
DERIVED = ("d_g", "d_g_used", "g_shift", "d_ks", "d_r", "log_B_g", "log_B_ks")


def test_params_table_matches():
    assert sorted(params.PARAM_SETS) == sorted(jparams.PARAM_SETS)
    assert params.Q27 == jparams.Q27
    for name, jp in jparams.PARAM_SETS.items():
        p = params.get_params(name)
        assert dataclasses.asdict(p) == dataclasses.asdict(jp)
        assert [getattr(p, d) for d in DERIVED] == [getattr(jp, d) for d in DERIVED]
    for ours, theirs in ((params.BinFHEMethod, jparams.BinFHEMethod),
                         (params.BinGate, jparams.BinGate)):
        assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]
    assert params.BinFHEMethod.AP != jparams.BinFHEMethod.AP  # other classes
    with pytest.raises(ValueError, match="unknown BINFHE_PARAMSET"):
        params.get_params("NOPE")


@pytest.mark.parametrize("name,method", [("MICRO", "GINX"), ("MICRO_A", "GINX"),
                                         ("MICRO_AP2", "AP"), ("MICRO", "AP")])
def test_golden_keygen_matches(name, method):
    """The LWE secret, then golden.bootstrap_keygen's draws: the ring secret
    first, and all of them as hostkeygen.sample takes them, so that the
    generators end in the same state."""
    base = "MICRO_A" if name == "MICRO_AP2" else name
    jp, p = jparams.get_params(base), params.get_params(base)
    if name == "MICRO_AP2":
        jp, p = (dataclasses.replace(x, name=name, B_r=2) for x in (jp, p))
    if method == "AP" and name == "MICRO":  # B_r = 32: keep it short
        jp, p = (dataclasses.replace(x, n=2) for x in (jp, p))
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    jsk, sk = jgolden.lwe_keygen(jp, r1), golden.lwe_keygen(p, r2)
    np.testing.assert_array_equal(sk.s, jsk.s)
    state = r2.bit_generator.state
    jbk = jgolden.bootstrap_keygen(jp, jsk, r1, jparams.BinFHEMethod[method])
    np.testing.assert_array_equal(golden.ring_secret(p, r2), jbk.z)
    r2.bit_generator.state = state
    z, Aks, Eks, A, E = hostkeygen.sample(p, r2, params.BinFHEMethod[method])
    np.testing.assert_array_equal(z, jbk.z)
    np.testing.assert_array_equal(Aks, jbk.ksk[..., :p.n].reshape(Aks.shape))
    # host encryption and decryption, then the generators' next draws
    bits = r1.integers(0, 2, 9)
    r2.integers(0, 2, 9)
    np.testing.assert_array_equal(lwe.encrypt_bits(sk, bits, r2), jlwe.encrypt_bits(jsk, bits, r1))
    assert r1.integers(0, 2**62) == r2.integers(0, 2**62)
    cts = jlwe.encrypt_bits(jsk, bits, np.random.default_rng(1))
    np.testing.assert_array_equal(lwe.decrypt_bits(sk, cts), jlwe.decrypt_bits(jsk, cts))
    np.testing.assert_array_equal(lwe.decrypt_bits(sk, cts), bits)


def test_golden_ring_helpers_and_test_vectors_match():
    """The samplers (ring secret included) and the test vectors."""
    for name in ("MICRO", "TOY", "STD128_OPT"):
        jp, p = jparams.get_params(name), params.get_params(name)
        for g in params.BinGate:
            np.testing.assert_array_equal(
                golden.make_test_vector(p, g), jgolden.make_test_vector(jp, jparams.BinGate[g.name])
            )
    r1, r2 = np.random.default_rng(8), np.random.default_rng(8)
    for ours, theirs in ((golden.ternary, jgolden.ternary), (golden.binary, jgolden.binary)):
        np.testing.assert_array_equal(ours(r2, (3, 64)), theirs(r1, (3, 64)))
    np.testing.assert_array_equal(golden.gauss(r2, 3.19, (500,)), jgolden.gauss(r1, 3.19, (500,)))
    for p in (params.MICRO, dataclasses.replace(params.MICRO, secret="binary")):
        z = golden.ring_secret(p, r2)
        want = (jgolden.ternary if p.secret == "ternary" else jgolden.binary)(r1, (p.N,))
        np.testing.assert_array_equal(z, want)


def _same_netlist(a, b):
    assert (a.name, a.n_wires, a.n_gates) == (b.name, b.n_wires, b.n_gates)
    for f in ("op", "in0", "in1", "out", "dff_d", "dff_q"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for x, y in zip(a.inputs + a.outputs, b.inputs + b.outputs):
        np.testing.assert_array_equal(x, y)
    assert len(a.inputs) == len(b.inputs) and len(a.outputs) == len(b.outputs)


def _same_plan(a, b):
    assert a.n_wires == b.n_wires and a.depth == b.depth and a.stats() == b.stats()
    for la, lb in zip(a.levels, b.levels):
        assert sorted(la) == sorted(lb)
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.mark.parametrize("path", [ADDER32, ADDER2], ids=["adder_32bit", "adder_2bit"])
def test_parse_levelize_and_slots_match(path):
    if path.endswith(".out"):
        nl, jnl = asm.parse_asm(path), jasm.parse_asm(path)
    else:
        nl, jnl = bristol.parse_bristol(path), jbristol.parse_bristol(path)
    _same_netlist(nl, jnl)
    plan, jplan = netlist.levelize(nl), jnetlist.levelize(jnl)
    _same_plan(plan, jplan)
    slot, n_slots = netlist.assign_ct_slots(nl, plan)
    jslot, jn_slots = jnetlist.assign_ct_slots(jnl, jplan)
    assert n_slots == jn_slots
    np.testing.assert_array_equal(slot, jslot)
    assert nl.op_counts() == jnl.op_counts()
    assert [o.name for o in netlist.Op] == [o.name for o in jnetlist.Op]
    assert asm.emit_asm(nl) == jasm.emit_asm(jnl)
    assert bristol.emit_bristol(nl) == jbristol.emit_bristol(jnl)


def test_lut_lowering_matches():
    for k in (2, 3):
        for mask in range(1 << (1 << k)):
            gates, jgates = [], []

            def emitter(out):
                def emit(op, a, b):
                    out.append((op.name, a, b))
                    return 100 + len(out)
                return emit

            w = lut.lower_lut(emitter(gates), lambda b: -1 - b, mask, list(range(k)))
            jw = jlut.lower_lut(emitter(jgates), lambda b: -1 - b, mask, list(range(k)))
            assert (w, gates) == (jw, jgates)
            for x in range(1 << k):
                bits = [(x >> i) & 1 for i in range(k)]
                assert lut.lut_reference(mask, bits) == jlut.lut_reference(mask, bits)


def test_trace_matches():
    rec = dict(level=0, boot_gates=3, linear_gates=2, batch=4, wall_s=0.5, bootstraps=12)
    t, jt = trace.Trace(circuit="c", mode="verify"), jtrace.Trace(circuit="c", mode="verify")
    t.add(trace.LevelRecord(**rec))
    jt.add(jtrace.LevelRecord(**rec))
    t.total_s = jt.total_s = 2.0
    assert t.summary() == jt.summary()
    assert t.dump_json() == jt.dump_json()


def jax_params(p):
    """The JAX package's BinFHEParams with the fields of the port's ``p``
    (for the JAX side of the other port tests)."""
    return jparams.BinFHEParams(**dataclasses.asdict(p))


def port_params(jp):
    """The port's BinFHEParams with the fields of the JAX package's ``jp``."""
    return params.BinFHEParams(**dataclasses.asdict(jp))


def port_bootstrap_key(jbk):
    """The port's golden BootstrapKey holding the arrays of a JAX golden
    ``jbk`` (what keys.pack_bootstrap_key takes)."""
    return golden.BootstrapKey(
        brk_pos=jbk.brk_pos, brk_neg=jbk.brk_neg, ak=jbk.ak, ksk=jbk.ksk, z=jbk.z,
        params=port_params(jbk.params), method=params.BinFHEMethod[jbk.method.name],
    )


def test_jax_params_round_trip():
    """The tests' translation helpers, and the port's packers refusing the
    JAX package's records (only keys.from_jax translates them)."""
    from oece_tpu_torch.fhe import keys

    for p in params.PARAM_SETS.values():
        jp = jax_params(p)
        assert isinstance(jp, jparams.BinFHEParams) and jp == jparams.get_params(p.name)
        assert port_params(jp) == p
    rng = np.random.default_rng(3)
    jp = jparams.MICRO
    jbk = jgolden.bootstrap_keygen(jp, jgolden.lwe_keygen(jp, rng), rng)
    bk = port_bootstrap_key(jbk)
    assert bk.params == params.MICRO and bk.method is params.BinFHEMethod.GINX
    for pack in (keys.pack_bootstrap_key, keys.pack_rotated_form):
        with pytest.raises(TypeError, match="from_jax"):
            pack(jbk, "cpu")
        assert pack(bk, "cpu").params is bk.params
