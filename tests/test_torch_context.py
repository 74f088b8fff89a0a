"""The port's ``BinFHEContext`` (oece_tpu_torch.fhe.context) on the CPU, bit for bit (tolerance 0), against the JAX package's
(interpret-mode Pallas kernels):

  * one seed, one call sequence (KeyGen, BTKeyGen, Encrypt, every
    EvalBinGate, EvalNOT, EvalBinGateBatch, Decrypt) through both contexts
    gives identical keys and ciphertexts: GINX at MICRO_A (and at MICRO in
    tests/test_torch_context_micro.py), the binary-base AP method at
    MICRO_AP2, the generic-base AP method (B_r = 32) at MICRO;
  * the port's BTKeyGen (golden's draws, products on the device) equals
    golden.bootstrap_keygen packed, and leaves the generator where golden
    leaves it;
  * key generation and packing default to the card.

tests/test_torch_host_keygen_circuit.py runs the ``OECE_HOST_KEYGEN=1``
route of ``Circuit``.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import context as jcontext
from oece_tpu.fhe import golden as jgolden
from oece_tpu.fhe import params as jparams
from oece_tpu.fhe.context import BinFHEContext as JaxContext
from oece_tpu_torch.fhe import ap, devkeygen, keys, std
from oece_tpu_torch.fhe import params as pparams
from oece_tpu_torch.fhe.context import BinFHEContext
from oece_tpu_torch.runtime.evaluator import Circuit
from test_torch_copies import port_bootstrap_key
from test_torch_std import jax_fast, one_torch_thread  # noqa: F401

TRUTH = {
    "AND": lambda a, b: a & b, "OR": lambda a, b: a | b, "NAND": lambda a, b: 1 - (a & b),
    "NOR": lambda a, b: 1 - (a | b), "XOR": lambda a, b: a ^ b, "XNOR": lambda a, b: 1 - (a ^ b),
}


def _both(name):
    if name == "MICRO_AP":  # MICRO's own generic rotation base, B_r = 32
        return jparams.MICRO, pparams.MICRO, "AP"
    if name == "MICRO_AP2":  # binary rotation base at MICRO_A size
        return (dataclasses.replace(jparams.MICRO_A, name=name, B_r=2),
                dataclasses.replace(pparams.MICRO_A, name=name, B_r=2), "AP")
    return jparams.get_params(name), pparams.get_params(name), "GINX"


def _key_fields(kt):
    return {f: getattr(kt, f).numpy() for f in ("ginx_ext", "ap_ext", "rev2", "ksk", "tv_table")
            if getattr(kt, f) is not None}


def _assert_same_keys(got, want):
    g, w = _key_fields(got), _key_fields(want)
    assert sorted(g) == sorted(w)
    for f in g:
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    assert got.params == want.params and got.method == want.method


@pytest.mark.parametrize("name", ["MICRO_A", "MICRO_AP2"])
def test_context_sequence_matches_jax(name, monkeypatch):
    check_sequence(name, monkeypatch)


def check_sequence(name, monkeypatch):
    monkeypatch.setattr(jboot, "PALLAS_INTERPRET", True)
    # the JAX context's gate batch, compiled once per batch shape
    monkeypatch.setattr(jcontext.boot, "eval_bin_gate_batch", jax_fast(jboot.eval_bin_gate_batch, level=1))
    jp, pp, method = _both(name)
    jc = JaxContext().GenerateBinFHEContext(jp, method, seed=41)
    tc = BinFHEContext(device="cpu").GenerateBinFHEContext(pp, method, seed=41)
    jsk, tsk = jc.KeyGen(), tc.KeyGen()
    np.testing.assert_array_equal(tsk.s, jsk.s)
    jc.BTKeyGen(jsk)
    tc.BTKeyGen(tsk)
    _assert_same_keys(tc.keys, keys.from_jax(jc.dkeys))

    pairs = [(0, 0), (0, 1), (1, 0), (1, 1)]
    cts = []
    for a, b in pairs:
        ja, jb = jc.Encrypt(jsk, a), jc.Encrypt(jsk, b)
        ta, tb = tc.Encrypt(tsk, a), tc.Encrypt(tsk, b)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        cts.append((ta, tb))
    kernel = ap if method == "AP" else std
    # a generic base rotates with torch ops on every device, counted apart
    count = "GENERIC_LAUNCHES" if method == "AP" and pp.B_r != 2 else "PLAIN_LAUNCHES"
    plain0 = getattr(kernel, count)
    for gate, fn in TRUTH.items():  # one single call per gate
        (a, b), (ca, cb) = pairs[len(gate) % 4], cts[len(gate) % 4]
        want = np.asarray(jc.EvalBinGate(gate, ca, cb))
        got = tc.EvalBinGate(gate, ca, cb)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        assert tc.Decrypt(tsk, got) == jc.Decrypt(jsk, want) == fn(a, b)
    assert getattr(kernel, count) == plain0 + 6
    np.testing.assert_array_equal(tc.EvalNOT(cts[1][0]), np.asarray(jc.EvalNOT(cts[1][0])))
    assert tc.Decrypt(tsk, tc.EvalNOT(cts[1][0])) == 1

    # every gate on every input pair in one batch, then one chained batch
    gates = [jparams.BinGate[g] for g in TRUTH for _ in pairs]
    c1 = np.stack([ca for _ in TRUTH for ca, _ in cts])
    c2 = np.stack([cb for _ in TRUTH for _, cb in cts])
    want = np.asarray(jc.EvalBinGateBatch(gates, c1, c2))
    got = tc.EvalBinGateBatch([g.name for g in gates], c1, c2)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    bits = tc.DecryptBatch(tsk, got)
    np.testing.assert_array_equal(
        bits, [TRUTH[g.name](a, b) for g in gates[::4] for a, b in pairs]
    )
    want2 = np.asarray(jc.EvalBinGateBatch("XOR", want, np.roll(want, 1, axis=0)))
    got2 = tc.EvalBinGateBatch(pparams.BinGate.XOR, got, torch.roll(got, 1, dims=0))
    np.testing.assert_array_equal(got2.numpy(), want2)
    np.testing.assert_array_equal(tc.DecryptBatch(tsk, got2), bits ^ np.roll(bits, 1))
    # the generators are in the same state
    np.testing.assert_array_equal(tc.Encrypt(tsk, 1), jc.Encrypt(jsk, 1))


def test_generic_base_ap_raises(monkeypatch):
    """The generic-base AP method (MICRO, B_r = 32) used to raise; it now
    runs the whole call sequence bit for bit as the JAX context, with
    every digit value's keys (ap.blind_rotate_ap_generic)."""
    check_sequence("MICRO_AP", monkeypatch)


@pytest.mark.parametrize("name", ["MICRO_A", "MICRO_AP2"])
def test_btkeygen_matches_golden(name):
    jp, pp, method = _both(name)
    tc = BinFHEContext(device="cpu").GenerateBinFHEContext(pp, method, seed=77)
    tc.BTKeyGen(tc.KeyGen())
    rng = np.random.default_rng(77)
    jsk = jgolden.lwe_keygen(jp, rng)
    bk = jgolden.bootstrap_keygen(jp, jsk, rng, jparams.BinFHEMethod[method])
    _assert_same_keys(tc.keys, keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu"))
    assert tc._rng.integers(0, 2**62) == rng.integers(0, 2**62)


def test_entry_points_default_to_the_card():
    for fn in (devkeygen.device_keygen, devkeygen.device_keygen_ap, keys.pack_bootstrap_key,
               BinFHEContext.__init__, Circuit.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
