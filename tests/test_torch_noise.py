"""The port's noise tools (oece_tpu_torch/tools/measure_noise.py and
measure_xor_noise.py) on the CPU against the JAX tools' computation:

  * one chunk of ``measure_noise.noise_chunk`` (3 chained batches of 24
    mixed gates) and of ``measure_xor_noise.xor_chunk`` (XOR and AND, 3
    batches each) on golden GINX keys, against the JAX tools' step bodies
    built from the JAX package's ``boot.eval_bin_gate_batch`` /
    ``prepare_gates`` / ``bootstrap_batch`` on the same keys, ciphertexts
    and gate ids: histograms, failure counts and max |e| equal (tolerance
    0), and the chained outputs bit for bit, at MICRO here and at
    STD128_OPT's widths in tests/test_torch_noise_wide.py;
  * the first batch (bits and host encryption) as the JAX tools draw it;
  * ``scan_corpus`` on a few corpus files against the JAX tool's loop,
    rebuilt from ``oece_tpu.circuits`` (the tool itself sets up a
    compilation cache when imported);
  * both tools' ``main`` end to end at MICRO on the CPU, their JSON with
    the JAX tools' field names, and the refusal of artifacts/.

The card runs the same functions at STD128_OPT (chip_smoke.py noise)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.circuits import bristol as jbristol
from oece_tpu.circuits.netlist import BOOTSTRAP_OPS as JBOOT_OPS
from oece_tpu.circuits.netlist import Op as JOp
from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import golden as jgolden
from oece_tpu.fhe import lwe as jlwe
from oece_tpu.fhe.params import BinFHEMethod
from oece_tpu_torch.fhe import golden, keys
from oece_tpu_torch.fhe.params import MICRO as PM
from oece_tpu_torch.tools import measure_noise as mn
from oece_tpu_torch.tools import measure_xor_noise as mx
from test_torch_copies import jax_params, port_bootstrap_key
from test_torch_std import jax_fast, one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, K = 24, 3  # lanes, chained batches


def make_setup(p):
    """Golden keys of the port's parameters p in both packages' layouts,
    the secret, the first batch (the JAX tool's draws) and K batches of
    mixed gate ids."""
    jp = jax_params(p)
    rng = np.random.default_rng(8)
    sk = jgolden.lwe_keygen(jp, rng)
    bk = jgolden.bootstrap_keygen(jp, sk, rng, BinFHEMethod.GINX)
    dk = jboot.pack_bootstrap_key(bk, use_pallas=False)
    kt = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    rng = np.random.default_rng(123)
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    c1, c2 = jlwe.encrypt_bits(sk, m1, rng), jlwe.encrypt_bits(sk, m2, rng)
    gids = np.random.default_rng(9).integers(0, 6, (K, B)).astype(np.int32)
    return sk, dk, kt, (c1, c2, m1, m2), gids


@pytest.fixture(scope="module")
def setup():
    return make_setup(PM)


def _truth_all(m1, m2):
    a, o, x = m1 & m2, m1 | m2, m1 ^ m2
    return jnp.stack([a, o, 1 - a, 1 - o, x, 1 - x], axis=0)


def _jax_error(out, want, s, q, n):
    phase = (out[:, n] - jnp.einsum("bi,i->b", out[:, :n], s)) % q
    err = (phase - want * (q // 4)) % q
    return jnp.where(err > q // 2, err - q, err)


def _jax_noise(dk, s, first, gids):
    """The JAX measure_noise step body, K times: (out, hist, nfail, maxabs)."""
    q, n = dk.params.q, dk.params.n
    c1, c2, m1, m2 = (jnp.asarray(x, jnp.int32) for x in first)
    hist, nfail, maxabs = jnp.zeros((q,), jnp.int32), 0, 0
    for g in gids:
        g = jnp.asarray(g)
        out = jboot.eval_bin_gate_batch(dk, g, c1, c2)
        want = jnp.take_along_axis(_truth_all(m1, m2), g[None, :], axis=0)[0]
        err = _jax_error(out, want, s, q, n)
        hist = hist + jnp.bincount((err + q // 2) % q, length=q)
        nfail += int(jnp.sum(jnp.abs(err) >= q // 8))
        maxabs = max(maxabs, int(jnp.max(jnp.abs(err))))
        c1, c2, m1, m2 = out, jnp.roll(c1, 1, axis=0), want, jnp.roll(m1, 1)
    return np.asarray(c1), np.asarray(hist), nfail, maxabs


def _jax_xor(dk, s, first, gate_id):
    """The JAX measure_xor_noise step body, K times, one gate type."""
    q, n = dk.params.q, dk.params.n
    c1, c2, m1, m2 = (jnp.asarray(x, jnp.int32) for x in first)
    ohist, phist = jnp.zeros((q,), jnp.int32), jnp.zeros((q,), jnp.int32)
    nfail, maxo, maxp = 0, 0, 0
    gids = jnp.full((B,), gate_id, jnp.int32)
    for _ in range(K):
        prep = jboot.prepare_gates(c1, c2, gids, q)
        pphase = (prep[:, n] - jnp.einsum("bi,i->b", prep[:, :n], s)) % q
        w = jnp.take(jnp.asarray(jboot.PREP_WEIGHTS), gids, axis=0)
        expq = (w[:, 0] * m1 + w[:, 1] * m2) % 4
        perr = (pphase - expq * (q // 4) + q // 2) % q - q // 2
        out = jboot.bootstrap_batch(prep, gids, dk)
        want = _truth_all(m1, m2)[gate_id]
        err = _jax_error(out, want, s, q, n)
        ohist = ohist + jnp.bincount((err + q // 2) % q, length=q)
        phist = phist + jnp.bincount((perr + q // 2) % q, length=q)
        nfail += int(jnp.sum(jnp.abs(err) >= q // 8))
        maxo, maxp = max(maxo, int(jnp.max(jnp.abs(err)))), max(maxp, int(jnp.max(jnp.abs(perr))))
        c1, c2, m1, m2 = out, jnp.roll(c1, 1, axis=0), want, jnp.roll(m1, 1)
    return np.asarray(c1), np.asarray(ohist), np.asarray(phist), nfail, maxo, maxp


def _port_first(first):
    c1, c2, m1, m2 = (torch.from_numpy(np.asarray(x, np.int32)) for x in first)
    return dict(c1=c1, c2=c2, m1=m1, m2=m2)


def check_first_batch(setup):
    sk, _, kt, first, _ = setup
    psk = golden.LWESecretKey(s=np.asarray(sk.s), params=kt.params)
    got = mn.first_batch(psk, np.random.default_rng(123), B, "cpu")
    for name, want in zip(("c1", "c2", "m1", "m2"), first):
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)


def check_noise_chunk(setup):
    """noise_chunk == the JAX measure_noise step body, K batches."""
    sk, dk, kt, first, gids = setup
    s = torch.as_tensor(np.asarray(sk.s), dtype=torch.int32)
    hist, zero = mn.zeros(kt.params.q, "cpu")
    c = mn.noise_chunk(kt, s, mn.Carry(**_port_first(first), hist=hist, nfail=zero, maxabs=zero),
                       torch.from_numpy(gids))
    out, jhist, nfail, maxabs = _jax_noise(dk, jnp.asarray(np.asarray(sk.s), jnp.int32), first, gids)
    np.testing.assert_array_equal(c.c1.numpy(), out)
    np.testing.assert_array_equal(c.hist.numpy(), jhist)
    assert (int(c.nfail), int(c.maxabs)) == (nfail, maxabs)
    assert int(c.hist.sum()) == K * B


def check_xor_chunk(setup, gate_id):
    """xor_chunk == the JAX measure_xor_noise step body, K batches."""
    sk, dk, kt, first, _ = setup
    s = torch.as_tensor(np.asarray(sk.s), dtype=torch.int32)
    (oh, zero), (ph, _) = mn.zeros(kt.params.q, "cpu"), mn.zeros(kt.params.q, "cpu")
    c = mx.XorCarry(**_port_first(first), ohist=oh, phist=ph, nfail=zero, maxo=zero, maxp=zero)
    c = mx.xor_chunk(kt, s, c, torch.full((K, B), gate_id, dtype=torch.int32))
    out, ohist, phist, nfail, maxo, maxp = _jax_xor(dk, jnp.asarray(np.asarray(sk.s), jnp.int32), first,
                                                    gate_id)
    np.testing.assert_array_equal(c.c1.numpy(), out)
    np.testing.assert_array_equal(c.ohist.numpy(), ohist)
    np.testing.assert_array_equal(c.phist.numpy(), phist)
    assert (int(c.nfail), int(c.maxo), int(c.maxp)) == (nfail, maxo, maxp)


def test_first_batch_draws_as_the_jax_tools(setup):
    check_first_batch(setup)


def test_noise_chunk_matches_jax(setup):
    check_noise_chunk(setup)


@pytest.mark.parametrize("gate_id", [4, 0])  # XOR (weights 2, -2), AND (1, 1)
def test_xor_chunk_matches_jax(setup, gate_id):
    check_xor_chunk(setup, gate_id)


def _jax_scan(files):
    """tools/measure_xor_noise.py's scan_corpus loop, on ``files``."""
    boot_ops = set(int(o) for o in JBOOT_OPS)
    total = 0
    for f in files:
        nl = jbristol.parse_bristol(f)
        root = np.arange(nl.n_wires, dtype=np.int64)
        for k in range(nl.n_gates):
            o = int(nl.op[k])
            a, b, w = int(nl.in0[k]), int(nl.in1[k]), int(nl.out[k])
            if o in (int(JOp.NOT), int(JOp.EQW)):
                root[w] = root[a]
            elif o in boot_ops:
                total += root[a] == root[b]
                root[w] = w
            else:
                root[w] = w
    return int(total)


def test_scan_matches_jax():
    files = [os.path.join(ROOT, "examples", *f) for f in (
        ("old_bristol_ckts", "arith", "adder_32bit.txt"),
        ("new_bristol_ckts", "fp", "FP-mul.txt"),
        ("new_bristol_ckts", "arith", "zero_equal.txt"),
    )]
    lines = []
    got = mx.scan_corpus(files, log=lines.append)
    assert got == _jax_scan(files) > 0
    assert lines[-1] == f"# corpus total shared-linear-root 2-input gates: {got}"
    assert all(os.path.isfile(f) for f in mx.corpus_files()) and len(mx.corpus_files()) > len(files)


def test_tools_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Both tools end to end at MICRO (one chunk of 8 lanes), their JSON
    under the given path; host keys through the key cache in tmp_path."""
    monkeypatch.setenv("OECE_KEY_CACHE", str(tmp_path / "keys"))
    out = tmp_path / "noise.json"
    assert mn.main(["MICRO", "10", "8", "--layout", "host", "--device", "cpu", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["bootstraps"] == 80 and res["backend"] == "cpu" and res["layout"] == "host"
    assert sum(res["hist_nonzero"].values()) == 80 and res["failures"] >= 0
    assert {"noise_std", "noise_max_abs", "margin_sigmas", "failure_rate"} <= set(res)
    out = tmp_path / "xor.json"
    assert mx.main(["MICRO", "10", "8", "--layout", "rev2", "--device", "cpu", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert list(res["per_gate"]) == ["XOR", "AND", "XNOR", "OR"]
    for r in res["per_gate"].values():
        assert r["bootstraps"] == 80 and sum(r["prep_hist_nonzero"].values()) == 80
        assert {"out_noise_std", "prep_err_std", "prep_margin_sigmas"} <= set(r)
    assert "# written" in capsys.readouterr().out
    with pytest.raises(ValueError, match="artifacts"):
        mn.write(res, os.path.join(mn.REPO, "artifacts", "noise_MICRO_rev2.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        mn.run("MICRO", 10, 8, "rev2", "cuda")
