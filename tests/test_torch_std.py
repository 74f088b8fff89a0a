"""The port's standard-form GINX rotation (oece_tpu_torch.fhe.std) on the CPU,
bit for bit (tolerance 0), against the JAX package's host-key GINX path:

  * #1: ``build_diagonals_plain`` against ``pk.build_diagonals_pallas`` in
    interpret mode (after undoing its plane permutation and diagonal
    order) and against ``golden.negacyclic_matrix``;
  * #4: ``diag_matmul_combine_plain`` against
    ``pk.negacyclic_matmul_combine`` in interpret mode, ragged batches;
  * packing: ``keys.pack_bootstrap_key`` against ``keys.from_jax`` of the
    JAX ``pack_bootstrap_key(bk, use_pallas=True)``;
  * #1 as one ``torch.take`` (the library form chip_smoke.py times), the
    rotation wrapper's checks, and ``boot``'s choice of rotation by key
    layout.

tests/test_torch_std_rotation.py holds the step and the rotation,
tests/test_torch_std_boot.py whole gate bootstraps.

The CUDA kernels are checked against the same plain versions on the card
by chip_smoke.py.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import golden as jgolden
from oece_tpu.fhe import lwe as jlwe
from oece_tpu.fhe import modmath as jmodmath
from oece_tpu.fhe import pallas_kernels as pk
from oece_tpu.fhe import params as jparams
from oece_tpu_torch.fhe import boot, keys, lwe, rot, std
from oece_tpu_torch.fhe import golden as pgolden
from oece_tpu_torch.fhe import params as pparams
from test_torch_copies import port_bootstrap_key

T = 128
ROOT = Path(__file__).resolve().parents[1]


def both(name, **kw):
    """(JAX params, port params) of one set, with fields replaced."""
    jp, pp = jparams.get_params(name), pparams.get_params(name)
    if kw:
        tag = name + "_" + "_".join(f"{k}{v}" for k, v in kw.items())
        jp = dataclasses.replace(jp, name=tag, **kw)
        pp = dataclasses.replace(pp, name=tag, **kw)
    return jp, pp


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a module's tests run (modules import this
    fixture to use it).  Each of the suite's xdist workers would otherwise
    run torch on every core, and the layout models' many small ops then
    wait on each other's thread pools: on 8 cores with six workers the
    heavy layout modules took 786 s by default and 72 s with one thread.
    The results do not depend on it (the ops are exact)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_fast(fn, level=0):
    """fn under jax.jit, compiled by XLA's CPU backend at optimization
    ``level``: the same integer program in less compile time.  The
    interpret-mode Pallas kernels lower to large programs and each test
    case compiles its own shapes: level 0 where a program runs once or
    twice, level 1 where it runs many gate batches (the context sequence)."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": level})


def _fake_bk(jp, rng, n):
    """A golden-shaped JAX BootstrapKey with random refresh keys mod Q (the
    rotation must agree on any key values) and a zero key-switch key."""
    R = 2 * jp.d_g_used
    brk = rng.integers(0, jp.Q, (n, 2, R, 2, jp.N), dtype=np.int64)
    return jgolden.BootstrapKey(
        brk_pos=brk[:, 0], brk_neg=brk[:, 1], ak=None,
        ksk=np.zeros((jp.N, jp.d_ks, jp.n + 1), np.int64), z=np.zeros(jp.N, np.int64),
        params=jp, method=jparams.BinFHEMethod.GINX,
    )


def _undo_planes(dense):
    """JAX build output columns: byte j of word w at 32j + w -> true 4w + j."""
    *lead, MT = dense.shape
    x = dense.reshape(*lead, MT // T, 4, T // 4)
    return np.swapaxes(x, -1, -2).reshape(*lead, MT)


@pytest.mark.parametrize("N,R", [(128, 4), (256, 8)])
def test_build_diagonals_matches_pallas(N, R):
    """#1 on random key bytes: the port's reversed, true-column block ==
    the interpret-mode Pallas build, reversed and un-permuted."""
    rng = np.random.default_rng(N + R)
    ext = rng.integers(-128, 128, (R, 16, 2 * N)).astype(np.int8)
    wins = pk.pack_keys_for_pallas(ext.reshape(R * 16, 2 * N))
    dense = np.asarray(jax_fast(lambda w: pk.build_diagonals_pallas(w, R, interpret=True))(jnp.asarray(wins)))
    ndiag = 2 * N // T - 1
    got = std.build_diagonals_plain(_t(ext), keys.rev_index(N, "cpu")).numpy()
    want = _undo_planes(dense)[::-1].reshape(ndiag * R * T, 16 * T)
    np.testing.assert_array_equal(got, want)


def test_build_diagonals_match_negacyclic_matrix():
    """Tile (k, i) of a step's product matrix is rows [(nt-1-k+i)*RT, +RT)
    of the block: limb l of golden.negacyclic_matrix of each key row."""
    jp, pp = both("TOY", n=1)
    rng = np.random.default_rng(3)
    R, N, nt = 2 * pp.d_g_used, pp.N, pp.N // T
    brk = rng.integers(0, pp.Q, (1, 2, R, 2, N)).astype(np.int32)
    ext = keys.ginx_ext_planes(_t(brk), pp.Q)[0]
    block = std.build_diagonals_plain(ext, keys.rev_index(N, "cpu")).numpy()
    block = block.reshape(2 * nt - 1, R, T, 4, 4, T)  # [d', r, u, (part,out), limb, t]
    for part, r, out in [(0, 0, 0), (1, R - 1, 1), (0, 2, 1)]:
        M = jgolden.negacyclic_matrix(brk[0, part, r, out], pp.Q)
        limbs = np.asarray(jmodmath.to_limbs_i8(M))  # [N(i), N(k), L]
        for k, i in [(0, 0), (nt - 1, 0), (0, nt - 1), (2, 1)]:
            tile = block[nt - 1 - k + i, r, :, part * 2 + out]  # [u, limb, t]
            want = limbs[i * T:(i + 1) * T, k * T:(k + 1) * T]  # [u, t, limb]
            np.testing.assert_array_equal(tile, want.transpose(0, 2, 1))


@pytest.mark.parametrize("N,R,B,max_b", [(128, 4, 5, 512), (256, 4, 13, 8)])
def test_diag_matmul_combine_matches_pallas(N, R, B, max_b):
    """#4 on random digits and key bytes (full int8 range), batches chunked
    raggedly on the JAX side: P4 == negacyclic_matmul_combine."""
    rng = np.random.default_rng(B)
    nt, Q = N // T, jparams.Q27
    ext = rng.integers(-128, 128, (R, 16, 2 * N)).astype(np.int8)
    digs = rng.integers(-128, 128, (nt, B, R * T)).astype(np.int8)
    wins = pk.pack_keys_for_pallas(ext.reshape(R * 16, 2 * N))
    want = np.asarray(jax_fast(lambda d, w: pk.negacyclic_matmul_combine(
        d, w, R, Q, max_b=max_b, interpret=True
    ))(jnp.asarray(digs), jnp.asarray(wins)))
    block = std.build_diagonals_plain(_t(ext), keys.rev_index(N, "cpu"))
    dig = _t(digs.transpose(1, 0, 2).reshape(B, nt * R * T))
    got = std.diag_matmul_combine_plain(dig, block, Q).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["MICRO", "TOY"])
def test_pack_matches_jax_pallas_layout(name):
    jp, pp = both(name, n=3)
    bk = _fake_bk(jp, np.random.default_rng(9), jp.n)
    bk.ksk = np.random.default_rng(10).integers(0, jp.Q_ks, bk.ksk.shape)
    dk = jboot.pack_bootstrap_key(bk, use_pallas=True)
    assert dk.ginx_pallas is not None
    want = keys.from_jax(dk)
    got = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    assert got.params == pp and got.method == pparams.BinFHEMethod.GINX
    assert want.params == pp and got.rev2 is None and want.rev2 is None
    for f in ("ginx_ext", "ksk", "tv_table"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f).numpy())


def test_build_diagonals_is_one_take():
    """#1 is a pure byte gather: chip_smoke's library form, one torch.take
    through a fixed index, gives the plain build's block."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rng = np.random.default_rng(12)
    for N, R in [(128, 4), (256, 8)]:
        ext = _t(rng.integers(-128, 128, (R, 16, 2 * N)).astype(np.int8))
        want = std.build_diagonals_plain(ext, keys.rev_index(N, "cpu"))
        assert torch.equal(torch.take(ext, cs.take_index(N, R, "cpu")), want)


def test_wrapper_refuses_bad_input():
    jp, pp = both("MICRO_A")
    R = 2 * pp.d_g_used
    acc = torch.zeros((3, 2, pp.N), dtype=torch.int32)
    ext = torch.zeros((2, R, 16, 2 * pp.N), dtype=torch.int8)
    a2N = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        std.blind_rotate_std(acc.to(torch.int64), ext, a2N, pp)
    with pytest.raises(ValueError):
        std.blind_rotate_std(acc, ext[:, :, :8], a2N, pp)
    with pytest.raises(ValueError):
        std.blind_rotate_std(acc, ext, torch.zeros((3, 3), dtype=torch.int32), pp)
    launches, plain = std.LAUNCHES, std.PLAIN_LAUNCHES
    with pytest.raises(ValueError, match="no kernel"):
        std.blind_rotate_std(acc.to("meta"), ext.to("meta"), a2N.to("meta"), pp)
    assert (std.LAUNCHES, std.PLAIN_LAUNCHES) == (launches, plain)


def test_boot_dispatches_on_the_key_layout():
    """ginx_ext -> the standard form, rev2 -> the rotated form: the two give
    different ciphertexts for the same golden keys (golden.py:486-488)."""
    jp, pp = both("MICRO")
    rng = np.random.default_rng(2)
    sk = jgolden.lwe_keygen(jp, rng)
    bk = jgolden.bootstrap_keygen(jp, sk, rng, jparams.BinFHEMethod.GINX)
    B = 6
    gids = _t(np.arange(B, dtype=np.int32))
    c1 = _t(jlwe.encrypt_bits(sk, rng.integers(0, 2, B), rng))
    c2 = _t(jlwe.encrypt_bits(sk, rng.integers(0, 2, B), rng))
    s0, r0 = std.PLAIN_LAUNCHES, rot.PLAIN_LAUNCHES
    out_std = boot.eval_bin_gate_batch(keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu"), gids, c1, c2)
    out_rot = boot.eval_bin_gate_batch(keys.pack_rotated_form(port_bootstrap_key(bk), "cpu"), gids, c1, c2)
    assert (std.PLAIN_LAUNCHES - s0, rot.PLAIN_LAUNCHES - r0) == (1, 1)
    assert not torch.equal(out_std, out_rot)
    psk = pgolden.LWESecretKey(s=sk.s, params=pp)
    np.testing.assert_array_equal(
        lwe.decrypt_bits(psk, out_std.numpy()), lwe.decrypt_bits(psk, out_rot.numpy())
    )
