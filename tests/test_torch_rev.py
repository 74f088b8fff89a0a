"""The port's "rev" GINX path (oece_tpu_torch.fhe.rev; keys.build_rev;
devkeygen layout="rev") on the CPU, bit for bit (tolerance 0), against the
JAX package's OECE_LAYOUT=rev split pipeline with its Pallas kernels in
interpret mode:

  * #8, #9, #10: the plain twins behind ``window_matmul_true``,
    ``window_matmul_dec_true`` and ``cmux_epilogue_true`` equal
    ``pk.window_matmul_true`` / ``pk.window_matmul_dec_true`` /
    ``pk.cmux_epilogue_true`` (MICRO, and TOY with zero_low_bits=1);
  * the rotation: ``blind_rotate_rev`` on ``build_rev(brk)`` equals
    ``blind_rotate_std`` on ``ginx_ext_planes(brk)`` and JAX
    ``blind_rotate_ginx_dev`` on ginx_rev;
  * gate batches on ``from_jax`` rev keys equal JAX's.

The rev keygen is held to JAX's in tests/test_torch_rev_keygen.py, whole
Circuit runs under OECE_LAYOUT=rev in tests/test_torch_rev_circuit.py.
The CUDA kernels are checked against the same plain twins on the card by
chip_smoke.py (phase rev-kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import devkeygen as jdevkeygen
from oece_tpu.fhe import lwe as jlwe
from oece_tpu.fhe import pallas_kernels as pk
from oece_tpu.fhe.params import BinFHEMethod as JMethod
from oece_tpu_torch.fhe import boot, keys, rev, std
from oece_tpu_torch.fhe.params import MICRO, MICRO_A, TOY
from test_torch_copies import jax_params
from test_torch_devkeygen import TRUTH

T = 128


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _zlb(p):
    """Barrel rounds the TPU epilogue skips: log2(2N/q) (1 at TOY)."""
    return max(0, int(np.log2(2 * p.N // p.q)))


def _a2N(p, rng, B, n):
    """Amounts of the q -> 2N mod switch, lane 0 and every third step 0."""
    a = ((2 * p.N // p.q) * rng.integers(0, p.q, (B, n))).astype(np.int32)
    a[0] = 0
    a[:, ::3] = 0
    return a


@pytest.mark.parametrize(
    "params,M,B", [(MICRO, 16, 5), (MICRO, 8, 37), (TOY, 16, 6), (TOY, 8, 3)],
    ids=["MICRO-M16", "MICRO-M8", "TOY-M16", "TOY-M8"],
)
def test_window_matmul_true_matches_pallas(params, M, B):
    """#8 on random digits and block bytes (the full int8 range)."""
    p = params
    rng = np.random.default_rng(M + B)
    R, nt = 2 * p.d_g_used, p.N // T
    digs = rng.integers(-128, 128, (B, nt * R * T)).astype(np.int8)
    block = rng.integers(-128, 128, ((2 * nt - 1) * R * T, M * T)).astype(np.int8)
    want = np.asarray(pk.window_matmul_true(jnp.asarray(digs), jnp.asarray(block), R, p.Q,
                                            interpret=True))
    plain0 = rev.PLAIN_LAUNCHES
    got = rev.window_matmul_true(_t(digs), _t(block), R, p.Q)
    assert rev.PLAIN_LAUNCHES == plain0 + 1
    assert got.shape == (B, M // 4, p.N)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("params,M", [(MICRO, 16), (MICRO_A, 8), (TOY, 16)],
                         ids=["MICRO", "MICRO_A-M8", "TOY"])
def test_window_matmul_dec_true_matches_pallas(params, M):
    """#9: digits of a random accumulator (exact gadget at MICRO and TOY,
    approximate at MICRO_A), then #8."""
    p = params
    rng = np.random.default_rng(M)
    R, nt, B = 2 * p.d_g_used, p.N // T, 7
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)
    block = rng.integers(-128, 128, ((2 * nt - 1) * R * T, M * T)).astype(np.int8)
    want = np.asarray(pk.window_matmul_dec_true(
        jnp.asarray(acc), jnp.asarray(block), R, p.Q, p.B_g, p.d_g_used, p.g_shift,
        interpret=True,
    ))
    got = rev.window_matmul_dec_true(_t(acc), _t(block), p)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("params", [MICRO, TOY], ids=lambda p: p.name)
def test_cmux_epilogue_true_matches_pallas(params):
    """#10 for any amount pairs: at TOY the TPU skips the lowest barrel
    round (zero_low_bits=1), so its amounts are even there."""
    p = params
    rng = np.random.default_rng(p.N)
    B, zlb = 9, _zlb(p)
    P = rng.integers(0, p.Q, (B, 2, 2, p.N)).astype(np.int32)
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)
    amt = (rng.integers(0, 2 * p.N >> zlb, (B, 2)) << zlb).astype(np.int32)
    amt[0] = 0
    amt[1] = [p.N, 2 * p.N - (1 << zlb)]
    want = np.asarray(pk.cmux_epilogue_true(
        jnp.asarray(P), jnp.asarray(acc), jnp.asarray(amt), p.Q, interpret=True,
        zero_low_bits=zlb,
    ))
    got = rev.cmux_epilogue_true(_t(P), _t(acc), _t(amt), p.Q, zero_low_bits=zlb)
    np.testing.assert_array_equal(got.numpy(), want)
    # the standard form's epilogue is #10 with (2N - a, a)
    a = amt[:, 1].copy()
    ga = rev.cmux_epilogue_true(_t(P), _t(acc), rev.amount_pairs(_t(a), p.N), p.Q)
    np.testing.assert_array_equal(
        ga.numpy(), std.cmux_epilogue_plain(_t(acc), _t(P.reshape(B, 4, p.N)), _t(a), p.Q).numpy()
    )


@pytest.mark.parametrize("params,n,B", [(MICRO, 3, 5), (MICRO_A, 2, 37), (TOY, 2, 3)],
                         ids=lambda x: getattr(x, "name", str(x)))
def test_rotation_matches_std_and_jax(params, n, B, monkeypatch):
    """blind_rotate_rev on build_rev(brk) == blind_rotate_std on the same
    refresh keys' ginx_ext == JAX's prebuilt-step scan on ginx_rev."""
    monkeypatch.setattr(jboot, "PALLAS_INTERPRET", True)
    p = params
    rng = np.random.default_rng(n * B)
    R = 2 * p.d_g_used
    brk = _t(rng.integers(0, p.Q, (n, 2, R, 2, p.N)).astype(np.int32))
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)
    a2N = _a2N(p, rng, B, n)
    rev_all = keys.build_rev(brk, p.Q)
    for i in range(n):  # the rev block of step i is the std build of step i
        np.testing.assert_array_equal(
            rev_all[i].numpy(),
            std.build_diagonals_plain(keys.ginx_ext_planes(brk, p.Q)[i], keys.rev_index(p.N, "cpu")).numpy(),
        )
    plain0 = rev.PLAIN_LAUNCHES
    got = rev.blind_rotate_rev(_t(acc), rev_all, _t(a2N), p)
    assert rev.PLAIN_LAUNCHES == plain0 + 1
    want_std = std.blind_rotate_std(_t(acc), keys.ginx_ext_planes(brk, p.Q), _t(a2N), p)
    np.testing.assert_array_equal(got.numpy(), want_std.numpy())
    np.testing.assert_array_equal(got[0].numpy(), acc[0])  # the a=0 lane
    dk = jboot.DeviceBootKeys(
        params=jax_params(p), method=JMethod.GINX, ginx_kext=None, ap_kext=None,
        ksk=None, tv_table=None, ginx_rev=jnp.asarray(rev_all.numpy()),
    )
    want = np.asarray(jboot.blind_rotate_ginx_dev(jnp.asarray(acc), jnp.asarray(a2N), dk))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("params", [MICRO, MICRO_A], ids=lambda p: p.name)
def test_gate_batch_matches_jax(params, monkeypatch):
    """JAX device keys in the rev layout, carried across by from_jax."""
    monkeypatch.setattr(jboot, "PALLAS_INTERPRET", True)
    p = params
    sk, _, dkeys = jdevkeygen.device_keygen(jax_params(p), seed=21, layout="rev")
    kt = keys.from_jax(dkeys)
    assert kt.rev is not None and kt.rev2 is None and kt.ginx_ext is None
    assert torch.equal(kt.to("cpu").rev, kt.rev)
    rng = np.random.default_rng(4)
    B = 12
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    gids = (np.arange(B) % 6).astype(np.int32)
    c1, c2 = jlwe.encrypt_bits(sk, m1, rng), jlwe.encrypt_bits(sk, m2, rng)
    want = np.asarray(jboot.eval_bin_gate_batch(dkeys, jnp.asarray(gids), jnp.asarray(c1),
                                                jnp.asarray(c2)))
    plain0 = rev.PLAIN_LAUNCHES
    got = boot.eval_bin_gate_batch(kt, _t(gids), _t(c1), _t(c2)).numpy()
    assert rev.PLAIN_LAUNCHES == plain0 + 1  # boot picked the rev rotation
    np.testing.assert_array_equal(got, want)
    truth = np.array([TRUTH[g](int(a), int(b)) for g, a, b in zip(gids, m1, m2)])
    np.testing.assert_array_equal(jlwe.decrypt_bits(sk, got), truth)


def test_wrappers_refuse_bad_input():
    p = MICRO
    R, nt, B = 2 * p.d_g_used, p.N // T, 3
    digs = torch.zeros((B, nt * R * T), dtype=torch.int8)
    block = torch.zeros(((2 * nt - 1) * R * T, 16 * T), dtype=torch.int8)
    acc = torch.zeros((B, 2, p.N), dtype=torch.int32)
    P = torch.zeros((B, 2, 2, p.N), dtype=torch.int32)
    amt = torch.zeros((B, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="M = 16 or 8"):  # M = 12
        rev.window_matmul_true(digs, torch.zeros(((2 * nt - 1) * R * T, 12 * T), dtype=torch.int8), R, p.Q)
    with pytest.raises(ValueError):
        rev.window_matmul_true(digs[:, :-T], block, R, p.Q)
    with pytest.raises(ValueError):
        rev.window_matmul_dec_true(acc[:, :1], block, p)
    with pytest.raises(ValueError, match="contiguous"):
        rev.cmux_epilogue_true(P, acc, torch.zeros((2, B), dtype=torch.int32).T, p.Q)
    with pytest.raises(ValueError, match="zero_low_bits"):
        rev.cmux_epilogue_true(P, acc, amt, p.Q, zero_low_bits=-1)
    with pytest.raises(ValueError):
        rev.blind_rotate_rev(acc, block[None, :, : 8 * T].contiguous(), torch.zeros((B, 1), dtype=torch.int32), p)
    # no kernel and no plain fallback for a device other than the CPU or CUDA
    counts = (rev.LAUNCHES, rev.PLAIN_LAUNCHES)
    meta = lambda *ts: [t.to("meta") for t in ts]  # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        rev.window_matmul_true(*meta(digs, block), R, p.Q)
    with pytest.raises(ValueError, match="no kernel"):
        rev.window_matmul_dec_true(*meta(acc, block), p)
    with pytest.raises(ValueError, match="no kernel"):
        rev.cmux_epilogue_true(*meta(P, acc, amt), p.Q)
    with pytest.raises(ValueError, match="no kernel"):
        rev.blind_rotate_rev(*meta(acc, block[None], torch.zeros((B, 1), dtype=torch.int32)), p)
    with pytest.raises(ValueError, match="different devices"):
        rev.cmux_epilogue_true(P, acc, amt.to("meta"), p.Q)
    assert (rev.LAUNCHES, rev.PLAIN_LAUNCHES) == counts
