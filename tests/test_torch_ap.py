"""The port's binary-base AP rotation (oece_tpu_torch.fhe.ap) on the CPU, bit
for bit:

  * against the JAX AP megakernel ``boot._blind_rotate_ap_fused`` run in
    interpret mode, on device-keygen AP keys carried across with
    ``keys.from_jax`` (MICRO_AP2; TOY with n=2, the exact gadget at N=512;
    STD128_OPT with n=2), ragged batches and an a=0 lane;
  * against ``golden.blind_rotate_ap`` on golden AP keys packed by
    ``keys.pack_bootstrap_key`` (MICRO_AP2).

The CUDA kernel is checked against the same plain version on the card by
chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import devkeygen as jdevkeygen
from oece_tpu.fhe import golden
from oece_tpu.fhe.params import BinFHEMethod as JMethod
from oece_tpu.fhe.params import BinGate as JGate
from oece_tpu_torch.fhe import ap, keys
from oece_tpu_torch.fhe.params import MICRO_A, STD128_OPT, TOY, BinFHEMethod
from test_torch_copies import jax_params, port_bootstrap_key
from test_torch_std import one_torch_thread  # noqa: F401

MICRO_AP2 = dataclasses.replace(MICRO_A, name="MICRO_AP2", B_r=2)
TOY_AP2_N2 = dataclasses.replace(TOY, name="TOY_AP2_N2", n=2, B_r=2)
STD_AP_N2 = dataclasses.replace(STD128_OPT, name="STD128_OPT_AP_N2", n=2)


def _a2N(p, rng, B):
    scale = 2 * p.N // p.q  # valid amounts after the q -> 2N mod switch
    a = (scale * rng.integers(0, p.q, (B, p.n))).astype(np.int32)
    a[0] = 0  # identity lane: every select bit is 0
    return a


@pytest.fixture(scope="module", params=[MICRO_AP2, TOY_AP2_N2, STD_AP_N2], ids=lambda p: p.name)
def jax_ap_keys(request):
    p = request.param
    _, _, dkeys = jdevkeygen.device_keygen_ap(jax_params(p), seed=7)
    return p, dkeys, keys.from_jax(dkeys)


@pytest.mark.parametrize("B", [5, 37])
def test_rotation_matches_jax_megakernel(jax_ap_keys, B):
    p, dkeys, kt = jax_ap_keys
    assert kt.method == BinFHEMethod.AP and kt.rev2 is None
    assert kt.ap_ext.shape == (p.n * p.d_r, 2 * p.d_g_used, 8, 2 * p.N)
    rng = np.random.default_rng(B)
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)
    a2N = _a2N(p, rng, B)
    want = np.asarray(jboot._blind_rotate_ap_fused(
        jnp.asarray(acc), jnp.asarray(a2N), dkeys, interpret=True
    ))
    plain0 = ap.PLAIN_LAUNCHES
    got = ap.blind_rotate_ap(torch.from_numpy(acc), kt.ap_ext, torch.from_numpy(a2N), p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ap.PLAIN_LAUNCHES == plain0 + 1
    np.testing.assert_array_equal(got[0].numpy(), acc[0])


def test_rotation_matches_golden():
    p = MICRO_AP2
    jp = jax_params(p)
    rng = np.random.default_rng(61)
    sk = golden.lwe_keygen(jp, rng)
    bk = golden.bootstrap_keygen(jp, sk, rng, JMethod.AP)
    kt = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    B = 5
    a2N = _a2N(p, rng, B)
    a2N[1, 0] = 0  # one zero amount inside a live lane
    tv = np.stack([golden.make_test_vector(jp, JGate[g.name]) for g in keys.GATE_ORDER[:B]])
    b2N = rng.integers(0, 2 * p.N, B)
    acc0 = np.zeros((B, 2, p.N), dtype=np.int64)
    for b in range(B):
        acc0[b, 1] = golden.negacyclic_monomial_mul(tv[b], int(b2N[b]), p.N, p.Q)
    got = ap.blind_rotate_ap_plain(
        torch.from_numpy(acc0.astype(np.int32)), kt.ap_ext, torch.from_numpy(a2N), p
    )
    for b in range(B):
        ct_2N = np.concatenate([a2N[b], [b2N[b]]]).astype(np.int64)
        want = golden.blind_rotate_ap(jp, bk, ct_2N, tv[b])
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_windows_unpack_to_golden_planes():
    """keys.unpack_windows inverts the JAX package's window packing
    (pack_bootstrap_key on golden keys) back to the port's packed planes."""
    jp = jax_params(MICRO_AP2)
    rng = np.random.default_rng(62)
    sk = golden.lwe_keygen(jp, rng)
    bk = golden.bootstrap_keygen(jp, sk, rng, JMethod.AP)
    dk = jboot.pack_bootstrap_key(bk, use_pallas=True)
    np.testing.assert_array_equal(
        keys.from_jax(dk).ap_ext.numpy(), keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu").ap_ext.numpy()
    )


def test_bits_and_rev_block():
    p = STD_AP_N2
    a2N = torch.tensor([[0, 2], [2046, 1024]], dtype=torch.int32)
    bits = ap.ap_bits(a2N, p)
    neg = (2 * p.N - a2N.long()) % (2 * p.N)
    want = torch.stack([(neg >> j) & 1 for j in range(p.d_r)], dim=-1).reshape(2, -1)
    assert torch.equal(bits.long(), want)
    assert bits[0, : p.d_r].sum() == 0  # a = 0: no step selects the product
    ext = torch.randint(-128, 128, (2 * p.d_g_used, 8, 2 * p.N), dtype=torch.int8,
                        generator=torch.Generator().manual_seed(5))
    rev = keys.rev_block(ext, keys.rev_index(p.N, "cpu"))
    nt, RT, T = p.N // 128, 2 * p.d_g_used * 128, 128
    for dp, r, u, m, t in [(0, 0, 0, 0, 0), (2 * nt - 2, 3, 127, 7, 5), (nt - 1, 1, 9, 2, 3)]:
        assert rev[dp * RT + r * T + u, m * T + t] == ext[r, m, ((nt - 1 - dp) * T + t - u) % (2 * p.N)]


def test_wrapper_refuses_bad_input():
    p = MICRO_AP2
    R = 2 * p.d_g_used
    acc = torch.zeros((3, 2, p.N), dtype=torch.int32)
    ext = torch.zeros((p.n * p.d_r, R, 8, 2 * p.N), dtype=torch.int8)
    a2N = torch.zeros((3, p.n), dtype=torch.int32)
    with pytest.raises(TypeError):
        ap.blind_rotate_ap(acc.to(torch.int64), ext, a2N, p)
    with pytest.raises(ValueError):
        ap.blind_rotate_ap(acc, ext[1:], a2N, p)
    with pytest.raises(ValueError):
        ap.blind_rotate_ap(acc, ext, torch.zeros((p.n, 3), dtype=torch.int32).T, p)
    with pytest.raises(ValueError, match="B_r=32"):
        ap.blind_rotate_ap(acc, ext, a2N, MICRO_A)
    launches, plain = ap.LAUNCHES, ap.PLAIN_LAUNCHES
    with pytest.raises(ValueError, match="no kernel"):
        ap.blind_rotate_ap(acc.to("meta"), ext.to("meta"), a2N.to("meta"), p)
    assert (ap.LAUNCHES, ap.PLAIN_LAUNCHES) == (launches, plain)
