"""#2 and #6 of the port's kernel-level API (oece_tpu_torch.fhe.negacyclic)
on the CPU, bit for bit (tolerance 0), against the JAX package in
interpret mode, inputs drawn by numpy from a seed:

  * #2: ``negacyclic_matmul_window`` (#1 then #2) and ``window_matmul`` on
    the port's block against ``pk.negacyclic_matmul_window`` (the cases of
    tests/test_pallas.py, B = 12 chunked raggedly by max_b = 8 on the JAX
    side) and against the port's reference with the limb combine (the card
    runs #3's transpose, whose tiles tests/test_torch_negacyclic_layout.py
    models, then #8's GEMMs, whose tiling tests/test_torch_rev_layout.py
    models against this plain twin);
  * #6: ``cmux_epilogue`` against ``pk.cmux_epilogue_pallas`` and the jnp
    formula of boot.py (GINX amount pairs), and against the Pallas kernel
    for any amount pairs.

The JAX kernels compile with ``test_torch_std.jax_fast``.  The CUDA
kernels are #8's GEMMs and #10's kernel, held to these plain twins on the
card by chip_smoke.py (phases rev-kernel and neg-kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import modmath as jmodmath
from oece_tpu.fhe import pallas_kernels as pk
from oece_tpu_torch.fhe import negacyclic as ng
from oece_tpu_torch.fhe import rot
from oece_tpu_torch.fhe.params import Q27
from test_torch_std import jax_fast, one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("B,N", [(8, 128), (4, 256), (12, 128)])
def test_window_matches_pallas(B, N):
    R, M, Q = 8, 16, Q27
    rng = np.random.default_rng(4 + B + N)
    digs = rng.integers(-128, 128, (R, B, N)).astype(np.int8)
    kx = rng.integers(-128, 128, (R * M, 2 * N)).astype(np.int8)
    window = jax_fast(lambda d, k: pk.negacyclic_matmul_window(d, k, R, Q, max_b=8, interpret=True))
    want = np.asarray(window(pk.pack_digits_rows(jnp.asarray(digs)), jnp.asarray(pk.pack_keys_for_pallas(kx))))
    dig, ext = ng.pack_digits_rows(_t(digs)), _t(kx.reshape(R, M, 2 * N))
    got = ng.negacyclic_matmul_window(dig, ext, Q)
    assert got.dtype == torch.int32 and got.shape == (B, M // 4, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ng.window_matmul(dig, ng.build_diagonals(ext), R, Q).numpy(), want)
    ref = rot.combine_planes(ng.negacyclic_matmul_reference(_t(digs), _t(kx)), Q)
    np.testing.assert_array_equal(ref.numpy(), want)


@pytest.mark.parametrize("B,N", [(8, 128), (4, 256)])
def test_cmux_epilogue_matches_pallas(B, N):
    Q = Q27
    rng = np.random.default_rng(3 + N)
    P = rng.integers(0, Q, (B, 2, 2, N)).astype(np.int32)
    acc = rng.integers(0, Q, (B, 2, N)).astype(np.int32)
    a_col = rng.integers(0, 2 * N, (B,)).astype(np.int32)
    a_col[0] = 0
    c_pos = (2 * N - a_col) & (2 * N - 1)
    jP = jnp.asarray(P)
    rot_pos = jboot.monomial_rotate(jP[:, 0], jnp.asarray(c_pos), N, Q)
    rot_neg = jboot.monomial_rotate(jP[:, 1], jnp.asarray(a_col), N, Q)
    want = np.asarray(jmodmath.red31(jnp.asarray(acc) + rot_pos + rot_neg + (2 * Q - jP[:, 0] - jP[:, 1]), Q))
    pairs = np.stack([c_pos, a_col], axis=1)
    np.testing.assert_array_equal(ng.cmux_epilogue(_t(P), _t(acc), _t(pairs), Q).numpy(), want)
    for amt in (pairs, rng.integers(0, 2 * N, (B, 2)).astype(np.int32)):
        pallas = np.asarray(jax_fast(lambda P_, a_, m_: pk.cmux_epilogue_pallas(
            P_, a_, m_, Q, block_b=4, interpret=True))(jP, jnp.asarray(acc), jnp.asarray(amt)))
        np.testing.assert_array_equal(ng.cmux_epilogue(_t(P), _t(acc), _t(amt), Q).numpy(), pallas)
