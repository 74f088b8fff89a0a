"""The port's device keygen in the "rev" layout (oece_tpu_torch.fhe.devkeygen
layout="rev", the JAX package's default) on the CPU: fed JAX's threefry
draws, ``assemble`` reproduces ``_keygen_jit(..., "rev")`` bit for bit, and
one seed gives the port's rev and rev2 keys the same key material."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import devkeygen as jdevkeygen
from oece_tpu_torch.fhe import boot, devkeygen, lwe
from oece_tpu_torch.fhe.params import MICRO, MICRO_A
from test_torch_copies import jax_params
from test_torch_devkeygen import TRUTH, _jax_draws

T = 128


@pytest.mark.parametrize("params", [MICRO, MICRO_A], ids=lambda p: p.name)
def test_assemble_rev_matches_jax_keygen(params):
    words = jdevkeygen._seed_words(1234)
    _, _, rev_j, ksk = jdevkeygen._keygen_jit(jax_params(params), jnp.asarray(words), "rev")
    kt = devkeygen.assemble(params, *_jax_draws(params, words))  # the default layout
    assert kt.rev2 is None
    np.testing.assert_array_equal(kt.rev.numpy(), np.asarray(rev_j))
    np.testing.assert_array_equal(kt.ksk.numpy(), np.asarray(ksk))


def test_rev_and_rev2_keys_share_material():
    """One seed gives the port's rev and rev2 keys the same LWE secret and
    key-switch key, and the same refresh keys: rev's 16 planes
    (part, out, limb) regrouped by part are rev2's part-interleaved rows
    (tests/test_rot_form.py pins the same for the JAX package)."""
    p = MICRO_A
    words = np.array([5, 0, 0, 0, 0, 0, 0, 9], dtype=np.uint32)
    sk1, k1 = devkeygen.device_keygen(p, words, "cpu")  # the default layout
    sk2, k2 = devkeygen.device_keygen(p, words, "cpu", layout="rev2")
    assert k1.rev is not None and k1.rev2 is None and k2.rev is None
    np.testing.assert_array_equal(sk1.s, sk2.s)
    assert torch.equal(k1.ksk, k2.ksk)
    n, ndiag, R = p.n, 2 * p.N // T - 1, 2 * p.d_g_used
    regrouped = k1.rev.reshape(n, ndiag, R, T, 2, 8, T).permute(0, 1, 4, 2, 3, 5, 6)
    assert torch.equal(regrouped, k2.rev2.reshape(n, ndiag, 2, R, T, 8, T))
    # the rev keys evaluate gates
    rng = np.random.default_rng(2)
    B = 12
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    gids = (np.arange(B) % 6).astype(np.int32)
    c1 = torch.from_numpy(lwe.encrypt_bits(sk1, m1, rng))
    c2 = torch.from_numpy(lwe.encrypt_bits(sk1, m2, rng))
    out = boot.eval_bin_gate_batch(k1, torch.from_numpy(gids), c1, c2)
    truth = np.array([TRUTH[g](int(a), int(b)) for g, a, b in zip(gids, m1, m2)])
    np.testing.assert_array_equal(lwe.decrypt_bits(sk1, out.numpy()), truth)


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="unknown GINX key layout"):
        devkeygen.device_keygen(MICRO, np.zeros(8, np.uint32), "cpu", layout="rev3")
    with pytest.raises(ValueError, match="unknown GINX key layout"):
        devkeygen.assemble(MICRO, *[None] * 6, layout="ginx_pallas")
