"""The port's standard-form GINX step and rotation (oece_tpu_torch.fhe.std)
on the CPU, bit for bit (tolerance 0), against ``boot._external_cmux_pallas``
(Pallas kernels #1 and #4 in interpret mode), ``boot._external_cmux_ginx``
(the jnp path) and the golden standard step, with a=0 lanes, at MICRO,
MICRO_A and TOY with n cut, on random RGSW key material
(tests/test_torch_std_rotation_wide.py: the STD128 / STD128_OPT shapes)."""

import jax.numpy as jnp
import numpy as np
import pytest

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import golden as jgolden
from oece_tpu_torch.fhe import keys, std
from test_torch_std import _fake_bk, _t, both, jax_fast
from test_torch_copies import port_bootstrap_key


def _a2N(p, rng, B, n):
    a = rng.integers(0, 2 * p.N, (B, n)).astype(np.int32)
    a[0] = 0  # identity lane
    a[1, 0] = 0  # a lone a=0 step inside a live lane
    return a


def _golden_std_step(jp, acc, a, brk_pos_i, brk_neg_i):
    """golden.blind_rotate_ginx's loop body for one gate (skipped at a=0)."""
    N, Q = jp.N, jp.Q
    if a == 0:
        return acc
    p_pos = jgolden.external_product(jp, acc, brk_pos_i)
    p_neg = jgolden.external_product(jp, acc, brk_neg_i)
    rot_pos = jgolden.negacyclic_monomial_mul(p_pos, 2 * N - a, N, Q)
    rot_neg = jgolden.negacyclic_monomial_mul(p_neg, a, N, Q)
    return (acc + rot_pos - p_pos + rot_neg - p_neg) % Q


STEP_CASES = [("MICRO", {}, 2, 5), ("MICRO_A", {}, 2, 5), ("TOY", {"n": 2}, 2, 3)]


@pytest.mark.parametrize("name,kw,steps,B", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_rotation_matches_jax_and_golden(name, kw, steps, B, monkeypatch):
    monkeypatch.setattr(jboot, "PALLAS_INTERPRET", True)
    check_rotation(name, kw, steps, B)


def check_rotation(name, kw, steps, B):
    """n = steps of random keys: port plain == golden, and == both JAX
    steps (one step alone, then the whole rotation).  The caller sets
    boot.PALLAS_INTERPRET."""
    jp, pp = both(name, **kw)
    rng = np.random.default_rng(len(name))
    bk = _fake_bk(jp, rng, steps)
    acc0 = rng.integers(0, jp.Q, (B, 2, jp.N)).astype(np.int32)
    a2N = _a2N(jp, rng, B, steps)
    kt = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    got = std.blind_rotate_std(_t(acc0), kt.ginx_ext, _t(a2N), pp).numpy()
    # the golden standard form
    want = acc0.astype(np.int64)
    for i in range(steps):
        want = np.stack([
            _golden_std_step(jp, want[b], int(a2N[b, i]), bk.brk_pos[i], bk.brk_neg[i])
            for b in range(B)
        ])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], acc0[0])
    # JAX: the Pallas step (#1 + #4 in interpret mode) and the jnp step
    dk_pallas = jboot.pack_bootstrap_key(bk, use_pallas=True)
    dk_jnp = jboot.pack_bootstrap_key(bk, use_pallas=False)
    i_ = jnp.arange(jp.N, dtype=jnp.int32)
    idx2n = (i_[None, :] - i_[:, None]) & (2 * jp.N - 1)
    step_p = jax_fast(lambda acc, a, k: jboot._external_cmux_pallas(acc, a, k, jp))
    step_j = jax_fast(lambda acc, a, k: jboot._external_cmux_ginx(acc, a, k, idx2n, jp))
    acc_p = acc_j = jnp.asarray(acc0)
    for i in range(steps):
        a_col = jnp.asarray(a2N[:, i])
        acc_p = step_p(acc_p, a_col, dk_pallas.ginx_pallas[i])
        acc_j = step_j(acc_j, a_col, dk_jnp.ginx_kext[i])
        if i == 0:  # one step alone
            one = std.std_step_plain(
                _t(acc0), _t(a2N[:, 0]), kt.ginx_ext[0], keys.rev_index(pp.N, "cpu"), pp
            )
            np.testing.assert_array_equal(one.numpy(), np.asarray(acc_p))
    np.testing.assert_array_equal(got, np.asarray(acc_p))
    np.testing.assert_array_equal(got, np.asarray(acc_j))
