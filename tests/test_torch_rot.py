"""The port's blind rotation (oece_tpu_torch.fhe.rot) on the CPU, bit for bit:

  * against the JAX megakernel ``pk.blind_rotate_rot_megakernel`` run in
    interpret mode, on device-keygen rev2 keys carried across with
    ``keys.from_jax`` (MICRO, MICRO_A; ragged batches, a=0 lanes);
  * against the golden rotated-difference step of tests/test_rot_form.py
    on synthetic RGSW material (MICRO, MICRO_A, one TOY step, and the
    STD128_OPT shape with n=2).

The CUDA kernel is checked against the same plain version on the card by
chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import devkeygen as jdevkeygen
from oece_tpu.fhe import golden
from oece_tpu.fhe import pallas_kernels as pk
from oece_tpu_torch.fhe import keys, rot
from oece_tpu_torch.fhe.params import MICRO, MICRO_A, STD128_OPT, TOY
from test_rot_form import _golden_rot_step, _rev2_from_brk
from test_torch_copies import jax_params

STD_N2 = dataclasses.replace(STD128_OPT, name="STD128_OPT_N2", n=2)


def _a2N(p, rng, B, n):
    scale = 2 * p.N // p.q  # valid amounts after the q -> 2N mod switch
    a = (scale * rng.integers(0, p.q, (B, n))).astype(np.int32)
    a[0] = 0  # identity lane: every step leaves it unchanged
    a[:, ::3] = 0
    return a


@pytest.fixture(scope="module", params=[MICRO, MICRO_A], ids=lambda p: p.name)
def jax_keys(request):
    p = request.param
    _, _, dkeys = jdevkeygen.device_keygen(jax_params(p), seed=7, layout="rev2")
    return p, dkeys


@pytest.mark.parametrize("B", [5, 37])
def test_rotation_matches_jax_megakernel(jax_keys, B):
    p, dkeys = jax_keys
    rng = np.random.default_rng(B)
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)
    a2N = _a2N(p, rng, B, p.n)
    want = np.asarray(pk.blind_rotate_rot_megakernel(
        jnp.asarray(acc), dkeys.ginx_rev2, jnp.asarray(a2N), p.Q, p.B_g,
        p.d_g_used, p.g_shift, interpret=True,
        zero_low_bits=max(0, int(np.log2(2 * p.N // p.q))),
    ))
    kt = keys.from_jax(dkeys)
    plain0 = rot.PLAIN_LAUNCHES
    got = rot.blind_rotate_rot(torch.from_numpy(acc), kt.rev2, torch.from_numpy(a2N), p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert rot.PLAIN_LAUNCHES == plain0 + 1
    # the identity lane saw a = 0 at every step
    np.testing.assert_array_equal(got[0].numpy(), acc[0])


@pytest.mark.parametrize(
    "params,steps",
    [(MICRO, 2), (MICRO_A, 2), (TOY, 1), (STD_N2, 2)],
    ids=["MICRO", "MICRO_A", "TOY", "STD128_OPT_n2"],
)
def test_rotation_matches_golden_steps(params, steps):
    p = params
    rng = np.random.default_rng(51)
    R = 2 * p.d_g_used
    brk = rng.integers(0, p.Q, (steps, 2, R, 2, p.N), dtype=np.int64)
    B = 5
    acc0 = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int64)
    a2N = _a2N(p, rng, B, steps)
    a2N[1, 0] = 0  # a lone a=0 step inside a live lane
    rev2 = keys.build_rev2(torch.from_numpy(brk.astype(np.int32)), p.Q)
    for i in range(steps):
        np.testing.assert_array_equal(
            rev2[i].numpy(), np.asarray(_rev2_from_brk(jax_params(p), brk[i, 0], brk[i, 1]))
        )
    want = acc0.copy()
    for i in range(steps):
        want = np.stack([
            _golden_rot_step(jax_params(p), want[b], int(a2N[b, i]), brk[i, 0], brk[i, 1])
            for b in range(B)
        ])
    got = rot.blind_rotate_rot_plain(
        torch.from_numpy(acc0.astype(np.int32)), rev2, torch.from_numpy(a2N), p
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_monomial_rotate_matches_golden():
    p = MICRO
    rng = np.random.default_rng(3)
    P = rng.integers(0, p.Q, (2 * p.N, 2, p.N)).astype(np.int32)
    c = np.arange(2 * p.N, dtype=np.int32)
    P[0, 0, :] = 0
    got = rot.monomial_rotate(torch.from_numpy(P), torch.from_numpy(c), p.N, p.Q).numpy()
    for b in range(2 * p.N):
        want = golden.negacyclic_monomial_mul(P[b].astype(np.int64), int(c[b]), p.N, p.Q)
        np.testing.assert_array_equal(got[b], want)


def test_wrapper_refuses_bad_input():
    p = MICRO_A
    nt = p.N // 128
    rows = (2 * nt - 1) * 2 * 2 * p.d_g_used * 128
    acc = torch.zeros((3, 2, p.N), dtype=torch.int32)
    rev2 = torch.zeros((2, rows, 1024), dtype=torch.int8)
    a2N = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        rot.blind_rotate_rot(acc.to(torch.int64), rev2, a2N, p)
    with pytest.raises(ValueError):
        rot.blind_rotate_rot(acc, rev2, torch.zeros((3, 3), dtype=torch.int32), p)
    with pytest.raises(ValueError):
        rot.blind_rotate_rot(acc, rev2, torch.zeros((2, 3), dtype=torch.int32).T, p)
    # no kernel and no plain fallback for a device other than the CPU or CUDA
    launches, plain = rot.LAUNCHES, rot.PLAIN_LAUNCHES
    with pytest.raises(ValueError, match="no kernel"):
        rot.blind_rotate_rot(acc.to("meta"), rev2.to("meta"), a2N.to("meta"), p)
    assert (rot.LAUNCHES, rot.PLAIN_LAUNCHES) == (launches, plain)


def test_kernel_build_location(monkeypatch):
    """The kernel library is built into the checkout's gitignored build
    directory, named by the sources' hash; without nvcc the build raises."""
    from oece_tpu_torch.fhe import _build

    so = _build.library_path()
    repo = _build.PKG_DIR.parent
    assert so.parent == repo / "build" / "oece_tpu_torch"
    assert "build/" in (repo / ".gitignore").read_text().split()
    assert [s.name for s in _build._sources()] == [
        "ap_step.cu", "negacyclic.cu", "rev_step.cu", "rot_step.cu", "std_step.cu", "int8_mm.cuh",
        "step_gemm.cuh", "wgmma_mm.cuh",
    ]
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
