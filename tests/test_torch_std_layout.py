"""The standard-form step loop on ginx_ext as csrc/rev_step.cu runs it on
the card, on the CPU, bit for bit (tolerance 0).

On the card the host-key rotation is rev's step loop with a ring of two
K-major blocks as its key source: step i's build (``std_build_kernel``,
Pallas #1) writes the step's block K-major, [16, T, (2nt-1)*RT], into slot
i & 1, then rev's digits kernel (with the previous step's CMUX) and its
split or tiled GEMM (#4's function) read that slot.  Here:

  * ``std.build_diagonals_kmajor_plain`` is the layout of
    ``keys.rev_step(..., kmajor=True)``, the row-major block
    (``rev_block``) transposed, one ``torch.take`` (chip_smoke's library
    form), and the JAX package's #1
    (``pk.build_diagonals_pallas`` in interpret mode, its plane
    permutation and diagonal order undone) at N = 256 and 512;
  * the build kernel's staged spans (``std.build_span``) rebuild the block;
  * the step loop over the ring, modelled tile by tile with the GEMM and
    CMUX models of tests/test_torch_rev_layout.py, equals
    ``std.blind_rotate_std_plain`` (STD128_OPT with n = 2, MICRO, TOY;
    B = 1, 4, 16, 17, 37; a=0 lanes);
  * a GEMM that finds another step's block in its slot (a build that
    landed too early or not at all) gives another rotation: the ring
    index, and the order of the build and the GEMMs around it, matter.

The CUDA kernels are held to the plain twins on the card by chip_smoke.py
(std-kernel).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import pallas_kernels as pk
from oece_tpu_torch.fhe import keys, std
from oece_tpu_torch.fhe.params import MICRO, STD128_OPT, TOY
from test_torch_rev_layout import _brk, _id, _inputs, _rotation_by_tiles
from test_torch_std import _undo_planes, jax_fast, one_torch_thread  # noqa: F401

T = 128
ROOT = Path(__file__).resolve().parents[1]
STD_N2 = dataclasses.replace(STD128_OPT, name="STD128_OPT_N2", n=2)


def _ext(p, n, seed):
    return keys.ginx_ext_planes(_brk(p, n, seed), p.Q)


@pytest.mark.parametrize("p", [MICRO, TOY], ids=_id)
def test_kmajor_build_is_the_rev_step_layout(p):
    """The K-major twin == keys.rev_step(kmajor=True) of the same refresh
    keys == the row-major block transposed; the wrapper runs it on the
    CPU."""
    brk = _brk(p, 1, seed=p.N)
    ext = keys.ginx_ext_planes(brk, p.Q)[0]
    idx = keys.rev_index(p.N, "cpu")
    got = std.build_diagonals_kmajor_plain(ext, idx)
    assert torch.equal(got, keys.rev_step(brk[0], p.Q, idx, kmajor=True))
    rm = std.build_diagonals_plain(ext, idx)
    assert torch.equal(got, rm.t().reshape(16, T, rm.shape[0]))
    plain0 = std.PLAIN_LAUNCHES
    assert torch.equal(std.build_diagonals_kmajor(ext), got)
    assert std.PLAIN_LAUNCHES == plain0 + 1


def test_kmajor_build_is_one_take():
    """#1 K-major is a pure byte gather too: chip_smoke's library form, one
    torch.take through kmajor_take_index, gives the K-major twin."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rng = np.random.default_rng(13)
    for N, R in [(128, 4), (256, 8)]:
        ext = torch.from_numpy(rng.integers(-128, 128, (R, 16, 2 * N)).astype(np.int8))
        want = std.build_diagonals_kmajor_plain(ext, keys.rev_index(N, "cpu"))
        assert torch.equal(torch.take(ext, cs.kmajor_take_index(N, R, "cpu")), want)


@pytest.mark.parametrize("N, R", [(128, 8), (512, 4), (1024, 4)])
def test_build_spans_rebuild_the_block(N, R):
    """Block (m, r, d') of the build kernel writes entry [m, t, d'*RT +
    r*T + u] = span[127 - t + u] of its staged span: every entry of the
    K-major block."""
    ext = torch.from_numpy(np.random.default_rng(N + R).integers(-128, 128, (R, 16, 2 * N)).astype(np.int8))
    want = std.build_diagonals_kmajor_plain(ext, keys.rev_index(N, "cpu"))
    ndiag, RT = 2 * N // T - 1, R * T
    window = 127 - torch.arange(T)[:, None] + torch.arange(T)[None, :]  # [t, u]
    got = torch.empty_like(want)
    for m in range(16):
        for r in range(R):
            for dp in range(ndiag):
                got[m, :, dp * RT + r * T:dp * RT + (r + 1) * T] = std.build_span(ext, m, r, dp)[window]
    assert torch.equal(got, want)


@pytest.mark.parametrize("N, R", [(256, 4), (512, 4)])
def test_kmajor_build_matches_pallas(N, R):
    """#1 on random key bytes: the K-major block == the interpret-mode
    Pallas build, reversed, un-permuted and transposed."""
    rng = np.random.default_rng(N + R)
    ext = rng.integers(-128, 128, (R, 16, 2 * N)).astype(np.int8)
    wins = jnp.asarray(pk.pack_keys_for_pallas(ext.reshape(R * 16, 2 * N)))
    dense = np.asarray(jax_fast(lambda w: pk.build_diagonals_pallas(w, R, interpret=True))(wins))
    rows = (2 * N // T - 1) * R * T
    want = _undo_planes(dense)[::-1].reshape(rows, 16 * T).T.reshape(16, T, rows)
    got = std.build_diagonals_kmajor_plain(torch.from_numpy(ext), keys.rev_index(N, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def _ring_blocks(ext, skip=(), early=()):
    """block_of(i) of the step loop over a ring of two slots: build(i) fills
    slot i & 1, the GEMM of step i reads it.  Hazards: a build in ``skip``
    never lands (its GEMM finds step i-2's block), a build in ``early``
    lands in the slot before the GEMM of step i-2 has read it."""
    N = ext.shape[-1] // 2
    idx = keys.rev_index(N, "cpu")
    ring = torch.zeros((2, 16, T, (2 * N // T - 1) * ext.shape[1] * T), dtype=torch.int8)

    def block_of(i):
        if i + 2 in early:
            ring[i & 1] = std.build_diagonals_kmajor_plain(ext[i + 2], idx)
        elif i not in skip:
            ring[i & 1] = std.build_diagonals_kmajor_plain(ext[i], idx)
        return ring[i & 1]

    return block_of


@pytest.mark.parametrize("p, B", [(STD_N2, 17), (dataclasses.replace(MICRO, n=3), 1),
                                  (dataclasses.replace(MICRO, n=3), 16), (dataclasses.replace(MICRO, n=3), 37),
                                  (dataclasses.replace(TOY, n=2), 4)], ids=_id)
def test_ring_loop_by_tiles_equals_plain_rotation(p, B):
    """Build into slot i & 1, then the digits kernel's CMUX and digits and
    the split (B <= 16) or tiled GEMM on that slot == blind_rotate_std_plain
    on ginx_ext; the a=0 lane comes back unchanged."""
    acc, a2N = _inputs(p, B, p.n, seed=11 * B)
    ext = _ext(p, p.n, seed=B + p.N)
    got = _rotation_by_tiles(acc, _ring_blocks(ext), a2N, p)
    assert torch.equal(got, std.blind_rotate_std_plain(acc, ext, a2N, p))
    assert torch.equal(got[0], acc[0])


@pytest.mark.parametrize("hazard", ["build 2 skipped", "build 2 before GEMM 0"])
def test_stale_slot_gives_another_rotation(hazard):
    """A GEMM that reads a slot holding another step's block computes the
    rotation of another key: step 2 on step 0's block (its build never
    landed), or step 0 on step 2's (build 2 overwrote slot 0 before GEMM 0
    read it).  Both differ from the rotation."""
    p, B = dataclasses.replace(MICRO, n=3), 4
    acc, _ = _inputs(p, B, p.n, seed=5)
    a2N = torch.from_numpy(np.random.default_rng(6).integers(1, 2 * p.N, (B, p.n)).astype(np.int32))
    ext = _ext(p, p.n, seed=6)
    swapped = ext.clone()
    if hazard == "build 2 skipped":
        swapped[2] = ext[0]
        block_of = _ring_blocks(ext, skip=(2,))
    else:
        swapped[0] = ext[2]
        block_of = _ring_blocks(ext, early=(2,))
    got = _rotation_by_tiles(acc, block_of, a2N, p)
    assert torch.equal(got, std.blind_rotate_std_plain(acc, swapped, a2N, p))
    assert not torch.equal(got, std.blind_rotate_std_plain(acc, ext, a2N, p))
