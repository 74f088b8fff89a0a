"""The K-major rev key and the tiling of the rev step's GEMMs
(oece_tpu_torch/csrc/rev_step.cu on step_gemm.cuh's ``gemm_tiled`` and
``gemm_split``), on the CPU, bit for bit (tolerance 0).

On the card rev is K-major, [n, 16, T, (2nt-1)*RT], each step's block
transposed (keys.py); the GEMMs read it by TMA boxes of 4 planes (the limbs
of one output poly) x 16 coefficients x 128 contraction bytes.  The tiled
GEMM (B > 16) takes one per stage of an output tile for each math
warpgroup and the digits by boxes of NB gates, and writes the
limb-combined products mod Q; the split GEMM (B <= 16) one per stage of a
diagonal, all output tiles at once against digit tiles it keeps in shared
memory, and adds partial sums that the next digits kernel reduces mod Q
and applies in its CMUX.  The one rule of the GEMM's shape and its tiling
(``rot.gemm_config``, ``rot.split_groups``, ``rot.gemm_tiles``, at RT/128
digit substages and 4 or 2 output polys) and the box origins
(``rot.key_box_origin``, ``rot.split_digit_box``, the rotated form's)
repeat the kernels' choices.  Here:

  * the K-major conversion (``keys.rev_to``) and the K-major step blocks
    that ``build_rev`` writes on the card (``kmajor=True`` here) equal each
    step's block transposed, for a ``keys.from_jax`` rev key from the JAX
    ``device_keygen`` and for ``build_rev``, and convert back;
  * the boxes at their origins rebuild every A tile of every stage from
    the K-major key (STD128_OPT widths with n=2, MICRO, TOY);
  * the digits times those tiles, summed stage by stage over NB-gate tiles
    padded with zero rows (the tiled GEMM's from the digit scratch,
    ``rot.digit_scratch``, the split GEMM's as the TMA unit pads them; digit
    chunks outside the key's range read as zeros), combined through the
    epilogue's (limb, coefficient) rows, equal
    ``rev.window_matmul_true_plain`` (#8, M = 16 and 8) and
    ``rev.window_matmul_dec_true_plain`` (#9), and, with the digits
    kernel's CMUX applying each step's products (the split
    GEMM's sums reduced mod Q on read) before the next step's digits,
    ``rev.rev_step_plain`` and ``rev.blind_rotate_rev_plain`` (ragged B
    with 16 and 17, a=0 lanes, both GEMMs).

The plain twins are held to the JAX package in tests/test_torch_rev*.py;
the CUDA kernels to them on the card by chip_smoke.py (rev-kernel).
"""

import dataclasses

import numpy as np
import pytest
import torch

from oece_tpu.fhe import devkeygen as jdevkeygen
from oece_tpu_torch.fhe import keys, modmath, rev, rot
from oece_tpu_torch.fhe.params import MICRO, STD128_OPT, TOY
from test_torch_copies import jax_params
from test_torch_std import one_torch_thread  # noqa: F401

T = 128
BK, CHUNK = rot.GEMM_BK, rot.GEMM_CHUNK
STD_N2 = dataclasses.replace(STD128_OPT, name="STD128_OPT_N2", n=2)


def _brk(p, n, seed):
    rng = np.random.default_rng(seed)
    R = 2 * p.d_g_used
    return torch.from_numpy(rng.integers(0, p.Q, (n, 2, R, 2, p.N)).astype(np.int32))


def _transposed(rev_key):
    """Each step's row-major block transposed, as [n, 16, T, rows]."""
    n, rows, _ = rev_key.shape
    return rev_key.transpose(1, 2).reshape(n, 16, T, rows)


def _id(x):
    return getattr(x, "name", str(x))


def test_kmajor_from_jax_rev():
    """A JAX device-keygen rev key carried across by from_jax stays
    row-major on the CPU; its K-major form is each block transposed, and
    converts back."""
    p = MICRO
    _, _, dkeys = jdevkeygen.device_keygen(jax_params(p), seed=7, layout="rev")
    kt = keys.from_jax(dkeys)
    R = 2 * p.d_g_used
    assert kt.rev.shape == keys.rev_shape(p.n, R, p.N, kmajor=False)
    kT = keys.rev_to(kt.rev, "cpu", kmajor=True)
    assert kT.shape == keys.rev_shape(p.n, R, p.N, kmajor=True)
    assert torch.equal(kT, _transposed(kt.rev))
    assert torch.equal(keys.rev_to(kT, "cpu"), kt.rev)
    assert keys.rev_to(kt.rev, "cpu") is kt.rev  # the CPU layout already
    assert torch.equal(kt.to("cpu").rev, kt.rev)


@pytest.mark.parametrize("p, n", [(MICRO, 3), (TOY, 2), (STD_N2, 1)], ids=_id)
def test_build_rev_kmajor(p, n):
    """The step blocks build_rev writes on the card (rev_step K-major), from
    the same refresh keys, are the CPU's row-major blocks transposed; so is
    rev_to's conversion, and the CPU's blocks are rev_block of the
    ginx_ext planes."""
    brk = _brk(p, n, seed=n + p.N)
    rm = keys.build_rev(brk, p.Q)
    R = 2 * p.d_g_used
    assert rm.shape == keys.rev_shape(n, R, p.N, kmajor=False)
    idx = keys.rev_index(p.N, "cpu")
    ext = keys.ginx_ext_planes(brk, p.Q)
    assert torch.equal(rm[0], keys.rev_block(ext[0], idx))
    km = keys.build_rev(brk, p.Q, kmajor=True)
    assert km.shape == keys.rev_shape(n, R, p.N, kmajor=True)
    assert torch.equal(km, _transposed(rm))
    assert torch.equal(torch.stack([keys.rev_step(brk[i], p.Q, idx, kmajor=True) for i in range(n)]), km)
    assert torch.equal(keys.rev_to(rm, "cpu", kmajor=True), km)
    assert torch.equal(keys.rev_to(km, "cpu", kmajor=False), rm)


def _a_tile(keyT_i, x, cc):
    """The A tile of column chunk cc at contraction byte x: the box of 4
    planes x 16 coefficients x 128 bytes at its origin, as 64 rows (limb l
    at rows 16l)."""
    planes, _, rows = keyT_i.shape
    x, t0, plane = rot.key_box_origin(x, cc)
    assert 0 <= x and x + BK <= rows and t0 + CHUNK <= T and plane + 4 <= planes
    return keyT_i[plane:plane + 4, t0:t0 + CHUNK, x:x + BK].reshape(4 * CHUNK, BK)


@pytest.mark.parametrize("p", [STD_N2, MICRO, TOY], ids=_id)
def test_key_boxes_rebuild_every_tile(p):
    """Every A tile of every stage, for every output tile k and column
    chunk cc = (poly o, t0) of the 32, is the row-major block's
    contraction rows (nt-1-k)*RT + 128c .. +127 at the columns (o*4 + l)*T
    + t0 + j, ordered (l, j), transposed; the split GEMM's stages (d', s)
    cover every diagonal once."""
    n = min(p.n, 2)
    rm = keys.build_rev(_brk(p, n, seed=3), p.Q)
    km = keys.rev_to(rm, "cpu", kmajor=True)
    nt, RT = p.N // T, 2 * p.d_g_used * T
    t = torch.arange(CHUNK)
    for i in range(n):
        for cc in range(4 * T // CHUNK):
            o, t0 = divmod(cc, T // CHUNK)
            cols = torch.cat([(o * 4 + limb) * T + t0 * CHUNK + t for limb in range(4)])
            for k in range(nt):
                x0 = (nt - 1 - k) * RT
                want = rm[i, x0:x0 + nt * RT][:, cols].t()  # [64, K]
                got = torch.cat([_a_tile(km[i], x0 + c * BK, cc) for c in range(nt * RT // BK)], dim=1)
                assert torch.equal(got, want), (i, k, cc)
            full = torch.cat([_a_tile(km[i], x, cc) for x in range(0, (2 * nt - 1) * RT, BK)], dim=1)
            assert torch.equal(full, rm[i][:, cols].t())


def _combine(d, Q):
    """[64 key columns x NB gates] limb sums -> their combine mod Q, [NB
    gates, 16 coefficients]: coefficient t combines rows 16l + t."""
    limbs = d.to(torch.int32).view(4, CHUNK, -1).permute(2, 1, 0)  # [gate, t, limb]
    return modmath.combine_limbs_mod_q(limbs, Q)


def _gemm_by_tiles(dig, keyT_i, R, Q):
    """The step GEMM as rev_step.cu computes it, on digits int8 [B, K] and
    one step's K-major block [4*polys, T, rows], the digits in the step's
    digit scratch (``rot.digit_scratch``): gates padded to the NB-gate tile
    with zero rows (the tiled GEMM's from the scratch, the split GEMM's as
    the TMA unit pads them), A tiles from the key's boxes, sums of A_c x
    dig_c^T stage by stage (float64, exact: |sum| <= 2**26), each coefficient t of a 16-coefficient chunk combining
    rows 16l + t (l = 0..3) mod Q.  Returns (out int [B, polys, N], split):
    the tiled GEMM's products in [0, Q), or the split GEMM's sums of one
    partial product per diagonal group (each in [0, Q))."""
    B, K = dig.shape
    polys = keyT_i.shape[0] // 4
    RT = R * T
    nt = K // RT
    N, sub = nt * T, RT // BK
    NB, MW, split = rot.gemm_config(B, N, R, polys)
    scratch = rot.digit_scratch(B, K, NB, dig.device)
    scratch[:B] = dig
    padded = torch.zeros((-(-B // NB) * NB, K), dtype=torch.float64)
    padded[:scratch.shape[0]] = scratch.double()
    chunk = lambda q, rows: rows[:, q * BK:(q + 1) * BK]  # noqa: E731
    out = torch.zeros((B, polys, N), dtype=torch.int64)
    if split:  # per block (group, cc): one [64 x 8NB] product per stage, k = column // NB
        dpg, groups = rot.split_groups(N, polys)
        for grp in range(groups):
            d_lo, d_hi = grp * dpg, min(grp * dpg + dpg, 2 * nt - 1)
            tiles = torch.zeros((sub, dpg + 7, NB, BK), dtype=torch.float64)
            for c in range(sub):
                j0, c_box = rot.split_digit_box(c, d_lo, N)
                for jj in range(dpg + 7):
                    if 0 <= j0 + jj < nt:  # else the TMA unit reads zeros
                        tiles[c, jj] = chunk((j0 + jj) * sub + c_box, padded)
            for cc in range(polys * T // CHUNK):
                o, t0 = divmod(cc, T // CHUNK)
                t0 *= CHUNK
                d = torch.zeros((4 * CHUNK, 8 * NB), dtype=torch.float64)
                for dd in range(d_lo, d_hi):
                    for s in range(sub):
                        a = _a_tile(keyT_i, dd * RT + s * BK, cc).double()
                        d += a @ tiles[s, dd - d_lo:dd - d_lo + 8].reshape(8 * NB, -1).t()
                for k in range(nt):
                    comb = _combine(d[:, k * NB:(k + 1) * NB], Q)[:B]
                    assert (comb >= 0).all() and (comb < Q).all()
                    out[:, o, k * T + t0:k * T + t0 + CHUNK] += comb
        assert (out < 8 * Q).all()
        return out.to(torch.int32), True
    out -= 1
    for gt, k, ct in rot.gemm_tiles(B, N, R, polys):
        b_tile = padded[gt * NB:(gt + 1) * NB]
        for w in range(MW):
            cc = ct * MW + w
            o, t0 = divmod(cc, T // CHUNK)
            t0 *= CHUNK
            d = torch.zeros((4 * CHUNK, NB), dtype=torch.float64)
            for c in range(nt * sub):
                a = _a_tile(keyT_i, (nt - 1 - k) * RT + c * BK, cc).double()
                d += a @ chunk(c, b_tile).t()
            n_live = min(NB, B - gt * NB)
            out[gt * NB:gt * NB + n_live, o, k * T + t0:k * T + t0 + CHUNK] = _combine(d, Q)[:n_live]
    assert (out >= 0).all() and (out < Q).all()  # every output written, mod Q
    return out.to(torch.int32), False


def _cmux(acc, prod, split, a, p):
    """The digits kernel's CMUX of a step's products: the split GEMM's
    sums reduced mod Q on read (red31), then red31(acc + X^c0 P0 + X^c1
    P1 + 2Q - P0 - P1) with (c0, c1) = (2N - a, a)."""
    B, _, N = acc.shape
    P = modmath.red31(prod, p.Q) if split else prod
    return rev.cmux_epilogue_true_plain(P.reshape(B, 2, 2, N), acc, rot.amount_pairs(a, N), p.Q)


def _rotation_by_tiles(acc, block_of, a2N, p):
    """rev_step.cu's step loop over a2N.shape[1] steps: block_of(i) gives
    step i's K-major block (a step of the rev key, or on ginx_ext the ring
    slot that step i's build filled); step i's digits kernel applies step
    i-1's CMUX and takes the digits of the result, step i's GEMM makes its
    products; one more digits launch applies the last CMUX."""
    prev = None
    for i in range(a2N.shape[1]):
        if prev is not None:
            acc = _cmux(acc, *prev, a2N[:, i - 1], p)
        prev = _gemm_by_tiles(rot.tile_digits(acc, p), block_of(i), 2 * p.d_g_used, p.Q)
    return _cmux(acc, *prev, a2N[:, -1], p)


def _inputs(p, B, n, seed):
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32))
    scale = 2 * p.N // p.q
    a2N = (scale * rng.integers(0, p.q, (B, n))).astype(np.int32)
    a2N[0] = 0
    a2N[:, ::3] = 0
    return acc, torch.from_numpy(a2N)


@pytest.mark.parametrize("p, M, B", [(STD_N2, 16, 16), (STD_N2, 8, 17), (STD_N2, 16, 5), (MICRO, 8, 3),
                                     (MICRO, 16, 40), (TOY, 16, 13), (TOY, 8, 37)], ids=_id)
def test_gemm_by_tiles_equals_plain_products(p, M, B):
    """#8 and #9 alone: the GEMM on random digits (#8) and on an
    accumulator's digits (#9) against one K-major block of M planes, the
    split GEMM's sums taken mod Q as rev_reduce_kernel does, ==
    window_matmul_true_plain / window_matmul_dec_true_plain."""
    rng = np.random.default_rng(M + B)
    R, nt = 2 * p.d_g_used, p.N // T
    block = torch.from_numpy(rng.integers(-128, 128, ((2 * nt - 1) * R * T, M * T)).astype(np.int8))
    blockT = block.t().reshape(M, T, -1).contiguous()
    dig = torch.from_numpy(rng.integers(-128, 128, (B, nt * R * T)).astype(np.int8))
    acc, _ = _inputs(p, B, 1, seed=B)
    for digits, want in ((dig, rev.window_matmul_true_plain(dig, block, p.Q)),
                         (rot.tile_digits(acc, p), rev.window_matmul_dec_true_plain(acc, block, p))):
        out, split = _gemm_by_tiles(digits, blockT, R, p.Q)
        assert split == (B <= 16 and rot.gemm_config(B, p.N, 2 * p.d_g_used, M // 4)[2])
        got = modmath.red31(out, p.Q) if split else out
        assert torch.equal(got, want)


@pytest.mark.parametrize("p, B", [(MICRO, 1), (MICRO, 16), (MICRO, 300), (TOY, 5), (TOY, 37),
                                  (STD_N2, 13), (STD_N2, 17)], ids=_id)
def test_gemm_by_tiles_equals_plain_step(p, B):
    """One step (#9, then #10's CMUX with (2N - a, a)), lane 0 with a=0:
    the split (B <= 16) or the tiled GEMM and the digits kernel's CMUX ==
    rev_step_plain, and the a=0 lane comes back unchanged."""
    acc, a2N = _inputs(p, B, 1, seed=B)
    a2N[:, 0] = torch.from_numpy(np.random.default_rng(B).integers(0, 2 * p.N, B).astype(np.int32))
    a2N[0] = 0
    rm = keys.build_rev(_brk(p, 1, seed=B), p.Q)
    km = keys.rev_to(rm, "cpu", kmajor=True)
    got = _rotation_by_tiles(acc, km.__getitem__, a2N, p)
    assert torch.equal(got, rev.rev_step_plain(acc, a2N[:, 0], rm[0], p))
    assert torch.equal(got[0], acc[0])


@pytest.mark.parametrize("p, B", [(dataclasses.replace(MICRO, n=3), 5), (dataclasses.replace(TOY, n=2), 17),
                                  (STD_N2, 4), (STD_N2, 16)], ids=_id)
def test_gemm_by_tiles_equals_plain_rotation(p, B):
    """The step loop of oece_blind_rotate_rev, step i on the K-major key's
    step i, == blind_rotate_rev_plain on the row-major key."""
    acc, a2N = _inputs(p, B, p.n, seed=7 * B)
    rm = keys.build_rev(_brk(p, p.n, seed=B), p.Q)
    km = keys.rev_to(rm, "cpu", kmajor=True)
    got = _rotation_by_tiles(acc, km.__getitem__, a2N, p)
    assert torch.equal(got, rev.blind_rotate_rev_plain(acc, rm, a2N, p))
    assert torch.equal(got[0], acc[0])
