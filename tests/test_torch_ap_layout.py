"""The AP rotation's on-chip key tiles, live-gate table and dead-step skip
(oece_tpu_torch/csrc/ap_step.cu) on the CPU, bit for bit (tolerance 0).

On the card the step GEMMs make their 64 x 128-byte key tiles from the
step's compact key ``ap_ext[s]`` [R, 8, 2N] as it is: each tile's span of
each limb plane is staged in shared memory by 16-byte loads, then each
thread reads the 5 words that hold 16 bytes of a row, shifts them into
place, reverses their bytes and stores them in the 128-byte swizzle
(``ap.span_start``, ``ap.span_offset``, ``ap.swizzled_chunk``).  Once per rotation a
kernel writes each step's live-gate table (``ap.live_table_plain`` is its
twin); a step without a live gate launches nothing, a live step runs its
digits and GEMM over its live gates in compact rows (``rot.gemm_config``
with ``ap.split_smem``:
the split GEMM's diagonal groups add combined partial sums, the tiled GEMM
stores the combine) and the next digits kernel writes the products back
to their gates.  Here:

  * the word-level emulation of the tile assembly rebuilds every tile of
    ``keys.rev_block`` at MICRO_AP2, TOY_AP2 and STD128_OPT (n = 1);
  * the table and the step loop run by compact rows and diagonal groups
    in torch equal ``ap.blind_rotate_ap_plain``: all amounts 0 (every step
    dead), mod-switch amounts (digit 0 dead where
    2N/q = 2), any amounts, B = 1, 5, 17, 37 (STD128_OPT: 5 and 37);
  * the wrapper refuses an ``ap_ext`` in any other layout before a launch.

The plain version is held to the JAX megakernel in tests/test_torch_ap.py;
the CUDA kernels to it on the card by chip_smoke.py (ap-kernel).
"""

import dataclasses

import numpy as np
import pytest
import torch

from oece_tpu_torch.fhe import ap, keys, rot
from oece_tpu_torch.fhe.modmath import red31
from oece_tpu_torch.fhe.params import MICRO_A, STD128_OPT, TOY
from test_torch_std import one_torch_thread  # noqa: F401

T = 128
MICRO_AP2 = dataclasses.replace(MICRO_A, name="MICRO_AP2", B_r=2)
TOY_AP2 = dataclasses.replace(TOY, name="TOY_AP2", n=2, B_r=2)
STD_AP_N1 = dataclasses.replace(STD128_OPT, name="STD128_OPT_AP_N1", n=1)
SETS = [MICRO_AP2, TOY_AP2, STD_AP_N1]


def _id(x):
    return getattr(x, "name", str(x))


def _ext(p, steps, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-128, 128, (steps, 2 * p.d_g_used, 8, 2 * p.N), dtype=torch.int8, generator=g)


def _tile_by_spans(ext_s, dp, r, cc, N):
    """The A tile of column chunk cc at diagonal dp and digit row r as the
    kernels make it: each limb plane's span (SPAN bytes from span_start,
    mod 2N, by 16-byte chunks) staged as 32-bit words, then per (row rho,
    chunk q) the 5 words from span_offset//4, the funnel shift by
    span_offset%4 bytes, the bytes reversed, stored at the swizzled
    offset; read back as wgmma's descriptor sees it, [64 rows, 128 bytes]."""
    o, t0 = divmod(cc, T // ap.GEMM_CHUNK)
    t0 *= ap.GEMM_CHUNK
    start = ap.span_start(dp, t0, N)
    assert start % 16 == 0
    planes = ext_s[r, 4 * o:4 * o + 4].numpy().view(np.uint8)  # [limb, 2N]
    spans = planes[:, (start + np.arange(ap.SPAN)) % (2 * N)]  # [limb, SPAN]
    words = spans.copy().view("<u4").astype(np.uint64)  # [limb, SPAN/4]
    rho = np.arange(64)[:, None]
    q = np.arange(8)[None, :]
    a = ap.span_offset(rho % ap.GEMM_CHUNK, q)  # [64, 8]
    assert a.min() >= 0 and (a // 4 + 4).max() < ap.SPAN // 4
    w5 = words[(rho // ap.GEMM_CHUNK)[..., None], a[..., None] // 4 + np.arange(5)]  # [64, 8, 5]
    sh = ((a % 4) * 8)[..., None].astype(np.uint64)
    v = ((w5[..., :4] | (w5[..., 1:] << np.uint64(32))) >> sh) & np.uint64(0xFFFFFFFF)
    ascending = v.astype("<u4").view(np.uint8).reshape(64, 8, 16)
    smem = np.zeros(64 * ap.GEMM_BK, dtype=np.uint8)
    at = ap.swizzled_chunk(rho, q)[..., None] + np.arange(16)  # [64, 8, 16]
    smem[at] = ascending[..., ::-1]
    return smem[at].reshape(64, ap.GEMM_BK).view(np.int8)


@pytest.mark.parametrize("p", SETS, ids=_id)
def test_key_tiles_rebuild_rev_block(p):
    """Every tile (d', r, cc) is the rev block's contraction rows d'*RT +
    r*T .. +127 at the columns (4o + l)*T + t0 + j, ordered (l, j),
    transposed."""
    ext_s = _ext(p, 1, seed=p.N)[0]
    R, nt = ext_s.shape[0], p.N // T
    rev = keys.rev_block(ext_s, keys.rev_index(p.N, "cpu")).numpy()
    for cc in range(2 * T // ap.GEMM_CHUNK):
        o, t0 = divmod(cc, T // ap.GEMM_CHUNK)
        cols = np.concatenate([(4 * o + limb) * T + t0 * ap.GEMM_CHUNK + np.arange(ap.GEMM_CHUNK)
                               for limb in range(4)])
        for dp in range(2 * nt - 1):
            for r in range(R):
                rows = slice((dp * R + r) * T, (dp * R + r + 1) * T)
                np.testing.assert_array_equal(_tile_by_spans(ext_s, dp, r, cc, p.N), rev[rows][:, cols].T)


def test_swizzle_and_spans():
    assert [ap.swizzled_chunk(9, q) // 16 - 8 * 9 for q in range(8)] == [q ^ 1 for q in range(8)]
    N = STD128_OPT.N
    # diagonal 0, coefficients 0 ..: row byte u at (nt-1)*T + tt - u, span from (nt-1)*T - 128
    assert ap.span_start(0, 0, N) == 6 * T
    assert ap.span_start(14, 16, N) == (-7 * T + 16 - 128) % (2 * N)  # the last diagonal wraps
    # chunk q of row tt: bytes u = 16q+15 .. 16q at span bytes 113 + tt - 16q ..
    assert [ap.span_offset(tt, q) for tt, q in ((0, 7), (15, 0))] == [1, 128]


def _amounts(p, B, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        a = np.zeros((B, p.n))
    elif kind == "modswitch":
        a = (2 * p.N // p.q) * rng.integers(0, p.q, (B, p.n))
    else:
        a = rng.integers(0, 2 * p.N, (B, p.n))
    return torch.from_numpy(a.astype(np.int32))


def _compact_rows(mask, rank0, s, B):
    """The gates of step s by compact row, from the table as the kernels
    read it."""
    rows = {}
    for b in range(B):
        m, bit = int(mask[s, b // 32]), 1 << (b % 32)
        if m & bit:
            rows[int(rank0[s, b // 32]) + bin(m & (bit - 1)).count("1")] = b
    return torch.tensor([rows[i] for i in range(len(rows))], dtype=torch.int64)


def _rotate_by_tiles(acc, ap_ext, a2N, p):
    """The CUDA step loop: skip steps whose count is 0; gather the live
    gates by compact row, their digits, the split GEMM's diagonal groups
    (each combined mod Q, summed < 8Q, red31) or the tiled GEMM's whole
    contraction, and the write-back to the gates.  Returns the result and
    the number of live steps."""
    B, _, N = acc.shape
    mask, rank0, count = ap.live_table_plain(a2N, p)
    nt, RT = N // T, 2 * p.d_g_used * T
    idx = keys.rev_index(N, "cpu")
    out, live_steps = acc.clone(), 0
    for s in range(ap_ext.shape[0]):
        L = int(count[s])
        if L == 0:
            continue
        live_steps += 1
        gates = _compact_rows(mask, rank0, s, B)
        assert len(gates) == L
        dig8 = rot.tile_digits(out[gates], p)  # [L, nt*RT], compact rows
        dig, rev8 = dig8.double(), keys.rev_block(ap_ext[s], idx)
        rev = rev8.double()
        _, _, split = rot.gemm_config(L, N, 2 * p.d_g_used, 2, ap.split_smem)
        if split:
            dpg, groups = rot.split_groups(N, 2)
            total = torch.zeros((L, 2, N), dtype=torch.int64)
            for grp in range(groups):
                part = torch.zeros((L, 8, N), dtype=torch.float64)
                for dd in range(grp * dpg, min(grp * dpg + dpg, 2 * nt - 1)):
                    for k in range(nt):
                        j = dd - (nt - 1 - k)
                        if 0 <= j < nt:
                            prod = dig[:, j * RT:(j + 1) * RT] @ rev[dd * RT:(dd + 1) * RT]
                            part[:, :, k * T:(k + 1) * T] += prod.view(L, 8, T)
                comb = rot.combine_planes(part.to(torch.int32), p.Q)
                assert (comb >= 0).all() and (comb < p.Q).all()
                total += comb
            assert (total < 8 * p.Q).all()
            res = red31(total.to(torch.int32), p.Q)
        else:
            res = rot.tile_products(dig8, rev8, p.Q)
        out[gates] = res
    return out, live_steps


KINDS = ("zero", "modswitch", "any")
CASES = [(p, B, kind) for p in (MICRO_AP2, dataclasses.replace(TOY_AP2, n=1))
         for B in (1, 5, 17, 37) for kind in KINDS] + [(STD_AP_N1, B, kind) for B in (5, 37) for kind in KINDS]


@pytest.mark.parametrize("p, B, kind", CASES, ids=_id)
def test_rotation_by_live_tiles_equals_plain(p, B, kind):
    acc = torch.from_numpy(np.random.default_rng(B).integers(0, p.Q, (B, 2, p.N)).astype(np.int32))
    a2N = _amounts(p, B, kind, seed=B + p.N)
    ext = _ext(p, p.n * p.d_r, seed=B)
    mask, rank0, count = ap.live_table_plain(a2N, p)
    bits = ap.ap_bits(a2N, p)
    assert torch.equal(count, bits.sum(0).to(torch.int32))
    if kind == "zero":
        assert int(count.sum()) == 0
    if kind == "modswitch" and 2 * p.N // p.q == 2:  # a2N even: bit 0 of -a is 0, step j = 0 dead
        assert int(count.view(p.n, p.d_r)[:, 0].sum()) == 0
    got, live = _rotate_by_tiles(acc, ext, a2N, p)
    assert live == int((count > 0).sum())
    assert torch.equal(got, ap.blind_rotate_ap_plain(acc, ext, a2N, p))
    if kind == "zero":
        assert torch.equal(got, acc)


def test_wrapper_refuses_other_layouts():
    """The kernels read the compact planes [n*d_r, R, 8, 2N] int8,
    contiguous: the JAX package's int32 key windows, planes padded by 128
    bytes of wrap and a transposed view are refused before any launch."""
    p = MICRO_AP2
    R, S, nt = 2 * p.d_g_used, p.n * p.d_r, p.N // T
    acc = torch.zeros((3, 2, p.N), dtype=torch.int32)
    a2N = torch.zeros((3, p.n), dtype=torch.int32)
    ext = torch.zeros((S, R, 8, 2 * p.N), dtype=torch.int8)
    launches, plain, steps = ap.LAUNCHES, ap.PLAIN_LAUNCHES, ap.STEP_LAUNCHES
    windows = torch.zeros((S, 2 * nt - 1, 4, R * 8 * 64), dtype=torch.int32)
    with pytest.raises(TypeError):
        ap.blind_rotate_ap(acc, windows, a2N, p)
    with pytest.raises(ValueError, match="bad shapes"):
        ap.blind_rotate_ap(acc, torch.zeros((S, R, 8, 2 * p.N + T), dtype=torch.int8), a2N, p)
    with pytest.raises(ValueError, match="contiguous"):
        ap.blind_rotate_ap(acc, ext.transpose(1, 2).contiguous().transpose(1, 2), a2N, p)
    assert (ap.LAUNCHES, ap.PLAIN_LAUNCHES, ap.STEP_LAUNCHES) == (launches, plain, steps)
