"""The tile layout of the Hopper GEMM behind #3 and #5
(oece_tpu_torch/csrc/wgmma_mm.cuh), on the CPU, bit for bit (tolerance 0).

The GEMM takes its key K-major, as ``[GEMM_BN columns, GEMM_BK bytes]``
tiles: #3 from the block transposed by a pre-pass, #5 from 32 shifted
copies of the reversed key planes written by another.  ``negacyclic.py``
reproduces the two pre-passes (``transpose_block_plain``,
``phase_expand_plain``) and the loader's TMA box origins
(``diag_box_origin``, ``phase_box_origin``, through ``diag_key_tile`` and
``phase_key_tile``).  Here every tile of every stage must equal its window
of ``keys.rev_block`` of the same key, transposed, at STD128_OPT widths
(N = 1024, R = 4, M = 16 and 8), at N = 512 and at R = 8, windows that
wrap at 2N included; and the digits times those tiles, summed stage by
stage over gate tiles padded with zero rows as the TMA unit pads them,
must equal ``negacyclic_matmul_plain``.

#2 transposes the block with #3's transpose_kernel, whose 128 x 128 tile
in shared memory ``transpose_tile_plain`` models (its word swizzle and 4 x
4 byte transposes by the kernel's byte permutes), then runs rev_step.cu's
GEMMs on the result.  The blocks transposed tile by tile must equal the
block transposed, and every A tile that the GEMMs' TMA boxes take from
them must equal its window of the block, at N = 256 and 1024, M = 16 and
8 (tests/test_torch_rev_layout.py holds the GEMMs' model over such K-major
tiles to ``window_matmul_true_plain``, and
tests/test_torch_negacyclic_window.py the whole of #2 to the Pallas
kernel).

The plain twins themselves are held to the JAX package's interpret-mode
kernels in tests/test_torch_negacyclic*.py; the CUDA kernels to them on
the card by chip_smoke.py (neg-kernel).
"""

import numpy as np
import pytest
import torch

from oece_tpu_torch.fhe import negacyclic as ng
from oece_tpu_torch.fhe import rev
from test_torch_rev_layout import _a_tile
from test_torch_std import one_torch_thread  # noqa: F401

T = 128


def _key(seed, R, M, N):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-128, 128, (R, M, 2 * N)).astype(np.int8))


def _digits(seed, B, K):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-128, 128, (B, K)).astype(np.int8))


def test_pre_pass_plain_twins():
    """blockT is the block transposed; F[r, m, v, i] = ext[r, m, (v - i)
    mod 2N] for i < 2N + T, against a loop over numpy."""
    R, M, N = 2, 8, 256
    ext = _key(1, R, M, N)
    block = ng.build_diagonals_plain(ext)
    blockT = ng.transpose_block_plain(block)
    assert blockT.shape == (M * T, (2 * N // T - 1) * R * T) and blockT.is_contiguous()
    np.testing.assert_array_equal(blockT.numpy(), block.numpy().T)
    F = ng.phase_expand_plain(ext).numpy()
    assert F.shape == (R, M, ng.PHASE_COPIES, 2 * N + T)
    x = ext.numpy()
    want = np.empty_like(F)
    for v in range(ng.PHASE_COPIES):
        for i in range(2 * N + T):
            want[:, :, v, i] = x[:, :, (v - i) % (2 * N)]
    np.testing.assert_array_equal(F, want)


def test_phase_boxes_stay_in_their_rows():
    """Every #5 box starts 32-byte aligned and ends inside its row of F
    (the T bytes of padding past 2N), also where the window wraps at 2N;
    its rows are the copies of one plane."""
    R, M, N, V = 4, 16, 1024, ng.PHASE_COPIES
    assert V == 32
    wraps = 0
    for k in range(N // T):
        for c in range(N // T * R):
            for a in range(T // V):
                x, y = ng.phase_box_origin(k, c, 5, a, R, M, N)
                assert x % V == 0 and 0 <= x and x + ng.GEMM_BK <= 2 * N + T
                assert y == (c % R * M + 5) * V
                wraps += x + ng.GEMM_BK > 2 * N
    assert wraps > 0


@pytest.mark.parametrize("N, R, M", [(1024, 4, 16), (1024, 4, 8), (512, 4, 16), (256, 8, 8)])
def test_key_tiles_are_block_windows(N, R, M):
    """Stage c of output tile k, column tile ct: rows ct*256 .. +255 of the
    block's rows (nt-1-k)*RT + 128c .. +127, transposed, from blockT's box
    (#3) and from the shifted copies' 16 boxes (#5)."""
    nt = N // T
    ext = _key(N + R + M, R, M, N)
    block = ng.build_diagonals_plain(ext)
    blockT = ng.transpose_block_plain(block)
    F = ng.phase_expand_plain(ext)
    wrapped = 0
    for k in range(nt):
        for ct in range(M // 2):
            for c in range(nt * R):
                row = (nt - 1 - k) * R * T + c * T
                want = block[row:row + T, ct * 256:(ct + 1) * 256].t()
                assert torch.equal(ng.diag_key_tile(blockT, k, c, ct, R), want), (k, ct, c)
                assert torch.equal(ng.phase_key_tile(F, k, c, ct), want), (k, ct, c)
                j = c // R
                wrapped += int(((((j - k) * T - torch.arange(T)) % (2 * N)) + T > 2 * N).sum())
    assert wrapped > 0


def _gemm_by_tiles(dig, tile, M, N, R):
    """The GEMM's loop: per tile (gate tile gt, output tile k, column tile
    ct) the sum over stages c of dig[gates, 128c .. +127] x tile(k, c,
    ct)^T, gates padded to GEMM_BM with zero rows, then the store to
    out[b, 2ct + n // T, k*T + n % T].  float64 is exact: |sum| < 2**53."""
    B, K = dig.shape
    nt = N // T
    gates = -(-B // ng.GEMM_BM) * ng.GEMM_BM
    padded = torch.zeros((gates, K), dtype=torch.float64)
    padded[:B] = dig.double()
    out = torch.empty((B, M, N), dtype=torch.int32)
    for k in range(nt):
        for ct in range(M // 2):
            keyT = torch.cat([tile(k, c, ct) for c in range(nt * R)], dim=1).double()
            for gt in range(gates // ng.GEMM_BM):
                rows = padded[gt * ng.GEMM_BM:(gt + 1) * ng.GEMM_BM]
                acc = torch.zeros((ng.GEMM_BM, ng.GEMM_BN), dtype=torch.float64)
                for c in range(nt * R):
                    acc += rows[:, c * T:(c + 1) * T] @ keyT[:, c * T:(c + 1) * T].t()
                b = slice(gt * ng.GEMM_BM, min(B, (gt + 1) * ng.GEMM_BM))
                n = b.stop - b.start
                out[b, 2 * ct:2 * ct + 2, k * T:(k + 1) * T] = acc[:n].view(n, 2, T).to(torch.int32)
    return out


@pytest.mark.parametrize("N, R, M, B", [(1024, 4, 16, 3), (1024, 4, 8, 130), (512, 4, 16, 65),
                                        (256, 8, 8, 129)])
def test_tile_sums_are_the_raw_product(N, R, M, B):
    """Digits x the rebuilt tiles, summed stage by stage, == #3's and #5's
    plain twin (negacyclic_matmul_plain), including ragged gate tiles."""
    ext = _key(7 * N + M, R, M, N)
    dig = _digits(B + N, B, N * R)
    want = ng.negacyclic_matmul_plain(dig, ext)
    blockT = ng.transpose_block_plain(ng.build_diagonals_plain(ext))
    F = ng.phase_expand_plain(ext)
    got3 = _gemm_by_tiles(dig, lambda k, c, ct: ng.diag_key_tile(blockT, k, c, ct, R), M, N, R)
    got5 = _gemm_by_tiles(dig, lambda k, c, ct: ng.phase_key_tile(F, k, c, ct), M, N, R)
    assert torch.equal(got3, want)
    assert torch.equal(got5, want)


def test_byte_transpose():
    """transpose4x4's byte permutes transpose every 4 x 4 byte block
    ([..., word, byte])."""
    x = torch.from_numpy(np.random.default_rng(5).integers(-128, 128, (7, 4, 4, 4)).astype(np.int8))
    assert torch.equal(ng.transpose4x4(x), x.transpose(-1, -2))


def window_block_t(block):
    """#2's pre-pass as transpose_kernel runs it, one 128 x 128 tile per
    block of its grid, as the K-major block [M, T, rows] that #8 reads."""
    rows, cols = block.shape
    tiles = block.view(rows // T, T, cols // T, T).transpose(1, 2)  # [row tile, column tile, T, T]
    out = ng.transpose_tile_plain(tiles)  # out[rt, ct] is blockT's tile (ct, rt)
    return out.permute(1, 2, 0, 3).reshape(cols // T, T, rows)


@pytest.mark.parametrize("N, M", [(256, 16), (256, 8), (1024, 16), (1024, 8)])
def test_window_tiles_are_block_windows(N, M):
    """#2: the block transposed tile by tile == block.T, and the A tile of
    column chunk cc = (o, t0) at every contraction row x = 128c that the
    GEMMs' boxes take from it (4 planes x 16 coefficients x 128 bytes, limb
    l at rows 16l) == block rows x .. x+127 at the columns (4o + l)*T + t0
    + tt, ordered (l, tt), transposed."""
    R = 4
    block = ng.build_diagonals_plain(_key(N + M, R, M, N))
    blockT = window_block_t(block)
    assert torch.equal(blockT.view(M * T, -1), ng.transpose_block_plain(block))
    xs = block.shape[0] // 128
    # every tile at once: [o, t0 chunk, x block, limb, tt, 128 bytes]
    tiles = blockT.view(M // 4, 4, T // 16, 16, xs, 128).permute(0, 2, 4, 1, 3, 5)
    want = block.view(xs, 128, M // 4, 4, T // 16, 16).permute(2, 4, 0, 3, 5, 1)
    assert torch.equal(tiles, want)
    for o, t0c, x in ((0, 0, 0), (M // 4 - 1, 7, xs - 1), (1, 3, xs // 2)):  # the boxes at their origins
        assert torch.equal(_a_tile(blockT, 128 * x, 8 * o + t0c), tiles[o, t0c, x].reshape(64, 128))


class _RecordingLib:
    """The kernel library's #3 and #5 entries: record the arguments, return 0."""

    def __init__(self):
        self.calls = []

    def _entry(self, *args) -> int:
        self.calls.append(args)
        return 0

    oece_diag_matmul = oece_negacyclic_matmul = _entry


def test_card_route_passes_scratch(monkeypatch):
    """On the card route (device checks and library stubbed) #3 and #5 each
    make one library call, counted once, with int8 scratch for their
    pre-pass: blockT of the block's size, the shifted copies of ext."""
    lib = _RecordingLib()
    made = []
    empty = torch.empty

    def recording_empty(shape, **kw):
        t = empty(shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(rev, "_on_card", lambda name, *ts: True)
    monkeypatch.setattr(rev, "_aligned", lambda name, *ts: None)
    monkeypatch.setattr(rev, "_stream", lambda t: 0)
    monkeypatch.setattr(rev._build, "load", lambda: lib)
    monkeypatch.setattr(ng.torch, "empty", recording_empty)
    R, M, N, B = 4, 8, 256, 5
    ext = _key(3, R, M, N)
    block = ng.build_diagonals_plain(ext)
    dig = _digits(4, B, N * R)
    launches, plain = dict(ng.LAUNCHES), dict(ng.PLAIN_LAUNCHES)
    out3 = ng.diag_matmul(dig, block, R)
    out5 = ng.negacyclic_matmul(dig, ext)
    assert out3.shape == out5.shape == (B, M, N) and out3.dtype == torch.int32
    (c3, c5) = lib.calls
    scratch3 = next(t for t in made if t.data_ptr() == c3[2])
    scratch5 = next(t for t in made if t.data_ptr() == c5[2])
    assert scratch3.shape == (M * T, block.shape[0]) and scratch3.dtype == torch.int8
    assert scratch5.shape == (R, M, ng.PHASE_COPIES, 2 * N + T) and scratch5.dtype == torch.int8
    assert c3[:2] == (dig.data_ptr(), block.data_ptr()) and c5[:2] == (dig.data_ptr(), ext.data_ptr())
    assert c3[3:8] == (out3.data_ptr(), B, N, R, M) and c5[3:8] == (out5.data_ptr(), B, N, R, M)
    launches["diag_matmul"] += 1
    launches["negacyclic_matmul"] += 1
    assert ng.LAUNCHES == launches and ng.PLAIN_LAUNCHES == plain
