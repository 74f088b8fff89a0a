"""The negacyclic products and diagonal builds of the JAX package's
kernel-level API.

Counterpart of the half of ``oece_tpu.fhe.pallas_kernels`` that its tests
(tests/test_pallas.py) and its step profiler (tools/profile_boot.py) call,
with the Pallas kernels they reach (T = 128, nt = N/T, R digit rows, M = 16
or 8 planes (part, out, limb) with the limb minor):

  negacyclic_matmul_reference  :1589  the gather + contraction, torch ops
  pack_digits_rows             :1557  digits [R, B, N] -> [B, nt*R*T]
  build_diagonals           #1 build_diagonals_pallas :178
  diag_matmul               #3 diag_matmul_pallas :318, the raw limb sums
  negacyclic_matmul_split      :406   #1, then #3
  negacyclic_matmul         #5 negacyclic_matmul_pallas :486, #3's
                                      function with no block in memory
  window_matmul             #2 window_matmul_pallas :236, limb-combined
  negacyclic_matmul_window     :284   #1, then #2
  cmux_epilogue             #6 cmux_epilogue_pallas :552
  build_rev_conj            #7 build_rev_pallas :728

One layout throughout.  Digits are in ``pack_digits_rows`` (=
``rot.tile_digits``) order, dig[b, j*RT + r*T + u] for coefficient j*T + u
of digit row r; JAX's "tiled" digits [nt, B, RT] are
``dig.reshape(B, nt, RT).transpose(0, 1)``.  A key is one step's compact
key ext int8 [R, M, 2N] (a ``keys.ginx_ext`` step; JAX's byte-phase
windows are ``keys.unpack_windows`` of it).  Blocks are in true column
order and reversed diagonal order (``keys.rev_block``), products in true
column order: the TPU kernels' plane-permuted columns and forward diagonal
order are not reproduced, except by #7, whose function is that basis.  The
TPU tiling arguments (``max_b``, ``block_b``, ``interpret``) have no
counterpart: the kernels take any batch, B = 0 included.

#3 and #5 run on the Hopper GEMM of csrc/wgmma_mm.cuh, which takes the key
K-major: #3 transposes the block first (``transpose_block_plain`` is that
pre-pass's plain twin), #5 writes 32 shifted copies of the reversed key
planes first (``phase_expand_plain``), and each is one call of both
launches.  ``diag_key_tile`` and ``phase_key_tile`` rebuild, from those
scratch tensors, the key tile the GEMM's TMA boxes put into stage c of a
tile, by the kernel's own box origins (``diag_box_origin``,
``phase_box_origin``), so that the CPU tests pin the tile layout.

Each wrapper runs its plain twin (``*_plain``) for CPU tensors and, for
CUDA tensors, launches its kernel of csrc/negacyclic.cu or raises; #2 and
#6 are, in true column order, the functions of #8 and #10 and launch their
kernels of csrc/std_step.cu through ``rev.window_matmul_counted`` /
``rev.cmux_epilogue_counted``.  ``LAUNCHES[name]`` counts a wrapper's
kernel launches, where each launch returns, ``PLAIN_LAUNCHES[name]`` its
calls that ran the plain twin.
"""

from __future__ import annotations

from functools import partial

import torch

from . import _build, rev
from .keys import TILE, rev_block, rev_index
from .rot import tile_products_raw

KERNELS = ("build_diagonals", "diag_matmul", "negacyclic_matmul", "window_matmul",
           "cmux_epilogue", "build_rev_conj")
LAUNCHES = dict.fromkeys(KERNELS, 0)  # wrapper calls that launched a CUDA kernel
PLAIN_LAUNCHES = dict.fromkeys(KERNELS, 0)  # wrapper calls that ran a plain twin


def negacyclic_matmul_reference(digs: torch.Tensor, keys_ext: torch.Tensor) -> torch.Tensor:
    """digs int8 [R, B, N], keys_ext int8 [R*M, 2N] -> int32 [B, M, N]:
    out[b, m, k] = sum_{r, i} digs[r, b, i] * keys_ext[r*M + m, (k - i) mod
    2N], as one gather of the dense [R, M, N, N] matrix and one float64
    contraction (exact: |sum| <= R*N*128*128 < 2**53)."""
    R, B, N = digs.shape
    i = torch.arange(N, device=digs.device)
    dense = keys_ext.reshape(R, -1, 2 * N)[:, :, (i[None, :] - i[:, None]) % (2 * N)]
    out = torch.einsum("rbi,rmik->bmk", digs.to(torch.float64), dense.to(torch.float64))
    return out.to(torch.int32)


def pack_digits_rows(digs: torch.Tensor) -> torch.Tensor:
    """int8 [R, B, N] -> [B, nt*R*T]: column j*R*T + r*T + u holds digit
    row r of coefficient j*T + u."""
    R, B, N = digs.shape
    d = digs.reshape(R, B, N // TILE, TILE).permute(1, 2, 0, 3)
    return d.reshape(B, N * R).contiguous()


def build_diagonals_plain(ext: torch.Tensor) -> torch.Tensor:
    """#1: ext int8 [R, M, 2N] -> its reversed-diagonal block int8
    [(2nt-1)*R*T, M*T], true columns (keys.rev_block)."""
    return rev_block(ext, rev_index(ext.shape[-1] // 2, ext.device))


def build_rev_conj_plain(ext: torch.Tensor) -> torch.Tensor:
    """#7: the block in the conjugated basis: in every T x T tile, row u'
    and column c hold the true block's row 4*(u' % 32) + u' // 32 and
    column 4*(c % 32) + c // 32 (the TPU's byte-plane order)."""
    block = build_diagonals_plain(ext)
    lane = torch.arange(TILE, device=ext.device)
    ti = 4 * (lane % 32) + lane // 32
    tiles = block.view(-1, TILE, ext.shape[1], TILE)  # [(d', r), u, m, t]
    return tiles[:, ti][..., ti].reshape(block.shape)


def diag_matmul_plain(dig: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """#3: digits int8 [B, nt*R*T] against a block -> int32 [B, M, N]."""
    return tile_products_raw(dig, block)


def negacyclic_matmul_plain(dig: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """#5: #3 against the block of ext."""
    return tile_products_raw(dig, build_diagonals_plain(ext))


# raw_gemm_kernel's tile (csrc/wgmma_mm.cuh): gates x columns x the
# contraction bytes of one stage (one digit row group (j, r) of T bytes);
# #5's shifted key copies, the rows of one of its TMA boxes.
GEMM_BM, GEMM_BN, GEMM_BK = 128, 256, 128
PHASE_COPIES = 32


def transpose_block_plain(block: torch.Tensor) -> torch.Tensor:
    """#3's pre-pass: block int8 [(2nt-1)*R*T, M*T] -> blockT [M*T,
    (2nt-1)*R*T], K-major for the GEMM."""
    return block.t().contiguous()


def phase_expand_plain(ext: torch.Tensor) -> torch.Tensor:
    """#5's pre-pass: ext int8 [R, M, 2N] -> V = PHASE_COPIES shifted
    copies of its reversed planes er[r, m, i] = ext[r, m, -i mod 2N],
    F[r, m, v, i] = er[r, m, (i - v) mod 2N] = ext[r, m, (v - i) mod 2N]
    for i < 2N + T ([R, M, V, 2N + T]; the T bytes past 2N keep every
    window in its row)."""
    two_n = ext.shape[-1]
    i = torch.arange(two_n + TILE, device=ext.device)
    v = torch.arange(PHASE_COPIES, device=ext.device)
    return ext[:, :, (v[:, None] - i[None, :]) % two_n]


def diag_box_origin(k: int, c: int, ct: int, R: int, N: int) -> tuple[int, int]:
    """#3: (contraction byte, column) of blockT's TMA box that is stage c
    of output tile k, column tile ct: the block's rows (nt-1-k)*RT + c*T
    onwards, as rows (nt-1-k)*RT + x of the block serve output tile k."""
    return (N // TILE - 1 - k) * R * TILE + c * GEMM_BK, ct * GEMM_BN


def phase_box_origin(k: int, c: int, m: int, a: int, R: int, M: int, N: int) -> tuple[int, int]:
    """#5: (byte, row) of F [R*M*V, 2N + T] of the TMA box that holds the
    key rows of columns (m, V*a .. V*a + V-1) in stage c (digit rows
    j = c // R, r = c % R) of output tile k.  Column t = V*a + v needs
    er[r, m, p(t) + u], p(t) = ((j - k)*T - t) mod 2N, which is F[r, m, v,
    p(V*a) + u]: one start for all V."""
    j, r = divmod(c, R)
    V = PHASE_COPIES
    return ((j - k) * TILE - V * a) % (2 * N), (r * M + m) * V


def diag_key_tile(blockT: torch.Tensor, k: int, c: int, ct: int, R: int) -> torch.Tensor:
    """#3: the key tile [GEMM_BN columns, GEMM_BK bytes] of stage c of
    output tile k, column tile ct: blockT's box at its origin."""
    N = (blockT.shape[1] // (R * TILE) + 1) // 2 * TILE
    x, y = diag_box_origin(k, c, ct, R, N)
    return blockT[y:y + GEMM_BN, x:x + GEMM_BK]


def phase_key_tile(F: torch.Tensor, k: int, c: int, ct: int) -> torch.Tensor:
    """#5: the same tile from F's boxes, rows h*T + V*a + v for plane
    2ct + h."""
    R, M, V, row_bytes = F.shape
    rows = F.reshape(R * M * V, row_bytes)
    boxes = []
    for h in range(GEMM_BN // TILE):
        for a in range(TILE // V):
            x, y = phase_box_origin(k, c, 2 * ct + h, a, R, M, row_bytes // 2 - TILE // 2)
            boxes.append(rows[y:y + V, x:x + GEMM_BK])
    return torch.cat(boxes)


window_matmul_plain = rev.window_matmul_true_plain  # #2 (digs_rows, block, Q)
cmux_epilogue_plain = rev.cmux_epilogue_true_plain  # #6 (P, acc, amt, Q)


def _plain(name: str, fn, *args) -> torch.Tensor:
    PLAIN_LAUNCHES[name] += 1
    return fn(*args)


def _launch(name: str, rc: int, lib) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: {lib.oece_error_string(rc).decode()}")
    LAUNCHES[name] += 1


def _check_ext(name: str, ext: torch.Tensor) -> tuple[int, int, int]:
    """(R, M, N) of one step's compact key int8 [R, M, 2N], M = 16 or 8."""
    if ext.dtype != torch.int8 or ext.ndim != 3:
        raise ValueError(f"{name}: want an int8 key [R, M, 2N], got {ext.dtype} {tuple(ext.shape)}")
    R, M, two_n = ext.shape
    if M not in (16, 8) or two_n % (2 * TILE) or two_n & (two_n - 1) or R == 0:
        raise ValueError(f"{name}: bad key shape {tuple(ext.shape)}: want [R, 16 or 8, 2N], "
                         f"N a power of two and a multiple of {TILE}")
    return R, M, two_n // 2


def _build_rev(name: str, ext: torch.Tensor, conj: int, plain) -> torch.Tensor:
    R, M, N = _check_ext(name, ext)
    if not rev._on_card(name, ext):
        return _plain(name, plain, ext)
    rev._aligned(name, ext)
    out = torch.empty(((2 * N // TILE - 1) * R * TILE, M * TILE), dtype=torch.int8, device=ext.device)
    lib = _build.load()
    _launch(name, lib.oece_build_rev(ext.data_ptr(), out.data_ptr(), N, R, M, conj, rev._stream(out)), lib)
    return out


def build_diagonals(ext: torch.Tensor) -> torch.Tensor:
    """#1: one step's compact key ext int8 [R, M, 2N], M = 16 or 8 -> its
    reversed-diagonal block int8 [(2nt-1)*R*T, M*T], true columns:
    rev_build_kernel<M>, the row-major build (fhe/std.py's step loop builds
    its blocks K-major with csrc/rev_step.cu's std_build_kernel)."""
    return _build_rev("build_diagonals", ext, 0, build_diagonals_plain)


def build_rev_conj(ext: torch.Tensor) -> torch.Tensor:
    """#7: ext int8 [R, M, 2N] -> the reversed-diagonal block in the
    conjugated basis, bit for bit the TPU's ``build_rev_pallas`` of ext's
    windows: rev_build_kernel<M, true>."""
    return _build_rev("build_rev_conj", ext, 1, build_rev_conj_plain)


def _raw_product(name: str, dig: torch.Tensor, key: torch.Tensor, R: int, M: int, N: int,
                 entry: str, plain, scratch_shape: tuple) -> torch.Tensor:
    """Launch #3 (key = a block) or #5 (key = ext) with its pre-pass into
    int8 scratch of ``scratch_shape``: int32 [B, M, N]."""
    if not rev._on_card(name, dig, key):
        return _plain(name, plain, dig, key)
    rev._aligned(name, dig, key)
    B = dig.shape[0]
    out = torch.empty((B, M, N), dtype=torch.int32, device=dig.device)
    if B == 0:
        return out
    scratch = torch.empty(scratch_shape, dtype=torch.int8, device=dig.device)
    lib = _build.load()
    rc = getattr(lib, entry)(dig.data_ptr(), key.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                             B, N, R, M, rev._stream(out))
    _launch(name, rc, lib)
    return out


def diag_matmul(dig: torch.Tensor, block: torch.Tensor, R: int) -> torch.Tensor:
    """#3: digits int8 [B, nt*R*T] against one step's block int8
    [(2nt-1)*R*T, M*T], M = 16 or 8 -> the raw limb sums int32 [B, M, N]
    (no combine), true columns: the block transposed, then the GEMM."""
    name = "diag_matmul"
    _, nt = rev._check_digits(name, dig, R)
    M = rev._block_planes(name, block, R, nt)
    return _raw_product(name, dig, block, R, M, nt * TILE, "oece_diag_matmul", diag_matmul_plain,
                        (block.shape[1], block.shape[0]))


def negacyclic_matmul_split(dig: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """#1 then #3: digits int8 [B, nt*R*T] against ext int8 [R, M, 2N] ->
    int32 [B, M, N]."""
    return diag_matmul(dig, build_diagonals(ext), ext.shape[0])


def negacyclic_matmul(dig: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """#5: #3's function with each key tile gathered from ext int8
    [R, M, 2N]'s shifted copies by the GEMM's TMA boxes; no block is
    built."""
    name = "negacyclic_matmul"
    R, M, N = _check_ext(name, ext)
    rev._check_digits(name, dig, R, N)
    return _raw_product(name, dig, ext, R, M, N, "oece_negacyclic_matmul", negacyclic_matmul_plain,
                        (R, M, PHASE_COPIES, 2 * N + TILE))


def window_matmul(digs_rows: torch.Tensor, block: torch.Tensor, R: int, Q: int) -> torch.Tensor:
    """#2: digits int8 [B, nt*R*T] against one step's block int8
    [(2nt-1)*R*T, M*T] -> int32 [B, M/4, N] limb-combined mod Q, true
    columns: #8's function and kernel."""
    name = "window_matmul"
    return rev.window_matmul_counted(name, digs_rows, block, R, Q, partial(_plain, name), _launch)


def negacyclic_matmul_window(digs_rows: torch.Tensor, ext: torch.Tensor, Q: int) -> torch.Tensor:
    """#1 then #2: int32 [B, M/4, N] in [0, Q)."""
    return window_matmul(digs_rows, build_diagonals(ext), ext.shape[0], Q)


def cmux_epilogue(P: torch.Tensor, acc: torch.Tensor, amt: torch.Tensor, Q: int) -> torch.Tensor:
    """#6: P int32 [B, 2, 2, N] in [0, Q), acc [B, 2, N], amt [B, 2] in
    [0, 2N) -> red31(acc + X^amt0 P0 + X^amt1 P1 + 2Q - P0 - P1), true
    order: #10's function and kernel."""
    name = "cmux_epilogue"
    return rev.cmux_epilogue_counted(name, P, acc, amt, Q, partial(_plain, name), _launch)
