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

#2 and #6 are, in true column order, the functions of #8 and #10 (through
``rev.window_matmul_counted`` / ``rev.cmux_epilogue_counted``).  #2 is
#3's transpose of the block into K-major scratch, then #8's wgmma GEMMs of
csrc/rev_step.cu on it, in one call; ``transpose_tile_plain`` models the
transpose's tile in shared memory (its word swizzle and 4 x 4 byte
transposes), and #8's TMA boxes of the result are rev.py's.  #1 alone and
#7 are one build kernel of csrc/int8_mm.cuh: a block per (plane, digit
row, diagonal) stages 256 key-row bytes (``build_span_index``) and cuts each
thread's 16-byte stores from them (``build_window_start``), as they are
(#1) or transposed 4 x 4 from 16 window words (#7).  ``byte_perm`` and ``transpose4x4``
repeat the kernels' byte permutes.

Each wrapper runs its plain twin (``*_plain``) for CPU tensors and, for
CUDA tensors, launches its kernel or raises.  ``LAUNCHES[name]`` counts a
wrapper's kernel launches, where each launch returns,
``PLAIN_LAUNCHES[name]`` its calls that ran the plain twin.
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
    """#3's and #2's pre-pass: block int8 [(2nt-1)*R*T, M*T] -> blockT
    [M*T, (2nt-1)*R*T], K-major for the GEMM."""
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


# csrc/int8_mm.cuh's transpose4x4: the __byte_perm selectors of its two
# rounds (bytes 0, 1 and 2, 3 of word pairs; then even and odd bytes).
TRANSPOSE_SELECTORS = (0x5140, 0x7362, 0x5410, 0x7632)


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's __byte_perm on words given as their bytes [..., 4], byte 0
    the lowest: byte n of the result is byte (sel >> 4n) & 7 of x's 4
    bytes followed by y's."""
    return torch.cat([x, y], dim=-1)[..., [(sel >> 4 * n) & 7 for n in range(4)]]


def transpose4x4(x: torch.Tensor) -> torch.Tensor:
    """transpose4x4 on words [..., 4 words, 4 bytes]: word b of the result
    is byte b of the 4 words, by the kernel's six byte permutes."""
    lo, hi, even, odd = TRANSPOSE_SELECTORS
    lo01, hi01 = byte_perm(x[..., 0, :], x[..., 1, :], lo), byte_perm(x[..., 0, :], x[..., 1, :], hi)
    lo23, hi23 = byte_perm(x[..., 2, :], x[..., 3, :], lo), byte_perm(x[..., 2, :], x[..., 3, :], hi)
    return torch.stack([byte_perm(lo01, lo23, even), byte_perm(lo01, lo23, odd),
                        byte_perm(hi01, hi23, even), byte_perm(hi01, hi23, odd)], dim=-2)


def transpose_tile_plain(tiles: torch.Tensor) -> torch.Tensor:
    """wgmma_mm.cuh's transpose_kernel on 128 x 128 tiles [..., T, T] of a
    block, as the 256 threads of each of its blocks run it: 16-byte chunk
    c of row r is staged at words 4*(c ^ (r/16 % 8)) of the row's 32 (so
    that its column reads hit 32 banks); thread (row group q, word column
    w) reads rows 16q + 4a .. +3 at word w ^ 4q, transposes each 4 x 4
    byte block (``transpose4x4``) and writes bytes 16q .. 16q+15 of output
    rows 4w .. 4w+3.  Returns the output tiles, each input tile
    transposed."""
    lead = tiles.shape[:-2]
    rows, chunks = torch.arange(TILE)[:, None], torch.arange(TILE // 16)
    staged = torch.empty((*lead, TILE, TILE // 16, 16), dtype=tiles.dtype)
    staged[..., rows, chunks ^ (rows // 16 % 8), :] = tiles.reshape(*lead, TILE, TILE // 16, 16)
    words = staged.view(*lead, TILE, TILE // 4, 4)  # [..., row, word, byte]
    q, w = torch.arange(8)[:, None, None, None], torch.arange(TILE // 4)[None, :, None, None]
    a, i = torch.arange(4)[None, None, :, None], torch.arange(4)[None, None, None, :]
    x = words[..., 16 * q + 4 * a + i, w ^ (4 * q), :]  # [..., q, w, a, i, byte]
    col = transpose4x4(x)  # [..., q, w, a, cb, i]: byte i is row 16q + 4a + i, column 4w + cb
    n = len(lead)
    return col.permute(*range(n), n + 1, n + 3, n, n + 2, n + 4).reshape(*lead, TILE, TILE)


def build_span_index(N: int) -> torch.Tensor:
    """#1 alone and #7: [2nt-1, 256], the key-row bytes that
    rev_build_kernel's block (m, r, d') stages, span[j] = ext[r, m,
    ((nt-2-d')*T + j) mod 2N], 16 loads of 16 bytes from a multiple of T,
    none wrapping.  Entry (u, t) of the block's rows is span[T + t - u]."""
    dp = torch.arange(2 * (N // TILE) - 1)[:, None]
    return ((N // TILE - 2 - dp) * TILE + torch.arange(2 * TILE)) % (2 * N)


def build_window_start(up, h, conj: bool):
    """The first span byte a that thread (row u', h = 0 or 1) reads; its 4
    stores of 16 bytes land at columns 32g + 16h of its row.  True order:
    a = T - u' + 16h, store g is span bytes a + 32g .. a + 32g + 15.
    Conjugated basis: row u = trueidx(u'), a = T - u + 64h, the words W_i =
    span[a + 4i .. a + 4i + 3] hold t = 64h + 4i .. of row u, and store g
    is byte g of W_0 .. W_15."""
    if conj:
        return TILE - (4 * (up % 32) + up // 32) + 64 * h
    return TILE - up + 16 * h


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
    rev_build_kernel<M>, the row-major build from staged spans (fhe/std.py's
    step loop builds its blocks K-major with csrc/rev_step.cu's
    std_build_kernel)."""
    return _build_rev("build_diagonals", ext, 0, build_diagonals_plain)


def build_rev_conj(ext: torch.Tensor) -> torch.Tensor:
    """#7: ext int8 [R, M, 2N] -> the reversed-diagonal block in the
    conjugated basis, bit for bit the TPU's ``build_rev_pallas`` of ext's
    windows: rev_build_kernel<M, true>, #1's staged spans with each
    16-byte store transposed from 16 window words."""
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
    columns: the block transposed K-major (#3's pre-pass), then #8's
    GEMMs, one call of both launches."""
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
