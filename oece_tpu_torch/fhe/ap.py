"""The AP blind rotation: the binary base (B_r = 2) and a generic base.

Counterpart of ``oece_tpu.fhe.boot._blind_rotate_ap_fused`` ->
``pallas_kernels.blind_rotate_ap_megakernel`` (-> ``_ap_megakernel``,
``_build_rev_body``, ``_decompose_body``, ``_matmul_body``), in true
coefficient order (the TPU kernel's lane permutation is not carried over).
Step s = i*d_r + j, for gate b, with neg_a = (2N - a2N[b, i]) mod 2N:

    acc <- bit ? acc ⊡ K_s : acc,    bit = (neg_a >> j) & 1

where K_s = RGSW(X^{2^j s_i}) is shared by every gate and ⊡ is the
external product: gadget digits of acc, one int8 contraction per
128-coefficient output tile against the step's reversed diagonals
(expanded from ``ap_ext`` by ``keys.rev_block``), then the Horner combine of the 4 key limbs.
golden.blind_rotate_ap is the same function (it skips v = 0 steps).

``blind_rotate_ap`` dispatches on the device of its tensors: CPU tensors
take ``blind_rotate_ap_plain`` (torch ops), CUDA tensors launch the
hand-written kernels of ``csrc/ap_step.cu`` or raise.  On the card the
select bits, which are public, decide what runs: ``live_table`` (one
kernel per rotation) gives each step's live gates, their count comes to
the host in one transfer, and the step loop launches nothing for a step
without a live gate and, for a live one, a digits kernel and a wgmma GEMM
over its live gates only, in compact rows: the split GEMM up to 16 live
gates, the tiled one above, chosen per live step on the host side of
csrc/ap_step.cu by step_gemm.cuh's gemm_tile, rot.py's ``gemm_config``
with this GEMM's ``split_smem``.  The GEMMs make the step's
key tiles on chip from ``ap_ext`` as it is (no card layout; the CPU's
[n*d_r, R, 8, 2N] int8 planes): ``span_start``, ``span_offset`` and
``swizzled_chunk`` repeat their arithmetic for the CPU layout tests.
``LAUNCHES`` and ``PLAIN_LAUNCHES`` count the calls that reached each
version, ``STEP_LAUNCHES`` the live steps the step loop launched (each a
digits kernel and a GEMM) and ``KERNEL_LAUNCHES`` every kernel launch of
``csrc/ap_step.cu`` (the table, the steps' kernels, the last finalize).

A generic base (B_r != 2: MICRO and TOY, B_r = 32) is the JAX package's
``boot.blind_rotate_ap_dev``, which has no Pallas kernel: step (i, j)
takes digit v = (neg_a >> j*log2 B_r) & (B_r - 1) of each gate and
multiplies the gate's digits by the negacyclic matrix of key (i, j, v);
v = 0 keeps the accumulator.  ``blind_rotate_ap_generic`` groups a step's
gates by v, so each of at most B_r - 1 matrices is made once per step
(``negacyclic_matrices``) and shared by its gates, instead of one matrix
per gate; it is torch ops on both devices (``GENERIC_LAUNCHES`` counts
its calls).  The select digits are public and come to the host once per
rotation.

Under a traced Clock (utils/trace.py) each rotation counts its live steps
and live (gate, step) pairs, and the copy of the live counts to the host is
span ``ap.live_count``, counted as a host wait.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import trace
from . import _build
from .keys import TILE, rev_block, rev_index
from .params import BinFHEParams
from .rot import check_operands, combine_planes, tile_digits, tile_products

GEMM_BK = 128  # contraction bytes of a key tile row
GEMM_CHUNK = 16  # coefficients of a key tile: 4 limbs x 16 = 64 rows
SPLIT_MAX = 16  # live gates of the split GEMM, at most
SPAN = 160  # plane bytes a key tile reads per limb, staged in shared memory

LAUNCHES = 0  # calls that launched the CUDA kernels (one per rotation)
PLAIN_LAUNCHES = 0  # calls that ran the plain torch version
STEP_LAUNCHES = 0  # live steps the CUDA step loop launched (each: digits + GEMM)
KERNEL_LAUNCHES = 0  # every launch of an ap_step.cu kernel (table, digits, GEMMs)
GENERIC_LAUNCHES = 0  # calls of blind_rotate_ap_generic (torch ops, both devices)


def ap_bits(a2N: torch.Tensor, p: BinFHEParams) -> torch.Tensor:
    """Public select bits int32 [B, n*d_r]: bit j of (-a_i mod 2N) at
    column i*d_r + j (boot._blind_rotate_ap_fused)."""
    two_n = 2 * p.N
    neg_a = (two_n - a2N) & (two_n - 1)
    j = torch.arange(p.d_r, device=a2N.device, dtype=a2N.dtype)
    return ((neg_a[:, :, None] >> j) & 1).reshape(a2N.shape[0], -1)


def ap_step_plain(
    acc: torch.Tensor, bit: torch.Tensor, ext_s: torch.Tensor, idx: torch.Tensor,
    p: BinFHEParams,
) -> torch.Tensor:
    """One step: the product of the accumulator's own digits with the
    step key where bit is 1, the accumulator unchanged where it is 0."""
    prod = tile_products(tile_digits(acc, p), rev_block(ext_s, idx), p.Q)
    return torch.where(bit[:, None, None] != 0, prod, acc)


def blind_rotate_ap_plain(
    acc: torch.Tensor, ap_ext: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """All n*d_r steps with torch ops: acc int32 [B, 2, N], ap_ext int8
    [n*d_r, R, 8, 2N], a2N int32 [B, n] in [0, 2N)."""
    global PLAIN_LAUNCHES
    PLAIN_LAUNCHES += 1
    bits = ap_bits(a2N, p)
    if trace.ACTIVE is not None:  # the live steps and pairs the card's loop would run
        trace.count("steps", int(bits.any(0).sum()))
        trace.count("live_pairs", int(bits.sum()))
    idx = rev_index(acc.shape[-1], acc.device)
    for s in range(ap_ext.shape[0]):
        acc = ap_step_plain(acc, bits[:, s], ap_ext[s], idx, p)
    return acc


def live_table_plain(a2N: torch.Tensor, p: BinFHEParams):
    """The live-gate table of a rotation, as ``ap_live_kernel`` writes it:
    mask int64 [S, W] (W = ceil(B/32); bit b%32 of word b/32 is gate b's
    select bit), rank0 int32 [S, W] (live gates before each word) and
    count int32 [S].  Live gate b of step s sits at compact row rank0[s,
    b/32] + popcount(mask[s, b/32] & ((1 << b%32) - 1))."""
    bits = ap_bits(a2N, p).t().to(torch.int64)  # [S, B]
    S, B = bits.shape
    W = -(-B // 32)
    padded = torch.zeros((S, W * 32), dtype=torch.int64, device=a2N.device)
    padded[:, :B] = bits
    words = padded.view(S, W, 32)
    mask = (words << torch.arange(32, device=a2N.device)).sum(-1)
    per_word = words.sum(-1)
    rank0 = (per_word.cumsum(-1) - per_word).to(torch.int32)
    return mask, rank0, bits.sum(-1).to(torch.int32)


def live_table(a2N: torch.Tensor, p: BinFHEParams):
    """``live_table_plain`` for CPU tensors; on the card ``ap_live_kernel``
    (mask as int32 words there: the same bits)."""
    if not a2N.is_cuda:
        return live_table_plain(a2N, p)
    B = a2N.shape[0]
    S, W = p.n * p.d_r, -(-B // 32)
    mask = torch.empty((S, W), dtype=torch.int32, device=a2N.device)
    rank0 = torch.empty((S, W), dtype=torch.int32, device=a2N.device)
    count = torch.empty((S,), dtype=torch.int32, device=a2N.device)
    lib = _build.load()
    rc = lib.oece_ap_live_table(
        a2N.data_ptr(), mask.data_ptr(), rank0.data_ptr(), count.data_ptr(), B, p.n, p.d_r, p.N,
        torch.cuda.current_stream(a2N.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ap_step.cu launch failed: {lib.oece_error_string(rc).decode()}")
    return mask, rank0, count


def split_smem(NB: int, R: int, dpg: int) -> int:
    """Shared memory of the split GEMM (ap_step.cu: split_smem): dpg*R key
    tiles of 8 KB, the digit chunks of R substages x (dpg + 7) chunks x NB
    gates, a barrier, the tiles' spans (4 x SPAN bytes each) and the
    epilogue's staging buffer; rot.py's ``gemm_config`` takes it as
    ``smem`` for AP's steps."""
    return (1024 + dpg * R * 64 * GEMM_BK + R * (dpg + 7) * NB * GEMM_BK + 16 + dpg * R * 4 * SPAN
            + 64 * (NB + 1) * 4)


def span_start(dp: int, t0: int, N: int) -> int:
    """The first plane byte of the span that the key tile of diagonal dp
    and coefficients t0 .. t0+15 reads from each limb plane: SPAN bytes
    from ((nt-1-dp)*T + t0 - 128) mod 2N, 16-byte aligned."""
    return ((N // TILE - 1 - dp) * TILE + t0 - 128) % (2 * N)


def span_offset(tt: int, q: int) -> int:
    """The first of the 16 ascending span bytes a .. a+15 that hold bytes
    u = 16q .. 16q+15 of the tile row of coefficient t0 + tt, reversed
    (row byte u = span byte 128 + tt - u): a = 113 + tt - 16q.  The thread
    reads the span's words a//4 .. a//4 + 4."""
    return 113 + tt - 16 * q


def swizzled_chunk(rho: int, q: int) -> int:
    """Where chunk q (16 bytes) of row rho of a 64 x 128-byte key tile
    lies in shared memory: the 128-byte swizzle of wgmma's descriptor,
    byte offset rho*128 + (q ^ rho%8)*16."""
    return rho * GEMM_BK + ((q ^ (rho % 8)) * 16)


def _check(acc, ap_ext, a2N, p: BinFHEParams) -> None:
    """The compact planes int8 [n*d_r, R, 8, 2N], contiguous, on both
    devices; anything else (the JAX package's int32 windows, a transposed
    view) is refused before any launch."""
    check_operands("blind_rotate_ap", acc, ap_ext, a2N)
    B, _, N = acc.shape
    R = 2 * p.d_g_used
    if (
        p.B_r != 2 or N != p.N or a2N.shape != (B, p.n)
        or ap_ext.shape != (p.n * p.d_r, R, 8, 2 * N)
    ):
        raise ValueError(
            f"blind_rotate_ap: bad shapes acc {tuple(acc.shape)}, ap_ext "
            f"{tuple(ap_ext.shape)}, a2N {tuple(a2N.shape)} for {p.name} "
            f"(N={p.N}, n={p.n}, d_r={p.d_r}, B_r={p.B_r})"
        )


def _blind_rotate_ap_cuda(acc, ap_ext, a2N, p: BinFHEParams) -> torch.Tensor:
    global LAUNCHES, STEP_LAUNCHES, KERNEL_LAUNCHES
    B, _, N = acc.shape
    out = acc.clone()  # the step loop updates it in place
    if B == 0 or ap_ext.shape[0] == 0:
        return out
    mask, rank0, count = live_table(a2N, p)
    KERNEL_LAUNCHES += 1
    with trace.span("ap.live_count"):
        counts = count.cpu()  # the rotation's one transfer (and wait)
        trace.count("host_waits")
    lib = _build.load()
    L_max, live = int(counts.max()), int((counts > 0).sum())
    if trace.ACTIVE is not None:
        trace.count("steps", live)
        trace.count("live_pairs", int(counts.sum()))
    K = N // TILE * 2 * p.d_g_used * TILE
    dig = torch.empty((L_max, K), dtype=torch.int8, device=acc.device)
    res = torch.empty((L_max, 2, N), dtype=torch.int32, device=acc.device)
    sums = torch.empty((2, SPLIT_MAX, 2, N), dtype=torch.int32, device=acc.device)
    rc = lib.oece_blind_rotate_ap(
        out.data_ptr(), res.data_ptr(), sums.data_ptr(), dig.data_ptr(), ap_ext.data_ptr(),
        mask.data_ptr(), rank0.data_ptr(), counts.data_ptr(), B, L_max, ap_ext.shape[0], N,
        p.d_g_used, int(math.log2(p.B_g)), p.g_shift, p.Q,
        torch.cuda.current_stream(acc.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"ap_step.cu launch failed: {lib.oece_error_string(rc).decode()}"
        )
    LAUNCHES += 1
    STEP_LAUNCHES += live
    KERNEL_LAUNCHES += 2 * live + (live > 0)  # digits + GEMM per live step, the last finalize
    return out


def blind_rotate_ap(
    acc: torch.Tensor, ap_ext: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """The whole rotation.  CPU tensors run the plain version; CUDA tensors
    launch the kernels (or raise); any other device raises."""
    _check(acc, ap_ext, a2N, p)
    if acc.device.type == "cpu":
        return blind_rotate_ap_plain(acc, ap_ext, a2N, p)
    if acc.device.type != "cuda":
        raise ValueError(f"blind_rotate_ap: no kernel for device {acc.device}")
    return _blind_rotate_ap_cuda(acc, ap_ext, a2N, p)


def negacyclic_matrices(ext: torch.Tensor) -> torch.Tensor:
    """Step keys' planes int8 [V, R, M, 2N] -> their product matrices int8
    [V, nt*R*T, M*N] for digits in ``reversed_digits`` order: entry [v,
    j'*RT + r*T + u', m*N + k] = ext[v, r, m, (k - i) mod 2N] for
    coefficient i = N-1 - (j'*T + u').  With the rows reversed so, every
    stride of the source is positive: the matrices are one strided copy of
    the keys doubled (no gather).  Each is stored column-major (the
    transpose of a contiguous [M*N, nt*R*T]), the layout cuBLAS's int8
    product takes as it is."""
    V, R, M, two_n = ext.shape
    N = two_n // 2
    ext2 = torch.cat([ext, ext], dim=-1)  # [V, R, M, 4N]: (k - i) mod 2N = N+1 + k + j'T + u'
    src = ext2.as_strided(
        (V, M, N, N // TILE, R, TILE), (R * M * 2 * two_n, 2 * two_n, 1, TILE, M * 2 * two_n, 1), N + 1
    )
    return src.reshape(V, M * N, N * R).transpose(1, 2)


def reversed_digits(dig: torch.Tensor, R: int) -> torch.Tensor:
    """Digits int8 [B, nt*R*T] in ``rot.tile_digits`` order (column j*RT +
    r*T + u) -> the row order of ``negacyclic_matrices`` (tile nt-1-j, lane
    T-1-u)."""
    B, K = dig.shape
    return dig.view(B, K // (R * TILE), R, TILE).flip(1).flip(3).reshape(B, K)


# torch._int_mm on the card takes more than 16 rows: products of fewer
# gates run on this many rows of a zero-padded buffer
MIN_ROWS = 17


def ap_digit_values(a2N: torch.Tensor, p: BinFHEParams) -> torch.Tensor:
    """The select digits int64 [B, n*d_r]: digit j (base B_r) of (-a_i mod
    2N) at column i*d_r + j (boot.blind_rotate_ap_dev)."""
    two_n = 2 * p.N
    neg_a = ((two_n - a2N) & (two_n - 1)).to(torch.int64)
    shift = torch.arange(p.d_r, device=a2N.device) * int(math.log2(p.B_r))
    return ((neg_a[:, :, None] >> shift) & (p.B_r - 1)).reshape(a2N.shape[0], -1)


def blind_rotate_ap_generic(
    acc: torch.Tensor, ap_ext: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """The AP rotation for any base, torch ops on the tensors' device: acc
    int32 [B, 2, N], ap_ext int8 [n*d_r*B_r, R, 8, 2N] (every digit value,
    keys.py), a2N int32 [B, n] in [0, 2N).  Bit-identical to
    ``blind_rotate_ap_dev``: each step's gates are sorted by their digit
    v, each run of one v > 0 takes the digits of its accumulators times
    key (i, j, v)'s matrix and the Horner combine of the 4 limbs, and
    v = 0 keeps the accumulator.  Per step: the digits of its live gates,
    one strided copy that makes the matrices of the digit values in use,
    one ``torch._int_mm`` per value (int8 x int8 -> int32, exact: |sum| <=
    nt*R*T * 128 * 128 <= 2**27), one combine."""
    global GENERIC_LAUNCHES
    B, _, N = acc.shape
    S, V = p.n * p.d_r, p.B_r
    if N != p.N or N % TILE or a2N.shape != (B, p.n) or ap_ext.shape != (S * V, 2 * p.d_g_used, 8, 2 * N):
        raise ValueError(
            f"blind_rotate_ap_generic: bad shapes acc {tuple(acc.shape)}, ap_ext "
            f"{tuple(ap_ext.shape)}, a2N {tuple(a2N.shape)} for {p.name} "
            f"(N={p.N}, n={p.n}, d_r={p.d_r}, B_r={p.B_r})"
        )
    GENERIC_LAUNCHES += 1
    R = 2 * p.d_g_used
    K = N // TILE * R * TILE
    acc = acc.clone()
    if B == 0:
        return acc
    vals = ap_digit_values(a2N, p)  # [B, S]
    order = torch.argsort(vals, dim=0, stable=True)  # per step: gates by digit
    counts = torch.zeros((S, V), dtype=torch.int64, device=acc.device)
    counts.scatter_add_(1, vals.t(), torch.ones_like(vals.t()))
    in_use = counts[:, 1:] > 0
    # the keys of every (step, value > 0) in use, in step order, on the device
    key_rows = (in_use.nonzero() * torch.tensor([V, 1], device=acc.device)).sum(1) + 1
    with trace.span("ap.live_count"):
        counts = counts.cpu().numpy()  # the rotation's one transfer
        trace.count("host_waits")
    if trace.ACTIVE is not None:
        trace.count("steps", int((counts[:, 0] < B).sum()))
        trace.count("live_pairs", int(B * S - counts[:, 0].sum()))
    first = 0
    for s in range(S):
        if counts[s, 0] == B:
            continue  # every gate keeps its accumulator
        live = order[int(counts[s, 0]):, s]
        L = live.shape[0]
        # the step's digits and raw products, MIN_ROWS - 1 rows of slack so
        # every value's product can run on MIN_ROWS rows; a product's extra
        # rows land on the next value's rows before that value writes them
        dig = torch.zeros((L + MIN_ROWS - 1, K), dtype=torch.int8, device=acc.device)
        dig[:L] = reversed_digits(tile_digits(acc[live], p), R)
        raw = torch.empty((L + MIN_ROWS - 1, 8 * N), dtype=torch.int32, device=acc.device)
        used = np.nonzero(counts[s, 1:])[0] + 1
        mats = negacyclic_matrices(ap_ext[key_rows[first:first + len(used)]])
        first += len(used)
        row = 0
        for k, v in enumerate(used):
            c = max(int(counts[s, v]), MIN_ROWS)
            torch._int_mm(dig[row:row + c], mats[k], out=raw[row:row + c])
            row += int(counts[s, v])
        acc[live] = combine_planes(raw[:L].view(L, 8, N), p.Q)
    return acc
