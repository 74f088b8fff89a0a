"""The GINX blind rotation in the CGGI rotated-difference form.

Counterpart of ``oece_tpu.fhe.pallas_kernels.blind_rotate_rot_megakernel``
(-> ``_rot_megakernel``, ``_rot_diff_decompose``, ``_decompose_lanes``,
``_combine_limbs_tile``).  For each step i and gate b, with a = a2N[b, i]:

    acc <- red31(acc + K+_i ⊡ dec((X^{2N-a} - 1) acc) + K-_i ⊡ dec((X^a - 1) acc))

where ⊡ is one int8 contraction per 128-coefficient output tile against the
step's rev2 diagonals, followed by the Horner combine of the 4 key limbs.

``blind_rotate_rot`` dispatches on the device of its tensors: CPU tensors
take ``blind_rotate_rot_plain`` (torch ops) on the row-major rev2 key,
CUDA tensors launch the hand-written step loop of ``csrc/rot_step.cu`` on
the K-major key (keys.py) or raise; a row-major key on the card is
refused, not transposed per call.  Each step is two kernels: the digits
of both rotated differences (``rot_diff_digits``), then a TMA + wgmma GEMM
with 64 key columns (the 4 limbs of 16 coefficients) on wgmma's M and the
gates on its N (``gemm_config``).  Above 16 gates the tiled GEMM (gate
tiles of 32 to 256 gates, fitted to B in steps of 16) reads the digits
from scratch padded with zero rows to its last gate tile
(``digit_scratch``) and takes the limb combine and the
``red31`` add in its epilogue; up to 16 gates the split GEMM reads each
key tile once per step for all output tiles and adds combined partial
sums into a scratch sum, which the next step's digits kernel (or, after
the last step, a finalize kernel) adds to the accumulator.  Over a whole
rotation the key is read-only, so each split GEMM block loads its first
key tiles before it waits for the digits kernel (``early_boxes``,
``key_prefetch_bytes``).

``gemm_config`` is the one rule of the step GEMM's shape for every
rotation (this form's, fhe/rev.py's and fhe/std.py's, and AP's per live
step through csrc/step_gemm.cuh's gemm_tile), with ``split_groups`` the
split GEMM's diagonal groups: the GINX wrappers pass the gate tile NB it
chooses to the kernels, which run that instance, size their digit scratch
and sums by it, and count it under a traced Clock (``count_gemm``:
``padded_lanes``, ``key_prefetch_bytes``).  ``split_digit_box``,
``gemm_tiles`` and ``key_box_origin`` repeat the kernels' tiling for the
CPU layout tests.

``rot_step_true`` is one step for any amount pair (c_pos, c_neg) per gate,
the counterpart of Pallas kernel #11 ``pallas_kernels.rot_step_true``
(``_rot_step_true_kernel``); ``blind_rotate_rot_steps`` is a Python loop of
it, the lax.scan that the JAX package runs under ``OECE_ROT_MEGA=0``
(boot.py:464-469).  Its plain twin is ``rot_step_plain``.

``LAUNCHES`` counts the ``blind_rotate_rot`` calls that launched the step
loop, ``STEP_LAUNCHES`` the launches of each kernel of that loop (one per
step), ``SINGLE_STEP_LAUNCHES`` the ``rot_step_true`` calls that launched
``oece_rot_step`` (its two kernels once each), and ``PLAIN_LAUNCHES`` the
calls of either that ran the plain version.
"""

from __future__ import annotations

import math

import torch

from ..utils import trace
from . import _build, keys
from .modmath import combine_limbs_mod_q, red31
from .params import BinFHEParams

TILE = 128
GEMM_BK = 128  # contraction bytes per stage of the step GEMM
GEMM_CHUNK = 16  # coefficients per math warpgroup: 4 limbs x 16 = 64 key columns

LAUNCHES = 0  # blind_rotate_rot calls that launched the CUDA step loop
PLAIN_LAUNCHES = 0  # calls that ran the plain torch version
STEP_LAUNCHES = 0  # launches of each kernel of the CUDA step loop (one per step)
SINGLE_STEP_LAUNCHES = 0  # rot_step_true calls that launched oece_rot_step


def gadget_digits_dev(x: torch.Tensor, B: int, d: int) -> torch.Tensor:
    """x int32 in [0, Q) -> int8 [..., d]; golden.gadget_digits."""
    log_b = int(math.log2(B))
    half = B // 2
    digs = []
    cur = x
    for _ in range(d - 1):
        r = cur & (B - 1)
        r = r - B * (r >= half).to(r.dtype)
        digs.append(r.to(torch.int8))
        cur = (cur - r) >> log_b
    digs.append(cur.to(torch.int8))
    return torch.stack(digs, dim=-1)


def gadget_digits_approx_dev(
    x: torch.Tensor, Q: int, B: int, d_eff: int, shift: int
) -> torch.Tensor:
    """Approximate gadget digits (golden.gadget_digits_approx): centre mod
    Q, round away ``shift`` low bits, d_eff signed base-B digits."""
    c = x - Q * (x >= (Q + 1) // 2).to(x.dtype)
    cur = (c + (1 << (shift - 1))) >> shift
    half = B // 2
    log_b = int(math.log2(B))
    digs = []
    for _ in range(d_eff - 1):
        r = ((cur + half) & (B - 1)) - half
        digs.append(r.to(torch.int8))
        cur = (cur - r) >> log_b
    digs.append(cur.to(torch.int8))
    return torch.stack(digs, dim=-1)


def acc_gadget_digits_dev(acc: torch.Tensor, p: BinFHEParams) -> torch.Tensor:
    """Exact or approximate gadget digits: [..., d_g_used] int8."""
    if p.d_g_eff:
        return gadget_digits_approx_dev(acc, p.Q, p.B_g, p.d_g_eff, p.g_shift)
    return gadget_digits_dev(acc, p.B_g, p.d_g)


def monomial_rotate(P: torch.Tensor, c: torch.Tensor, N: int, Q: int) -> torch.Tensor:
    """P [B, ..., N] * X^{c[B]} in Z_Q[X]/(X^N+1), c in [0, 2N): one gather
    (cyclic rotation by c mod N) and the negacyclic sign fix."""
    cb = c.to(torch.int64).reshape((P.shape[0],) + (1,) * (P.ndim - 1))
    cp = cb & (N - 1)
    k = torch.arange(N, device=P.device)
    x = torch.gather(P, -1, ((k - cp) & (N - 1)).expand(P.shape))
    wrap = (k < cp) ^ (cb >= N)
    return torch.where(wrap, torch.where(x == 0, 0, Q - x), x)


def tile_digits(x: torch.Tensor, p: BinFHEParams) -> torch.Tensor:
    """Gadget digits of x int32 [B, 2, N], int8 [B, nt*R*T] at column
    j*RT + (poly*d_used + digit)*T + u for coefficient j*T + u."""
    B, _, N = x.shape
    digs = acc_gadget_digits_dev(x, p)  # [B, poly, N, digit]
    digs = digs.reshape(B, 2, N // TILE, TILE, p.d_g_used).permute(0, 2, 1, 4, 3)
    return digs.reshape(B, -1)


def amount_pairs(a: torch.Tensor, N: int) -> torch.Tensor:
    """Rotation amounts a in [0, 2N), any shape -> the GINX pair
    (c_pos, c_neg) = ((2N - a) mod 2N, a), int32 [..., 2]."""
    return torch.stack([(2 * N - a) & (2 * N - 1), a], dim=-1)


def rot_diff_digits(acc: torch.Tensor, amt: torch.Tensor, p: BinFHEParams) -> torch.Tensor:
    """Digits of both parts' rotated differences (X^amt[b, part] acc - acc)
    mod Q, int8 [B, nt*2R*T] at column j*2RT + part*RT + (poly*d_used +
    digit)*T + u for coefficient j*T + u (the rev2 row order)."""
    B, _, N = acc.shape
    Q = p.Q
    parts = []
    for part in (0, 1):
        diff = monomial_rotate(acc, amt[:, part], N, Q) - acc
        diff = torch.where(diff < 0, diff + Q, diff)
        parts.append(tile_digits(diff, p).reshape(B, N // TILE, -1))
    return torch.stack(parts, dim=2).reshape(B, -1)


def tile_products_raw(dig: torch.Tensor, rev: torch.Tensor) -> torch.Tensor:
    """Plain twin of the step loops' int8 product: digits int8 [B, K] against
    reversed diagonals int8 [(2nt-1)*K/nt, M*T], output tile k contracting
    rows [(nt-1-k)*K/nt, +K).  Returns the limb sums int32 [B, M, N],
    plane m at columns k*T + t.  The contraction runs in float64, exact
    because |sum| <= K * 128 * 128 <= 2**27 < 2**53 (torch has no integer
    matmul on CUDA)."""
    B, K = dig.shape
    rows = 2 * K - rev.shape[0]  # per diagonal: nt*rows = K, (2nt-1)*rows = len(rev)
    nt = K // rows
    M = rev.shape[1] // TILE
    x = dig.to(torch.float64)
    out = torch.empty((B, M, nt * TILE), dtype=torch.int32, device=dig.device)
    for k in range(nt):
        w = rev[(nt - 1 - k) * rows : (nt - 1 - k) * rows + K].to(torch.float64)
        out[:, :, k * TILE : (k + 1) * TILE] = (x @ w).to(torch.int32).reshape(B, M, TILE)
    return out


def combine_planes(raw: torch.Tensor, Q: int) -> torch.Tensor:
    """Limb sums int32 [B, 4P, N], planes (poly, limb) with the limb minor
    -> int32 [B, P, N] mod Q: the Horner combine of each poly's 4 limbs."""
    B, M, N = raw.shape
    return combine_limbs_mod_q(raw.reshape(B, M // 4, 4, N).movedim(2, -1), Q)


def tile_products(dig: torch.Tensor, rev: torch.Tensor, Q: int) -> torch.Tensor:
    """Plain twin of the step loops' product and limb combine: int32
    [B, M/4, N] mod Q, one polynomial per 4 limb planes."""
    return combine_planes(tile_products_raw(dig, rev), Q)


def rot_step_plain(
    acc: torch.Tensor, rev2_i: torch.Tensor, amt: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """One step for the amount pair amt int32 [B, 2]: red31(acc + both
    parts' products)."""
    return red31(acc + tile_products(rot_diff_digits(acc, amt, p), rev2_i, p.Q), p.Q)


def blind_rotate_rot_plain(
    acc: torch.Tensor, rev2_all: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """All steps with torch ops: acc int32 [B, 2, N], rev2_all int8
    [n, (2nt-1)*2R*T, 8T], a2N int32 [B, n] in [0, 2N)."""
    global PLAIN_LAUNCHES
    PLAIN_LAUNCHES += 1
    amt = amount_pairs(a2N, acc.shape[-1])  # [B, n, 2]
    for i in range(rev2_all.shape[0]):
        acc = rot_step_plain(acc, rev2_all[i], amt[:, i], p)
    return acc


SPLIT_BLOCKS = 128  # the split GEMM's blocks, at most (one wave on the H100's 132 SMs)
SMEM_MAX = 232448  # shared memory a block can use on the H100


def split_groups(N: int, polys: int) -> tuple[int, int]:
    """(diagonals per group, groups) of the split GEMM (step_gemm.cuh:
    split_dpg): the 2nt-1 diagonals of a block in at most SPLIT_BLOCKS /
    (polys * T/16) groups of consecutive ones, one block per (group, column
    chunk): 8 groups at 2 output polys (the rotated form, AP, #8 at 8
    planes), 4 at 4 (the standard form)."""
    ndiag = 2 * (N // TILE) - 1
    dpg = -(-ndiag // (SPLIT_BLOCKS // (polys * (TILE // GEMM_CHUNK))))
    return dpg, -(-ndiag // dpg)


def split_smem(NB: int, sub: int, dpg: int) -> int:
    """Shared memory of a split GEMM block (step_gemm.cuh: split_smem): the
    digit chunks (sub substages of dpg + 7 chunks of NB gates), 8 stages
    of key tiles and their barriers, the epilogue's staging buffer."""
    return (1024 + sub * (dpg + 7) * NB * GEMM_BK + 8 * (4 * GEMM_CHUNK * GEMM_BK + 16) + 8
            + 4 * GEMM_CHUNK * (NB + 1) * 4)


def gemm_config(B: int, N: int, sub: int, polys: int, smem=split_smem) -> tuple[int, int, bool]:
    """(NB gates per tile, MW math warpgroups, split) of a step GEMM for B
    gates, the one rule of every rotation's GEMM: the GINX wrappers pass NB
    to the kernels and size their scratch by it (split and MW follow from
    NB and B), and csrc/step_gemm.cuh's gemm_tile repeats it for AP's
    steps.  Up to 16 gates the split GEMM (NB = 8 or 16) where nt <= 8 and
    ``smem(NB, sub, dpg)``, the family's split GEMM block's shared memory
    (``split_smem`` here, ``ap.split_smem``) for sub = 2RT/128 (the rotated
    form) or RT/128 (the standard form, AP) digit substages and dpg
    diagonals of ``split_groups(N, polys)``, fits.  Else the tiled GEMM
    on ceil(B / 256) gate tiles of NB gates, NB the least multiple of 16
    (at least 32) that they hold B in: a tile of 144 gates for 132, two of
    160 for 300; above 256 gates two warpgroups share each digit tile.
    wgmma takes any multiple of 16 up to 256 as its N, so each tile
    computes fewer than 16 rows past B."""
    NB = 8 if B <= 8 else 16
    if B <= 16 and N // TILE <= 8 and smem(NB, sub, split_groups(N, polys)[0]) <= SMEM_MAX:
        return NB, 1, True
    tiles = -(-B // 256)
    return max(32, 16 * -(-B // (16 * tiles))), 1 if tiles == 1 else 2, False


def split_digit_box(c: int, d_lo: int, N: int) -> tuple[int, int]:
    """(first digit chunk j0, substage c) of the split GEMM's digit box for
    substage c of a block whose diagonals start at d_lo: the chunks j0 ..
    j0 + dpg + 6 of the NB gates, chunk j at the contraction bytes j*2RT +
    128c .. +127; chunks outside [0, nt) are zeros (at NB = 8 zeroed in
    shared memory and not loaded, at 16 filled by the TMA unit)."""
    return d_lo - (N // TILE - 1), c


EARLY_STAGES = 4  # key stages a split GEMM block loads before its wait (step_gemm.cuh: EARLY)
KEY_STAGE_BYTES = 4 * GEMM_CHUNK * GEMM_BK  # one key box: 64 key columns x 128 bytes


def split_blocks(N: int, R2T: int, polys: int, dpg: int, groups: int) -> list[tuple[int, int, int]]:
    """The split GEMM's blocks (column chunk cc, diagonal group grp, key
    stages), block cc + chunks*grp, chunks = polys*T/16: diagonals grp*dpg
    .. +dpg-1 (the last group fewer), R2T / 128 stages each."""
    ndiag, chunks = 2 * (N // TILE) - 1, polys * (TILE // GEMM_CHUNK)
    return [(cc, grp, (min(grp * dpg + dpg, ndiag) - grp * dpg) * (R2T // GEMM_BK))
            for grp in range(groups) for cc in range(chunks)]


def early_boxes(cc: int, grp: int, step: int, N: int, d_used: int,
                whole: bool = True) -> list[tuple[int, int, int, int]]:
    """The key boxes (contraction byte, coefficient t0, plane, key step)
    that block (cc, grp) of the rotation's split GEMM at step ``step``
    loads before it waits for the digits kernel: the first EARLY_STAGES
    stages of its own slice, in its loader's order (diagonal, then
    substage).  None where the call is not a whole rotation on the
    prebuilt key (``whole`` False: #11's one step, the ginx_ext ring), whose
    GEMMs wait before they load."""
    R2T, dpg = 4 * d_used * TILE, split_groups(N, 2)[0]
    sub, d_lo = R2T // GEMM_BK, grp * dpg
    stages = (min(d_lo + dpg, 2 * (N // TILE) - 1) - d_lo) * sub
    return [(*key_box_origin((d_lo + q // sub) * R2T + q % sub * GEMM_BK, cc), step)
            for q in range(min(EARLY_STAGES, stages) if whole else 0)]


def key_prefetch_bytes(n: int, N: int, R2T: int, polys: int, NB: int) -> int:
    """Key bytes that the split GEMMs (NB <= 16) of n steps of a whole
    rotation on a prebuilt key load ahead of the step chain, before their
    wait for the digits kernel: each block's first EARLY_STAGES stages (at
    most its stages) at each step, R2T contraction bytes a diagonal and
    ``polys`` output polys; none for the tiled GEMM (NB >= 32)."""
    if NB > 16:
        return 0
    blocks = split_blocks(N, R2T, polys, *split_groups(N, polys))
    return n * sum(min(EARLY_STAGES, st) for _, _, st in blocks) * KEY_STAGE_BYTES


def gemm_tiles(B: int, N: int, sub: int, polys: int) -> list[tuple[int, int, int]]:
    """The tiled GEMM's tiles (gate tile gt, output tile k, column tile ct)
    in the order the persistent blocks take them, gate tile fastest; math
    warpgroup w of tile ct takes column chunk cc = ct*MW + w (poly cc //
    8, coefficients 16*(cc % 8) ..)."""
    NB, MW, _ = gemm_config(B, N, sub, polys)
    col_tiles = polys * (TILE // GEMM_CHUNK) // MW
    return [(gt, k, ct) for k in range(N // TILE) for ct in range(col_tiles)
            for gt in range(-(-B // NB))]


def key_box_origin(x: int, cc: int) -> tuple[int, int, int]:
    """(contraction byte, coefficient t0, plane) of the TMA box of column
    chunk cc = o*8 + t0/16 at contraction byte x: planes 4o .. 4o+3 (the 4
    limbs of poly o), coefficients t0 .. t0+15, bytes x .. x+127 of the
    K-major block [8, T, rows]; limb l lands at rows 16l of the 64-row
    tile.  Stage c of the tiled GEMM's output tile k is at x = (nt-1-k)*2RT
    + 128c; stage (d', s) of the split GEMM at x = d'*2RT + 128s."""
    return x, cc % (TILE // GEMM_CHUNK) * GEMM_CHUNK, 4 * (cc // (TILE // GEMM_CHUNK))


def check_operands(name: str, acc, key, a2N) -> None:
    """What both rotation wrappers require: int32 acc [B, 2, N] and a2N,
    an int8 key, one device, contiguous memory."""
    if acc.dtype != torch.int32 or a2N.dtype != torch.int32 or key.dtype != torch.int8:
        raise TypeError(
            f"{name}: want int32 acc/a2N and an int8 key, got "
            f"{acc.dtype}, {a2N.dtype}, {key.dtype}"
        )
    if not (acc.device == key.device == a2N.device):
        raise ValueError(f"{name}: tensors on different devices")
    if not (acc.is_contiguous() and key.is_contiguous() and a2N.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    if acc.ndim != 3 or acc.shape[1] != 2 or acc.shape[2] % TILE:
        raise ValueError(f"{name}: bad accumulator shape {tuple(acc.shape)}")


def _check(acc, rev2, amounts, p: BinFHEParams, name="blind_rotate_rot", one_step=False) -> None:
    """Whole rotations take rev2 [n, rows, 8T] (on the card K-major,
    [n, 8, T, rows]) and a2N [B, n]; one step takes its block and amount
    pairs [B, 2]."""
    check_operands(name, acc, rev2, amounts)
    B, _, N = acc.shape
    kmajor = acc.is_cuda
    n = rev2.shape[0] if rev2.ndim == (4 if kmajor else 3) else 1
    block = keys.rev2_shape(n, 2 * p.d_g_used, N, kmajor)[1:]
    if kmajor and rev2.ndim == len(block) - one_step and rev2.shape[-1] == 8 * TILE:
        raise ValueError(
            f"{name}: a row-major rev2 key on the card: the kernel reads it K-major, "
            f"{block}; convert it once (keys.rev2_to, BootKeys.to('cuda'))"
        )
    want = (block, (B, 2)) if one_step else ((n, *block), (B, n))
    if N != p.N or (rev2.shape, amounts.shape) != want:
        raise ValueError(
            f"{name}: bad shapes acc {tuple(acc.shape)}, rev2 "
            f"{tuple(rev2.shape)}, amounts {tuple(amounts.shape)} for N={p.N}"
        )


def gemm_rows(B: int, NB: int) -> int:
    """The gate rows the step GEMM of gate tile NB computes for B gates: B
    for the split GEMM (NB <= 16), B rounded up to the tiled GEMM's gate
    tile."""
    return B if NB <= 16 else -(-B // NB) * NB


def count_gemm(B: int, NB: int, N: int, R2T: int, polys: int, early_steps: int) -> None:
    """Count, under a traced Clock, a GINX rotation's step GEMM of gate
    tile NB on B gates: its gate rows, ``padded_lanes``, and the key bytes
    its split GEMMs load ahead of the step chain over ``early_steps``
    steps (0 where no GEMM loads before its wait), ``key_prefetch_bytes``."""
    if trace.ACTIVE is not None:
        trace.count("padded_lanes", gemm_rows(B, NB))
        trace.count("key_prefetch_bytes", key_prefetch_bytes(early_steps, N, R2T, polys, NB))


def digit_scratch(B: int, K: int, NB: int, device) -> torch.Tensor:
    """A step loop's digit scratch int8 [rows, K]: B rounded up to the
    GEMM's gate tile of NB gates (the split GEMM's one tile, the tiled
    GEMM's last), the rows from B on zero (the digits kernel writes the
    others), so that the digit boxes read zeros from memory where the TMA
    unit would fill rows past the end of the map with zeros itself, at
    ~3.4 ns a row and block (a 132-gate STD128 step's GEMM took twice the
    256-gate one's; PERF.md, section 5)."""
    rows = -(-B // NB) * NB
    dig = torch.empty((rows, K), dtype=torch.int8, device=device)
    if rows > B:
        dig[B:].zero_()
    return dig


def _tile(B: int, p: BinFHEParams) -> int:
    """The gate tile NB of the rotated form's step GEMM for B gates."""
    return gemm_config(B, p.N, 4 * p.d_g_used, 2)[0]


def _scratch(acc, p: BinFHEParams, NB: int):
    """The step loop's scratch for gate tile NB: the digits
    (``digit_scratch``) and the split GEMM's two sums of products int32
    [2, B, 2, N] (empty for the tiled GEMM)."""
    B, _, N = acc.shape
    K = N // TILE * 2 * 2 * p.d_g_used * TILE
    dig = digit_scratch(B, K, NB, acc.device)
    sums = torch.empty((2, B, 2, N) if NB <= 16 else (0,), dtype=torch.int32, device=acc.device)
    return dig, sums


def _blind_rotate_rot_cuda(acc, rev2_all, a2N, p: BinFHEParams, NB: int) -> torch.Tensor:
    global LAUNCHES, STEP_LAUNCHES
    B, _, N = acc.shape
    n = rev2_all.shape[0]
    if B == 0 or n == 0:
        return acc.clone()
    lib = _build.load()
    bufs = (acc.clone(), torch.empty_like(acc))
    dig, sums = _scratch(acc, p, NB)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    rc = lib.oece_blind_rotate_rot(
        bufs[0].data_ptr(), bufs[1].data_ptr(), dig.data_ptr(), sums.data_ptr(),
        rev2_all.data_ptr(), a2N.data_ptr(), B, NB, dig.shape[0], n, N, p.d_g_used,
        int(math.log2(p.B_g)), p.g_shift, p.Q, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"rot_step.cu launch failed: {lib.oece_error_string(rc).decode()}"
        )
    LAUNCHES += 1
    STEP_LAUNCHES += n
    return bufs[n % 2]


def blind_rotate_rot(
    acc: torch.Tensor, rev2_all: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """The whole rotation.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (or raise); any other device raises.  Under a traced
    Clock it counts its step GEMM (``count_gemm``), on either device."""
    _check(acc, rev2_all, a2N, p)
    B, n = acc.shape[0], rev2_all.shape[0]
    NB = _tile(B, p)
    count_gemm(B, NB, p.N, 4 * p.d_g_used * TILE, 2, n)
    if acc.device.type == "cpu":
        return blind_rotate_rot_plain(acc, rev2_all, a2N, p)
    if acc.device.type != "cuda":
        raise ValueError(f"blind_rotate_rot: no kernel for device {acc.device}")
    return _blind_rotate_rot_cuda(acc, rev2_all, a2N, p, NB)


def _rot_step_cuda(acc, rev2_i, amt, p: BinFHEParams, out) -> torch.Tensor:
    global SINGLE_STEP_LAUNCHES
    if out is None:
        out = torch.empty_like(acc)
    elif (out.shape != acc.shape or out.dtype != acc.dtype or out.device != acc.device
          or not out.is_contiguous()):
        raise ValueError("rot_step_true: out must be a contiguous tensor like acc")
    else:
        lo, hi = acc.data_ptr(), acc.data_ptr() + acc.numel() * 4
        if out.data_ptr() < hi and lo < out.data_ptr() + out.numel() * 4:
            raise ValueError("rot_step_true: out must not overlap acc")
    B, _, N = acc.shape
    if B == 0:
        return out
    lib = _build.load()
    NB = _tile(B, p)
    dig, sums = _scratch(acc, p, NB)
    rc = lib.oece_rot_step(
        acc.data_ptr(), out.data_ptr(), dig.data_ptr(), sums.data_ptr(), rev2_i.data_ptr(), amt.data_ptr(),
        B, NB, dig.shape[0], N, p.d_g_used, int(math.log2(p.B_g)), p.g_shift, p.Q,
        torch.cuda.current_stream(acc.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"rot_step.cu launch failed: {lib.oece_error_string(rc).decode()}")
    SINGLE_STEP_LAUNCHES += 1
    return out


def rot_step_true(
    acc: torch.Tensor, rev2_i: torch.Tensor, amt: torch.Tensor, p: BinFHEParams, out=None
) -> torch.Tensor:
    """#11: one step, acc int32 [B, 2, N] in [0, Q), the step's block
    rev2_i int8 [(2nt-1)*2R*T, 8T] (on the card K-major, [8, T,
    (2nt-1)*2R*T]) and any amount pair amt int32 [B, 2] in
    [0, 2N) -> the next accumulator, written to ``out`` when given (on the
    card it must not overlap acc).  CPU tensors run ``rot_step_plain``;
    CUDA tensors launch ``oece_rot_step`` (or raise)."""
    global PLAIN_LAUNCHES
    _check(acc, rev2_i, amt, p, name="rot_step_true", one_step=True)
    if acc.device.type == "cpu":
        PLAIN_LAUNCHES += 1
        res = rot_step_plain(acc, rev2_i, amt, p)
        return res if out is None else out.copy_(res)
    if acc.device.type != "cuda":
        raise ValueError(f"rot_step_true: no kernel for device {acc.device}")
    return _rot_step_cuda(acc, rev2_i, amt, p, out)


def blind_rotate_rot_steps(
    acc: torch.Tensor, rev2_all: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """The whole rotation as a Python loop of ``rot_step_true``, one call
    per step, as the JAX package's ``OECE_ROT_MEGA=0`` scan: the same
    values as ``blind_rotate_rot``.  On the card the accumulator ping-pongs
    between two buffers; acc itself is not written.  Under a traced Clock
    it counts the steps' GEMM (``count_gemm``), whose GEMMs wait before
    they load: no key bytes ahead of the step chain."""
    _check(acc, rev2_all, a2N, p, name="blind_rotate_rot_steps")
    count_gemm(acc.shape[0], _tile(acc.shape[0], p), p.N, 4 * p.d_g_used * TILE, 2, 0)
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blind_rotate_rot_steps: no kernel for device {acc.device}")
    n = rev2_all.shape[0]
    if n == 0:
        return acc.clone()
    amt = amount_pairs(a2N.t(), p.N).contiguous()  # [n, B, 2]
    bufs = (torch.empty_like(acc), torch.empty_like(acc)) if acc.is_cuda else (None, None)
    for i in range(n):
        acc = rot_step_true(acc, rev2_all[i], amt[i], p, out=bufs[i % 2])
    return acc
