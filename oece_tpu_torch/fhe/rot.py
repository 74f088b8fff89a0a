"""The GINX blind rotation in the CGGI rotated-difference form.

Counterpart of ``oece_tpu.fhe.pallas_kernels.blind_rotate_rot_megakernel``
(-> ``_rot_megakernel``, ``_rot_diff_decompose``, ``_decompose_lanes``,
``_combine_limbs_tile``).  For each step i and gate b, with a = a2N[b, i]:

    acc <- red31(acc + K+_i ⊡ dec((X^{2N-a} - 1) acc) + K-_i ⊡ dec((X^a - 1) acc))

where ⊡ is one int8 contraction per 128-coefficient output tile against the
step's rev2 diagonals, followed by the Horner combine of the 4 key limbs.

``blind_rotate_rot`` dispatches on the device of its tensors: CPU tensors
take ``blind_rotate_rot_plain`` (torch ops), CUDA tensors launch the
hand-written kernel of ``csrc/rot_step.cu`` or raise.  ``LAUNCHES`` and
``PLAIN_LAUNCHES`` count the calls that reached each version.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .modmath import combine_limbs_mod_q, red31
from .params import BinFHEParams

TILE = 128

LAUNCHES = 0  # calls that launched the CUDA kernel (one per rotation)
PLAIN_LAUNCHES = 0  # calls that ran the plain torch version
STEP_LAUNCHES = 0  # launches of each kernel of the CUDA step loop (one per step)


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


def rot_diff_digits(acc: torch.Tensor, a_col: torch.Tensor, p: BinFHEParams) -> torch.Tensor:
    """Digits of both parts' rotated differences, int8 [B, nt*2R*T] at
    column j*2RT + part*RT + (poly*d_used + digit)*T + u for coefficient
    j*T + u (the rev2 row order)."""
    B, _, N = acc.shape
    Q = p.Q
    c_pos = (2 * N - a_col) & (2 * N - 1)
    parts = []
    for c in (c_pos, a_col):
        diff = monomial_rotate(acc, c, N, Q) - acc
        diff = torch.where(diff < 0, diff + Q, diff)
        parts.append(tile_digits(diff, p).reshape(B, N // TILE, -1))
    return torch.stack(parts, dim=2).reshape(B, -1)


def tile_products(dig: torch.Tensor, rev: torch.Tensor, Q: int) -> torch.Tensor:
    """Plain twin of int8_mm_kernel's product and limb combine: digits int8
    [B, K] against reversed diagonals int8 [(2nt-1)*K/nt, P*4*T], output
    tile k contracting rows [(nt-1-k)*K/nt, +K).  Returns int32 [B, P, N]
    mod Q, one polynomial per 4 limb planes.  The contraction runs in
    float64, exact because |sum| <= K * 128 * 128 <= 2**27 < 2**53 (torch
    has no integer matmul on CUDA)."""
    B, K = dig.shape
    rows = 2 * K - rev.shape[0]  # per diagonal: nt*rows = K, (2nt-1)*rows = len(rev)
    nt = K // rows
    polys = rev.shape[1] // (4 * TILE)
    x = dig.to(torch.float64)
    out = torch.empty((B, polys, nt * TILE), dtype=torch.int32, device=dig.device)
    for k in range(nt):
        w = rev[(nt - 1 - k) * rows : (nt - 1 - k) * rows + K].to(torch.float64)
        res = (x @ w).to(torch.int32).reshape(B, polys, 4, TILE)  # [b, poly, limb, t]
        out[:, :, k * TILE : (k + 1) * TILE] = combine_limbs_mod_q(res.movedim(2, -1), Q)
    return out


def rot_step_plain(
    acc: torch.Tensor, a_col: torch.Tensor, rev2_i: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """One step: red31(acc + both parts' products)."""
    return red31(acc + tile_products(rot_diff_digits(acc, a_col, p), rev2_i, p.Q), p.Q)


def blind_rotate_rot_plain(
    acc: torch.Tensor, rev2_all: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """All steps with torch ops: acc int32 [B, 2, N], rev2_all int8
    [n, (2nt-1)*2R*T, 8T], a2N int32 [B, n] in [0, 2N)."""
    global PLAIN_LAUNCHES
    PLAIN_LAUNCHES += 1
    for i in range(rev2_all.shape[0]):
        acc = rot_step_plain(acc, a2N[:, i], rev2_all[i], p)
    return acc


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


def _check(acc, rev2_all, a2N, p: BinFHEParams) -> None:
    check_operands("blind_rotate_rot", acc, rev2_all, a2N)
    B, _, N = acc.shape
    nt = N // TILE
    rows = (2 * nt - 1) * 2 * 2 * p.d_g_used * TILE
    n = rev2_all.shape[0]
    if N != p.N or rev2_all.shape[1:] != (rows, 8 * TILE) or a2N.shape != (B, n):
        raise ValueError(
            f"blind_rotate_rot: bad shapes acc {tuple(acc.shape)}, rev2 "
            f"{tuple(rev2_all.shape)}, a2N {tuple(a2N.shape)} for N={p.N}"
        )


def _blind_rotate_rot_cuda(acc, rev2_all, a2N, p: BinFHEParams) -> torch.Tensor:
    global LAUNCHES, STEP_LAUNCHES
    B, _, N = acc.shape
    n = rev2_all.shape[0]
    if B == 0 or n == 0:
        return acc.clone()
    lib = _build.load()
    nt = N // TILE
    K = nt * 2 * 2 * p.d_g_used * TILE
    bufs = (acc.clone(), torch.empty_like(acc))
    dig = torch.empty((B, K), dtype=torch.int8, device=acc.device)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    rc = lib.oece_blind_rotate_rot(
        bufs[0].data_ptr(), bufs[1].data_ptr(), dig.data_ptr(),
        rev2_all.data_ptr(), a2N.data_ptr(), B, n, N, p.d_g_used,
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
    launch the kernel (or raise); any other device raises."""
    _check(acc, rev2_all, a2N, p)
    if acc.device.type == "cpu":
        return blind_rotate_rot_plain(acc, rev2_all, a2N, p)
    if acc.device.type != "cuda":
        raise ValueError(f"blind_rotate_rot: no kernel for device {acc.device}")
    return _blind_rotate_rot_cuda(acc, rev2_all, a2N, p)
