"""The GINX blind rotation in the CGGI rotated-difference form.

Counterpart of ``oece_tpu.fhe.pallas_kernels.blind_rotate_rot_megakernel``
(-> ``_rot_megakernel``, ``_rot_diff_decompose``, ``_decompose_lanes``,
``_combine_limbs_tile``).  For each step i and gate b, with a = a2N[b, i]:

    acc <- red31(acc + K+_i ⊡ dec((X^{2N-a} - 1) acc) + K-_i ⊡ dec((X^a - 1) acc))

where ⊡ is one int8 contraction per 128-coefficient output tile against the
step's rev2 diagonals, followed by the Horner combine of the 4 key limbs.

``blind_rotate_rot`` dispatches on the device of its tensors: CPU tensors
take ``blind_rotate_rot_plain`` (torch ops), CUDA tensors launch the
hand-written step loop of ``csrc/rot_step.cu`` or raise.

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

from . import _build
from .modmath import combine_limbs_mod_q, red31
from .params import BinFHEParams

TILE = 128

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
    """Plain twin of int8_mm_kernel's product: digits int8 [B, K] against
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
    """Plain twin of int8_mm_kernel's product and limb combine: int32
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
    """Whole rotations take rev2 [n, rows, 8T] and a2N [B, n]; one step
    takes its block [rows, 8T] and amount pairs [B, 2]."""
    check_operands(name, acc, rev2, amounts)
    B, _, N = acc.shape
    block = ((2 * (N // TILE) - 1) * 2 * 2 * p.d_g_used * TILE, 8 * TILE)
    want = (block, (B, 2)) if one_step else ((rev2.shape[0], *block), (B, rev2.shape[0]))
    if N != p.N or (rev2.shape, amounts.shape) != want:
        raise ValueError(
            f"{name}: bad shapes acc {tuple(acc.shape)}, rev2 "
            f"{tuple(rev2.shape)}, amounts {tuple(amounts.shape)} for N={p.N}"
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
    dig = torch.empty((B, N // TILE * 2 * 2 * p.d_g_used * TILE), dtype=torch.int8, device=acc.device)
    rc = lib.oece_rot_step(
        acc.data_ptr(), out.data_ptr(), dig.data_ptr(), rev2_i.data_ptr(), amt.data_ptr(),
        B, N, p.d_g_used, int(math.log2(p.B_g)), p.g_shift, p.Q,
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
    rev2_i int8 [(2nt-1)*2R*T, 8T] and any amount pair amt int32 [B, 2] in
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
    between two buffers; acc itself is not written."""
    _check(acc, rev2_all, a2N, p, name="blind_rotate_rot_steps")
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
