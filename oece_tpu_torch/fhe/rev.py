"""The GINX blind rotation, standard form, on diagonals prebuilt at keygen
(the "rev" key layout).

Counterpart of the JAX package's ``OECE_LAYOUT=rev`` split pipeline:
``oece_tpu.fhe.boot.blind_rotate_ginx_dev`` scanning
``_external_cmux_prebuilt`` over the n key steps, with the Pallas kernels it
reaches:

  #8  window_matmul_true      digits int8 [B, nt*R*T] x one step's block
                              int8 [(2nt-1)*R*T, M*T] -> int32 [B, M/4, N]
                              mod Q, limb-combined (M = 16 or 8)
  #9  window_matmul_dec_true  acc int32 [B, 2, N] -> its gadget digits -> #8
  #10 cmux_epilogue_true      red31(acc + X^c0 P0 + X^c1 P1 + 2Q - P0 - P1)
                              for P int32 [B, 2, 2, N] and any amount pair
                              amt int32 [B, 2] in [0, 2N)

A rev block is what the standard form's build #1 makes from ginx_ext
(``keys.rev_block``), so a step here is a fhe/std.py step without the
build: ``blind_rotate_rev`` on ``keys.build_rev(brk)`` equals
``blind_rotate_std`` on ``keys.ginx_ext_planes(brk)``; for step i and gate
b, with a = a2N[b, i], (c0, c1) = (2N - a, a).

Each wrapper runs its plain twin (``*_plain``) for CPU tensors, on the
row-major key or block; for CUDA tensors it launches its kernels or
raises.  On the card ``blind_rotate_rev``, ``window_matmul_true`` and
``window_matmul_dec_true`` take the rev key K-major, [n, 16, T, rows] (one
step's block [M, T, rows]; keys.py), and refuse a row-major one: they run
csrc/rev_step.cu, two kernels per step, the digits (with the previous
step's CMUX) and a TMA + wgmma GEMM with 64 key columns on wgmma's M and
the gates on its N: up to 16 gates a split GEMM that reads each key tile
once and adds partial sums by atomics, above 16 a tiled one that reads
its digits from scratch padded to the gate tile (``step_scratch``) and
writes the products mod Q.  Each wrapper takes the gate tile from rot.py's
``gemm_config`` (RT/128 digit substages, 4 output polys, or M/4), passes
it to the kernels and sizes its scratch by it; ``blind_rotate_rev``
counts it (rot.py's ``count_gemm``).  rot.py's ``split_groups`` and
``gemm_tiles`` repeat the kernels' tiling for the CPU layout tests; the
TMA boxes start where rot.py's ``key_box_origin`` and ``split_digit_box``
say, with RT contraction bytes per diagonal instead of 2RT.  ``window_matmul_counted`` (#2: #8's
function on a row-major block, for fhe/negacyclic.py) runs the same
GEMMs on the block transposed K-major into scratch by #3's
transpose_kernel (csrc/negacyclic.cu, one call of both launches);
``cmux_epilogue_true`` (#10 alone, any amount pairs) launches
csrc/std_step.cu's kernel.

``LAUNCHES`` counts the wrapper calls that launched on the card,
``PLAIN_LAUNCHES`` those that ran a plain twin, ``STEP_LAUNCHES`` the
steps of ``blind_rotate_rev``'s step loop launched on the card: per step
one digits kernel (with the previous step's CMUX) and one GEMM, and per
rotation one more digits launch for the last step's CMUX.
"""

from __future__ import annotations

import math

import torch

from . import _build, keys
from .keys import TILE
from .modmath import red31
from .params import BinFHEParams
from .rot import (amount_pairs, check_operands, count_gemm, digit_scratch, gemm_config,
                  monomial_rotate, tile_digits, tile_products)

LAUNCHES = 0  # wrapper calls that launched CUDA kernels
PLAIN_LAUNCHES = 0  # wrapper calls that ran a plain twin
STEP_LAUNCHES = 0  # steps of blind_rotate_rev's step loop launched on the card


def window_matmul_true_plain(digs_rows: torch.Tensor, rev_flat: torch.Tensor, Q: int) -> torch.Tensor:
    """#8: digits int8 [B, nt*R*T] against one block -> int32 [B, M/4, N]
    mod Q."""
    return tile_products(digs_rows, rev_flat, Q)


def window_matmul_dec_true_plain(acc: torch.Tensor, rev_flat: torch.Tensor, p: BinFHEParams) -> torch.Tensor:
    """#9: the gadget digits of acc int32 [B, 2, N], then #8."""
    return tile_products(tile_digits(acc, p), rev_flat, p.Q)


def cmux_epilogue_true_plain(P: torch.Tensor, acc: torch.Tensor, amt: torch.Tensor, Q: int) -> torch.Tensor:
    """#10: red31(acc + X^amt0 P0 + X^amt1 P1 + 2Q - P0 - P1) for P int32
    [B, 2, 2, N] in [0, Q), acc [B, 2, N] and amt int32 [B, 2] in [0, 2N)
    (boot.py:358-363 with any amounts)."""
    N = acc.shape[-1]
    rot0 = monomial_rotate(P[:, 0], amt[:, 0], N, Q)
    rot1 = monomial_rotate(P[:, 1], amt[:, 1], N, Q)
    return red31(acc + rot0 + rot1 + (2 * Q - P[:, 0] - P[:, 1]), Q)


def rev_step_plain(acc: torch.Tensor, a_col: torch.Tensor, rev_i: torch.Tensor, p: BinFHEParams) -> torch.Tensor:
    """One step (``_external_cmux_prebuilt``): #9, then #10 with (2N - a, a)."""
    B, _, N = acc.shape
    P4 = window_matmul_dec_true_plain(acc, rev_i, p)
    return cmux_epilogue_true_plain(P4.reshape(B, 2, 2, N), acc, amount_pairs(a_col, N), p.Q)


def blind_rotate_rev_plain(
    acc: torch.Tensor, rev_all: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """All n steps with torch ops: acc int32 [B, 2, N], rev_all int8
    [n, (2nt-1)*R*T, 16T], a2N int32 [B, n] in [0, 2N)."""
    global PLAIN_LAUNCHES
    PLAIN_LAUNCHES += 1
    for i in range(rev_all.shape[0]):
        acc = rev_step_plain(acc, a2N[:, i], rev_all[i], p)
    return acc


def _on_card(name: str, *ts: torch.Tensor) -> bool:
    """False for CPU tensors (the plain twin runs), True for CUDA tensors;
    raises for mixed or other devices and for non-contiguous tensors."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: tensors on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type == "cuda"


def _block_planes(name: str, block: torch.Tensor, R: int, nt: int) -> int:
    """The plane count M of a block int8 [(2nt-1)*R*T, M*T], M = 16 or 8."""
    if block.dtype != torch.int8:
        raise TypeError(f"{name}: want an int8 block, got {block.dtype}")
    M = block.shape[1] // TILE if block.ndim == 2 else 0
    if block.shape != ((2 * nt - 1) * R * TILE, M * TILE) or M not in (16, 8):
        raise ValueError(
            f"{name}: bad block shape {tuple(block.shape)}: want "
            f"({(2 * nt - 1) * R * TILE}, M*{TILE}) with M = 16 or 8"
        )
    return M


def _plain(fn, *args) -> torch.Tensor:
    global PLAIN_LAUNCHES
    PLAIN_LAUNCHES += 1
    return fn(*args)


def _launch(name: str, rc: int, lib, source: str = "std_step.cu") -> None:
    global LAUNCHES
    if rc != 0:
        raise RuntimeError(f"{name}: {source} launch failed: {lib.oece_error_string(rc).decode()}")
    LAUNCHES += 1


def _aligned(name: str, *ts: torch.Tensor) -> None:
    """The matmuls load digits and key 16 bytes at a time (TMA boxes
    start 16-byte aligned)."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: digits and block must be 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_digits(name: str, dig: torch.Tensor, R: int, N: int = 0) -> tuple[int, int]:
    """(B, nt) of digits int8 [B, nt*R*T] (nt = N/T when N is given)."""
    if (dig.dtype != torch.int8 or dig.ndim != 2 or dig.shape[1] == 0
            or dig.shape[1] % (R * TILE) or (N and dig.shape[1] != N * R)):
        want = N * R if N else f"nt*{R}*{TILE}"
        raise ValueError(f"{name}: want int8 digits [B, {want}], got {dig.dtype} {tuple(dig.shape)}")
    return dig.shape[0], dig.shape[1] // (R * TILE)


def _kmajor_planes(name: str, block: torch.Tensor, R: int, nt: int) -> int:
    """The plane count M of a K-major block int8 [M, T, (2nt-1)*R*T], M = 16
    or 8; a row-major block on the card is refused."""
    rows = (2 * nt - 1) * R * TILE
    if block.dtype != torch.int8:
        raise TypeError(f"{name}: want an int8 block, got {block.dtype}")
    if block.ndim == 2 and block.shape[0] == rows:
        raise ValueError(
            f"{name}: a row-major rev block on the card: the kernel reads it K-major, "
            f"(M, {TILE}, {rows}); convert the key once (keys.rev_to, BootKeys.to('cuda'))"
        )
    if block.ndim != 3 or block.shape[1:] != (TILE, rows) or block.shape[0] not in (16, 8):
        raise ValueError(f"{name}: bad K-major block shape {tuple(block.shape)}: want "
                         f"(M, {TILE}, {rows}) with M = 16 or 8")
    return block.shape[0]


def _rev_launch(name: str, rc: int, lib) -> None:
    _launch(name, rc, lib, "rev_step.cu")


def window_matmul_true(digs_rows: torch.Tensor, rev_flat: torch.Tensor, R: int, Q: int) -> torch.Tensor:
    """#8: digs_rows int8 [B, nt*R*T] (tile_digits order) against one step's
    block, M = 16 or 8 planes -> int32 [B, M/4, N] limb-combined mod Q,
    true columns.  On the CPU rev_flat is the row-major block int8
    [(2nt-1)*R*T, M*T]; on the card the K-major block [M, T, (2nt-1)*R*T]
    (csrc/rev_step.cu's GEMM)."""
    name = "window_matmul_true"
    B, nt = _check_digits(name, digs_rows, R)
    if not _on_card(name, digs_rows, rev_flat):
        _block_planes(name, rev_flat, R, nt)
        return _plain(window_matmul_true_plain, digs_rows, rev_flat, Q)
    M = _kmajor_planes(name, rev_flat, R, nt)
    _aligned(name, digs_rows, rev_flat)
    out = torch.empty((B, M // 4, nt * TILE), dtype=torch.int32, device=digs_rows.device)
    if B == 0:
        return out
    lib = _build.load()
    NB = gemm_config(B, nt * TILE, R, M // 4)[0]
    rc = lib.oece_rev_window_matmul(digs_rows.data_ptr(), rev_flat.data_ptr(), out.data_ptr(), B,
                                    NB, nt * TILE, R, M // 4, Q, _stream(out))
    _rev_launch(name, rc, lib)
    return out


def window_matmul_counted(name: str, digs_rows: torch.Tensor, rev_flat: torch.Tensor, R: int, Q: int,
                          plain, launch) -> torch.Tensor:
    """#8's function on a row-major block rev_flat int8 [(2nt-1)*R*T, M*T]
    on either device, under the caller's counts: ``plain(fn, *args)`` runs
    the plain twin, ``launch(name, rc, lib)`` checks a launch's return code
    and counts it (fhe/negacyclic.py's #2 is this function).  On the card
    csrc/negacyclic.cu's oece_window_matmul: the block transposed into
    int8 scratch [M*T, rows] (K-major [M, T, rows]), then #8's GEMMs on
    it."""
    B, nt = _check_digits(name, digs_rows, R)
    M = _block_planes(name, rev_flat, R, nt)
    if not _on_card(name, digs_rows, rev_flat):
        return plain(window_matmul_true_plain, digs_rows, rev_flat, Q)
    _aligned(name, digs_rows, rev_flat)
    out = torch.empty((B, M // 4, nt * TILE), dtype=torch.int32, device=digs_rows.device)
    if B == 0:
        return out
    lib = _build.load()
    scratch = torch.empty((M * TILE, rev_flat.shape[0]), dtype=torch.int8, device=digs_rows.device)
    NB = gemm_config(B, nt * TILE, R, M // 4)[0]
    rc = lib.oece_window_matmul(
        digs_rows.data_ptr(), rev_flat.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, NB,
        nt * TILE, R, M // 4, Q, _stream(out),
    )
    launch(name, rc, lib)
    return out


def _check_acc(name: str, acc: torch.Tensor, p: BinFHEParams) -> None:
    if acc.dtype != torch.int32 or acc.ndim != 3 or acc.shape[1:] != (2, p.N):
        raise ValueError(f"{name}: want an int32 accumulator [B, 2, {p.N}], got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    if p.N % TILE:
        raise ValueError(f"{name}: needs N % {TILE} == 0, got {p.N}")


def window_matmul_dec_true(acc: torch.Tensor, rev_flat: torch.Tensor, p: BinFHEParams) -> torch.Tensor:
    """#9: acc int32 [B, 2, N] -> its gadget digits -> #8 against one
    step's block (row-major on the CPU, K-major on the card, as for
    ``window_matmul_true``) -> int32 [B, M/4, N]."""
    name = "window_matmul_dec_true"
    _check_acc(name, acc, p)
    B, _, N = acc.shape
    R, nt = 2 * p.d_g_used, N // TILE
    if not _on_card(name, acc, rev_flat):
        _block_planes(name, rev_flat, R, nt)
        return _plain(window_matmul_dec_true_plain, acc, rev_flat, p)
    M = _kmajor_planes(name, rev_flat, R, nt)
    _aligned(name, rev_flat)
    out = torch.empty((B, M // 4, N), dtype=torch.int32, device=acc.device)
    if B == 0:
        return out
    lib = _build.load()
    NB = gemm_config(B, N, R, M // 4)[0]
    dig = digit_scratch(B, nt * R * TILE, NB, acc.device)
    rc = lib.oece_rev_matmul_dec(
        acc.data_ptr(), dig.data_ptr(), rev_flat.data_ptr(), out.data_ptr(), B, NB, dig.shape[0], N,
        p.d_g_used, int(math.log2(p.B_g)), p.g_shift, M // 4, p.Q, _stream(out),
    )
    _rev_launch(name, rc, lib)
    return out


def cmux_epilogue_true(
    P: torch.Tensor, acc: torch.Tensor, amt: torch.Tensor, Q: int, zero_low_bits: int = 0
) -> torch.Tensor:
    """#10: P int32 [B, 2, 2, N] in [0, Q), acc int32 [B, 2, N], amt int32
    [B, 2] in [0, 2N) -> red31(acc + X^amt0 P0 + X^amt1 P1 + 2Q - P0 - P1),
    a new tensor.  ``zero_low_bits`` is the TPU kernel's count of barrel
    rounds to skip because every amount's low bits are known to be zero;
    the values equal the TPU's for such amounts and do not depend on it."""
    name = "cmux_epilogue_true"
    if zero_low_bits < 0:
        raise ValueError(f"{name}: zero_low_bits must be >= 0, got {zero_low_bits}")
    return cmux_epilogue_counted(name, P, acc, amt, Q, _plain, _launch)


def cmux_epilogue_counted(name: str, P: torch.Tensor, acc: torch.Tensor, amt: torch.Tensor, Q: int,
                          plain, launch) -> torch.Tensor:
    """#10 under the caller's counts, as ``window_matmul_counted``
    (fhe/negacyclic.py's #6 is this function)."""
    B, N = acc.shape[0], acc.shape[-1]
    if not (P.dtype == acc.dtype == amt.dtype == torch.int32):
        raise TypeError(f"{name}: want int32 P, acc and amt")
    if P.shape != (B, 2, 2, N) or acc.shape != (B, 2, N) or amt.shape != (B, 2) or N % TILE:
        raise ValueError(f"{name}: bad shapes P {tuple(P.shape)}, acc {tuple(acc.shape)}, "
                         f"amt {tuple(amt.shape)}")
    if not _on_card(name, P, acc, amt):
        return plain(cmux_epilogue_true_plain, P, acc, amt, Q)
    out = torch.empty_like(acc)
    if B == 0:
        return out
    lib = _build.load()
    rc = lib.oece_cmux_epilogue_true(
        P.data_ptr(), acc.data_ptr(), amt.data_ptr(), out.data_ptr(), B, N, Q, _stream(out)
    )
    launch(name, rc, lib)
    return out


def step_scratch(B: int, N: int, d_used: int, NB: int, device):
    """The step loop's scratch for gate tile NB (fhe/std.py's too): the
    digits (rot.py's ``digit_scratch``) and the products, P int32 [B, 4, N]
    for the tiled GEMM or the split GEMM's two sums [2, B, 4, N]."""
    dig = digit_scratch(B, N // TILE * 2 * d_used * TILE, NB, device)
    prod = torch.empty((2, B, 4, N) if NB <= 16 else (B, 4, N), dtype=torch.int32, device=device)
    return dig, prod


def _check(acc, rev_all, a2N, p: BinFHEParams) -> None:
    """rev_all is [n, rows, 16T] on the CPU, K-major [n, 16, T, rows] on
    the card, where a row-major key is refused."""
    check_operands("blind_rotate_rev", acc, rev_all, a2N)
    B, _, N = acc.shape
    R, kmajor = 2 * p.d_g_used, acc.is_cuda
    n = rev_all.shape[0]
    want = keys.rev_shape(n, R, N, kmajor)
    if kmajor and rev_all.ndim == 3 and rev_all.shape[-1] == 16 * TILE:
        raise ValueError(
            f"blind_rotate_rev: a row-major rev key on the card: the kernel reads it K-major, "
            f"{want}; convert it once (keys.rev_to, BootKeys.to('cuda'))"
        )
    if N != p.N or tuple(rev_all.shape) != want or a2N.shape != (B, n):
        raise ValueError(
            f"blind_rotate_rev: bad shapes acc {tuple(acc.shape)}, rev "
            f"{tuple(rev_all.shape)}, a2N {tuple(a2N.shape)} for {p.name} (N={p.N}, R={R})"
        )


def _blind_rotate_rev_cuda(acc, rev_all, a2N, p: BinFHEParams, NB: int) -> torch.Tensor:
    global STEP_LAUNCHES
    B, _, N = acc.shape
    n = rev_all.shape[0]
    out = acc.clone()
    if B == 0 or n == 0:
        return out
    lib = _build.load()
    dig, prod = step_scratch(B, N, p.d_g_used, NB, acc.device)
    rc = lib.oece_blind_rotate_rev(
        out.data_ptr(), prod.data_ptr(), dig.data_ptr(), rev_all.data_ptr(), a2N.data_ptr(),
        B, NB, dig.shape[0], n, N, p.d_g_used, int(math.log2(p.B_g)), p.g_shift, p.Q, _stream(out),
    )
    _rev_launch("blind_rotate_rev", rc, lib)
    STEP_LAUNCHES += n
    return out


def blind_rotate_rev(
    acc: torch.Tensor, rev_all: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """The whole rotation: acc int32 [B, 2, N], the rev key of n steps,
    a2N int32 [B, n] in [0, 2N).  CPU tensors run the plain version on the
    row-major key; CUDA tensors launch csrc/rev_step.cu's step loop on the
    K-major key (or raise); any other device raises.  Under a traced Clock
    it counts its step GEMM (rot.py's ``count_gemm``), on either device."""
    _check(acc, rev_all, a2N, p)
    B, R = acc.shape[0], 2 * p.d_g_used
    NB = gemm_config(B, p.N, R, 4)[0]
    count_gemm(B, NB, p.N, R * TILE, 4, rev_all.shape[0])
    if acc.device.type == "cpu":
        return blind_rotate_rev_plain(acc, rev_all, a2N, p)
    if acc.device.type != "cuda":
        raise ValueError(f"blind_rotate_rev: no kernel for device {acc.device}")
    return _blind_rotate_rev_cuda(acc, rev_all, a2N, p, NB)
