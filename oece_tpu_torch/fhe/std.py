"""The GINX blind rotation in the standard (non-rotated) form.

Counterpart of ``oece_tpu.fhe.boot._external_cmux_pallas`` scanned over the
n key steps (the ``ginx_pallas`` key layout that ``pack_bootstrap_key``
gives host-generated keys), with ``pallas_kernels.negacyclic_matmul_combine``
inside it: Pallas kernel #1 ``build_diagonals_pallas`` and #4
``diag_matmul_combine_pallas``.  For each step i and gate b, with
a = a2N[b, i]:

    P = [P0, P1] = dec(acc) ⊡ diagonals(ginx_ext[i])     [B, part, out, N]
    acc <- red31(acc + X^{2N-a} P0 + X^a P1 + 2Q - P0 - P1)

where ⊡ contracts the gadget digits against the step's reversed diagonal
blocks, one 128-coefficient output tile at a time, followed by the Horner
combine of the 4 key limbs mod Q.  golden.blind_rotate_ginx is the same
function (it skips a = 0 steps; the step is an identity there).

The plain twins, one per kernel of ``csrc/std_step.cu``:
``build_diagonals_plain`` (#1), ``diag_matmul_combine_plain`` (#4) and
``cmux_epilogue_plain`` (the jnp epilogue), composed by
``blind_rotate_std_plain``.  After the build, a step is the step of
fhe/rev.py on a block prebuilt at keygen (``rev.rev_step_plain``).  The dispatcher ``blind_rotate_std`` runs the
plain version for CPU tensors and launches the CUDA step loop for CUDA
tensors, or raises.  ``LAUNCHES`` / ``PLAIN_LAUNCHES`` count the rotation
calls that reached each version; ``STEP_LAUNCHES`` counts the launches of
each kernel of the loop (one build, digits, matmul and epilogue per step).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .keys import TILE, rev_block, rev_index
from .params import BinFHEParams
from .rev import cmux_epilogue_true_plain, rev_step_plain
from .rot import amount_pairs, check_operands, tile_products

LAUNCHES = 0  # blind_rotate_std calls that launched the CUDA step loop
PLAIN_LAUNCHES = 0  # blind_rotate_std calls that ran the plain version
STEP_LAUNCHES = 0  # launches of each kernel of the CUDA step loop


def build_diagonals_plain(ext_i: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """#1: one step's ginx_ext int8 [R, 16, 2N] -> reversed diagonal blocks
    int8 [(2nt-1)*R*T, 16T] in true column order (idx = keys.rev_index)."""
    return rev_block(ext_i, idx)


def diag_matmul_combine_plain(dig: torch.Tensor, block: torch.Tensor, Q: int) -> torch.Tensor:
    """#4: digits int8 [B, nt*R*T] against one step's block -> P4 int32
    [B, 4, N] mod Q, plane part*2 + out."""
    return tile_products(dig, block, Q)


def cmux_epilogue_plain(
    acc: torch.Tensor, P4: torch.Tensor, a_col: torch.Tensor, Q: int
) -> torch.Tensor:
    """red31(acc + X^{2N-a} P0 + X^a P1 + 2Q - P0 - P1) (boot.py:358-363)."""
    B, _, N = acc.shape
    return cmux_epilogue_true_plain(P4.reshape(B, 2, 2, N), acc, amount_pairs(a_col, N), Q)


def std_step_plain(
    acc: torch.Tensor, a_col: torch.Tensor, ext_i: torch.Tensor, idx: torch.Tensor,
    p: BinFHEParams,
) -> torch.Tensor:
    return rev_step_plain(acc, a_col, build_diagonals_plain(ext_i, idx), p)


def blind_rotate_std_plain(
    acc: torch.Tensor, ginx_ext: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """All n steps with torch ops: acc int32 [B, 2, N], ginx_ext int8
    [n, R, 16, 2N], a2N int32 [B, n] in [0, 2N)."""
    global PLAIN_LAUNCHES
    PLAIN_LAUNCHES += 1
    idx = rev_index(acc.shape[-1], acc.device)
    for i in range(ginx_ext.shape[0]):
        acc = std_step_plain(acc, a2N[:, i], ginx_ext[i], idx, p)
    return acc


def _check(acc, ginx_ext, a2N, p: BinFHEParams) -> None:
    check_operands("blind_rotate_std", acc, ginx_ext, a2N)
    B, _, N = acc.shape
    R = 2 * p.d_g_used
    n = ginx_ext.shape[0]
    if N != p.N or ginx_ext.shape[1:] != (R, 16, 2 * N) or a2N.shape != (B, n):
        raise ValueError(
            f"blind_rotate_std: bad shapes acc {tuple(acc.shape)}, ginx_ext "
            f"{tuple(ginx_ext.shape)}, a2N {tuple(a2N.shape)} for {p.name} (N={p.N}, R={R})"
        )


def _blind_rotate_std_cuda(acc, ginx_ext, a2N, p: BinFHEParams) -> torch.Tensor:
    global LAUNCHES, STEP_LAUNCHES
    B, _, N = acc.shape
    n = ginx_ext.shape[0]
    out = acc.clone()
    if B == 0 or n == 0:
        return out
    lib = _build.load()
    nt = N // TILE
    RT = 2 * p.d_g_used * TILE
    dig = torch.empty((B, nt * RT), dtype=torch.int8, device=acc.device)
    block = torch.empty(((2 * nt - 1) * RT, 16 * TILE), dtype=torch.int8, device=acc.device)
    P4 = torch.empty((B, 4, N), dtype=torch.int32, device=acc.device)
    rc = lib.oece_blind_rotate_std(
        out.data_ptr(), dig.data_ptr(), block.data_ptr(), P4.data_ptr(),
        ginx_ext.data_ptr(), a2N.data_ptr(), B, n, N, p.d_g_used,
        int(math.log2(p.B_g)), p.g_shift, p.Q,
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"std_step.cu launch failed: {lib.oece_error_string(rc).decode()}")
    LAUNCHES += 1
    STEP_LAUNCHES += n
    return out


def blind_rotate_std(
    acc: torch.Tensor, ginx_ext: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """The whole rotation.  CPU tensors run the plain version; CUDA tensors
    launch the kernels (or raise); any other device raises."""
    _check(acc, ginx_ext, a2N, p)
    if acc.device.type == "cpu":
        return blind_rotate_std_plain(acc, ginx_ext, a2N, p)
    if acc.device.type != "cuda":
        raise ValueError(f"blind_rotate_std: no kernel for device {acc.device}")
    return _blind_rotate_std_cuda(acc, ginx_ext, a2N, p)
