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

The plain twins: ``build_diagonals_plain`` (#1, row-major, the CPU's
block), ``build_diagonals_kmajor_plain`` (#1 K-major, the card's block),
``diag_matmul_combine_plain`` (#4) and ``cmux_epilogue_plain`` (the jnp
epilogue), composed by ``blind_rotate_std_plain``.  After the build, a
step is the step of fhe/rev.py on a block prebuilt at keygen
(``rev.rev_step_plain``), so on the card the rotation is rev's step loop
(csrc/rev_step.cu) with a ring of two blocks as its key source: per step
``std_build_kernel`` writes step i's block K-major into slot i & 1, then
rev's digits kernel (with the previous step's CMUX) and its GEMM read it
(the gate tile from rot.py's ``gemm_config``, as rev's).  ``build_span`` repeats the build kernel's staging
for the CPU layout tests.  The ginx_ext key stays compact (131 KB per
step); a prebuilt block per step is ``OECE_LAYOUT=rev``.

``blind_rotate_std_tp`` is the rotation under tensor parallelism
(parallel/mesh.py, the JAX package's ``_external_cmux_ginx`` with a
``tp_axis``): each rank holds R/tp rows of every step key, takes the
digits of its rows, sums its rows' raw limb products with the other
ranks' (``all_reduce``), then combines the limbs mod Q and applies the
CMUX.  Per step it calls fhe/negacyclic.py's wrappers: #5
(``negacyclic_matmul``, the raw limb sums gathered from the rank's
compact key rows with no block built) and #6 (``cmux_epilogue``, #10's
kernel), with the digits and the combine as torch ops, as the JAX
package computes them outside Pallas.  #5 rather than #1 then #3: per
rank at two key rows it took 15.7-16.3 µs against 20.5-21.0 at 8 and 64
gates (chip_smoke.py tp; NVIDIA H100 80GB HBM3, 700.00 W).  CPU tensors
run the wrappers' plain twins, CUDA tensors their kernels, on any
process group whose backend reduces CUDA tensors (NCCL, one rank per
card; gloo, which stages them through the host, also several ranks on
one card).  The fused step loop cannot take its place: its digits kernel adds the
accumulator, which would then be added tp times.

``blind_rotate_std`` and ``build_diagonals_kmajor`` run the plain version
for CPU tensors and launch their kernels for CUDA tensors, or raise.
``LAUNCHES`` / ``PLAIN_LAUNCHES`` count the wrapper calls that reached
each version; ``STEP_LAUNCHES`` the steps of the CUDA step loop (per step
one build, one digits kernel and one GEMM; per rotation one more digits
launch for the last CMUX).
"""

from __future__ import annotations

import math

import torch

from . import _build, negacyclic, rev
from .keys import TILE, rev_block, rev_block_kmajor, rev_index
from .params import BinFHEParams
from .rev import cmux_epilogue_true_plain, rev_step_plain
from .rot import (amount_pairs, check_operands, combine_planes, count_gemm, gemm_config,
                  tile_digits, tile_products)

LAUNCHES = 0  # wrapper calls that launched CUDA kernels
PLAIN_LAUNCHES = 0  # wrapper calls that ran the plain version
STEP_LAUNCHES = 0  # steps of the CUDA step loop: one launch of each of its kernels


def build_diagonals_plain(ext_i: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """#1: one step's ginx_ext int8 [R, 16, 2N] -> reversed diagonal blocks
    int8 [(2nt-1)*R*T, 16T] in true column order (idx = keys.rev_index)."""
    return rev_block(ext_i, idx)


def build_diagonals_kmajor_plain(ext_i: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """#1 K-major: one step's ginx_ext int8 [R, 16, 2N] -> int8 [16, T,
    (2nt-1)*R*T], entry [m, t, d'*RT + r*T + u] = ext_i[r, m, ((nt-1-d')*T
    + t - u) mod 2N]: ``build_diagonals_plain`` transposed, the layout of
    ``keys.rev_step(..., kmajor=True)``."""
    return rev_block_kmajor(ext_i, idx)


def build_span(ext_i: torch.Tensor, m: int, r: int, dp: int) -> torch.Tensor:
    """The 256 bytes that ``std_build_kernel``'s block (m, r, d') stages, as
    it stages them: group g of 16 is row group 2N/16 - 1 - h of ext_i[r, m]
    with its bytes reversed, h = ((2N - (nt-d')*T) / 16 + g) mod 2N/16.
    The block writes entry [m, t, d'*RT + r*T + u] = span[127 - t + u]."""
    N = ext_i.shape[-1] // 2
    nt, groups = N // TILE, 2 * N // 16
    row = ext_i[r, m].view(groups, 16)
    h = ((2 * N - (nt - dp) * TILE) // 16 + torch.arange(16)) % groups
    return row[groups - 1 - h].flip(-1).reshape(256)


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


def blind_rotate_std_tp(
    acc: torch.Tensor, ginx_ext: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams, tp
) -> torch.Tensor:
    """All n steps with this rank's key rows: ginx_ext int8 [n, R/tp, 16,
    2N] holds rows [t*R/tp, (t+1)*R/tp) (t = tp.tp_rank); the raw limb sums
    of those rows (#5) are summed over tp.tp_group before the combine mod
    Q and the CMUX (#6), so every rank returns the whole rotation's result.
    CPU tensors run the wrappers' plain twins, CUDA tensors their kernels;
    any other device raises."""
    import torch.distributed as dist

    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blind_rotate_std_tp: no kernel for device {acc.device}")
    B, _, N = acc.shape
    R, r = 2 * p.d_g_used, ginx_ext.shape[1]
    if r * tp.tp != R:
        raise ValueError(f"blind_rotate_std_tp: {r} key rows on each of {tp.tp} ranks, want {R} in all")
    r0 = tp.tp_rank * r
    nt = N // TILE
    for i in range(ginx_ext.shape[0]):
        dig = tile_digits(acc, p).view(B, nt, R, TILE)[:, :, r0:r0 + r].contiguous().view(B, -1)
        raw = negacyclic.negacyclic_matmul(dig, ginx_ext[i])
        dist.all_reduce(raw, group=tp.tp_group)
        P = combine_planes(raw, p.Q).reshape(B, 2, 2, N).contiguous()
        acc = negacyclic.cmux_epilogue(P, acc, amount_pairs(a2N[:, i], N), p.Q)
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


def _blind_rotate_std_cuda(acc, ginx_ext, a2N, p: BinFHEParams, NB: int) -> torch.Tensor:
    """rev's step loop (csrc/rev_step.cu) on a ring of two K-major blocks
    [2, 16, T, (2nt-1)*RT] that the build fills from ginx_ext per step; the
    digits and the products (P, or the split GEMM's two sums) as rev's."""
    global LAUNCHES, STEP_LAUNCHES
    B, _, N = acc.shape
    n = ginx_ext.shape[0]
    out = acc.clone()
    if B == 0 or n == 0:
        return out
    rev._aligned("blind_rotate_std", ginx_ext)
    lib = _build.load()
    nt, RT = N // TILE, 2 * p.d_g_used * TILE
    dig, prod = rev.step_scratch(B, N, p.d_g_used, NB, acc.device)
    ring = torch.empty((2, 16, TILE, (2 * nt - 1) * RT), dtype=torch.int8, device=acc.device)
    rc = lib.oece_blind_rotate_std(
        out.data_ptr(), prod.data_ptr(), dig.data_ptr(), ring.data_ptr(), ginx_ext.data_ptr(),
        a2N.data_ptr(), B, NB, dig.shape[0], n, N, p.d_g_used, int(math.log2(p.B_g)), p.g_shift,
        p.Q, rev._stream(out),
    )
    if rc != 0:
        raise RuntimeError(f"rev_step.cu launch failed: {lib.oece_error_string(rc).decode()}")
    LAUNCHES += 1
    STEP_LAUNCHES += n
    return out


def build_diagonals_kmajor(ext_i: torch.Tensor) -> torch.Tensor:
    """#1 K-major alone: one step's ginx_ext int8 [R, 16, 2N] -> int8 [16,
    T, (2nt-1)*R*T].  CPU tensors run the plain twin; CUDA tensors launch
    the step loop's build kernel (csrc/rev_step.cu: std_build_kernel), or
    raise."""
    global LAUNCHES, PLAIN_LAUNCHES
    name = "build_diagonals_kmajor"
    if ext_i.dtype != torch.int8 or ext_i.ndim != 3 or ext_i.shape[1] != 16:
        raise ValueError(f"{name}: want int8 ginx_ext [R, 16, 2N], got {ext_i.dtype} {tuple(ext_i.shape)}")
    R, _, two_n = ext_i.shape
    N = two_n // 2
    if N % TILE or N & (N - 1) or R == 0:
        raise ValueError(f"{name}: needs N a power of two and a multiple of {TILE}, R > 0")
    if not rev._on_card(name, ext_i):
        PLAIN_LAUNCHES += 1
        return build_diagonals_kmajor_plain(ext_i, rev_index(N, ext_i.device))
    rev._aligned(name, ext_i)
    out = torch.empty((16, TILE, (2 * N // TILE - 1) * R * TILE), dtype=torch.int8, device=ext_i.device)
    lib = _build.load()
    rc = lib.oece_std_build(ext_i.data_ptr(), out.data_ptr(), N, R, rev._stream(out))
    if rc != 0:
        raise RuntimeError(f"{name}: rev_step.cu launch failed: {lib.oece_error_string(rc).decode()}")
    LAUNCHES += 1
    return out


def blind_rotate_std(
    acc: torch.Tensor, ginx_ext: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """The whole rotation.  CPU tensors run the plain version; CUDA tensors
    launch the kernels (or raise); any other device raises.  Under a traced
    Clock it counts its step GEMM (rot.py's ``count_gemm``), whose GEMMs
    wait for the ring's build before they load: no key bytes ahead of the
    step chain."""
    _check(acc, ginx_ext, a2N, p)
    B, R = acc.shape[0], 2 * p.d_g_used
    NB = gemm_config(B, p.N, R, 4)[0]
    count_gemm(B, NB, p.N, R * TILE, 4, 0)
    if acc.device.type == "cpu":
        return blind_rotate_std_plain(acc, ginx_ext, a2N, p)
    if acc.device.type != "cuda":
        raise ValueError(f"blind_rotate_std: no kernel for device {acc.device}")
    return _blind_rotate_std_cuda(acc, ginx_ext, a2N, p, NB)
