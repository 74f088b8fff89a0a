"""The binary-base AP blind rotation (B_r = 2).

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
hand-written kernel of ``csrc/ap_step.cu`` or raise.  ``LAUNCHES`` and
``PLAIN_LAUNCHES`` count the calls that reached each version.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .keys import TILE, rev_block, rev_index
from .params import BinFHEParams
from .rot import check_operands, tile_digits, tile_products

LAUNCHES = 0  # calls that launched the CUDA kernel (one per rotation)
PLAIN_LAUNCHES = 0  # calls that ran the plain torch version
STEP_LAUNCHES = 0  # launches of each kernel of the CUDA step loop (one per step)


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
    idx = rev_index(acc.shape[-1], acc.device)
    for s in range(ap_ext.shape[0]):
        acc = ap_step_plain(acc, bits[:, s], ap_ext[s], idx, p)
    return acc


def _check(acc, ap_ext, a2N, p: BinFHEParams) -> None:
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
    global LAUNCHES, STEP_LAUNCHES
    B, _, N = acc.shape
    steps = ap_ext.shape[0]
    if B == 0 or steps == 0:
        return acc.clone()
    lib = _build.load()
    nt = N // TILE
    RT = 2 * p.d_g_used * TILE
    bufs = (acc.clone(), torch.empty_like(acc))
    dig = torch.empty((B, nt * RT), dtype=torch.int8, device=acc.device)
    rev = torch.empty(((2 * nt - 1) * RT, 8 * TILE), dtype=torch.int8, device=acc.device)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    rc = lib.oece_blind_rotate_ap(
        bufs[0].data_ptr(), bufs[1].data_ptr(), dig.data_ptr(), rev.data_ptr(),
        ap_ext.data_ptr(), a2N.data_ptr(), B, p.n, p.d_r, N, p.d_g_used,
        int(math.log2(p.B_g)), p.g_shift, p.Q, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"ap_step.cu launch failed: {lib.oece_error_string(rc).decode()}"
        )
    LAUNCHES += 1
    STEP_LAUNCHES += steps
    return bufs[steps % 2]


def blind_rotate_ap(
    acc: torch.Tensor, ap_ext: torch.Tensor, a2N: torch.Tensor, p: BinFHEParams
) -> torch.Tensor:
    """The whole rotation.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (or raise); any other device raises."""
    _check(acc, ap_ext, a2N, p)
    if acc.device.type == "cpu":
        return blind_rotate_ap_plain(acc, ap_ext, a2N, p)
    if acc.device.type != "cuda":
        raise ValueError(f"blind_rotate_ap: no kernel for device {acc.device}")
    return _blind_rotate_ap_cuda(acc, ap_ext, a2N, p)
