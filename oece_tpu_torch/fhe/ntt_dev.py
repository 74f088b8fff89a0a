"""Batched negacyclic NTT over Z_Q[X]/(X^N+1) on torch tensors (counterpart
of oece_tpu.fhe.ntt_dev): forward and inverse transforms bit-identical to
the host reference fhe/ntt.py, on any device.

It is the "speed of light" yardstick of the dense-matmul design: the
port's bootstrap computes each negacyclic product as an int8 tensor-core
GEMM against reversed key diagonals, while an NTT does log2(N) stages of
N/2 modular butterflies.  chip_smoke's ``ntt`` phase times these
transforms, and one step's product in NTT form (``step_product_ntt``),
against the GEMM kernels.

The JAX version splits both operands of each modular multiply at 2**14
so every product fits int32 (the TPU has no 64-bit multiply-high).  Here
the butterflies run in int64: a product of two residues is below 2**54.
"""

from __future__ import annotations

import functools

import torch

from . import ntt as ntt_host
from .params import Q27


@functools.lru_cache(maxsize=None)
def _tables_dev(N: int, Q: int, device: str):
    psis, ipsis, n_inv = ntt_host._tables(N, Q)
    as_t = lambda t: torch.as_tensor(t, dtype=torch.int64, device=device)  # noqa: E731
    return as_t(psis), as_t(ipsis), int(n_inv)


def _tables(N: int, Q: int, device: torch.device):
    return _tables_dev(N, Q, str(device))


def ntt_forward_dev(a: torch.Tensor, Q: int = Q27) -> torch.Tensor:
    """Forward negacyclic NTT (CT butterflies, psi folded), batch on axis 0:
    [B, N] integers in [0, Q) -> int64 [B, N] in bit-reversed order;
    ntt.ntt_forward bit for bit."""
    B, N = a.shape
    psis, _, _ = _tables(N, Q, a.device)
    x = a.to(torch.int64)
    m, t = 1, N
    while m < N:
        t //= 2
        x = x.view(B, m, 2, t)
        w = psis[m:2 * m].view(1, m, 1)
        u, v = x[:, :, 0], x[:, :, 1] * w % Q
        x = torch.cat([(u + v) % Q, (u - v) % Q], dim=-1).view(B, N)
        m *= 2
    return x


def ntt_inverse_dev(a: torch.Tensor, Q: int = Q27) -> torch.Tensor:
    """Inverse negacyclic NTT (GS butterflies): ntt.ntt_inverse bit for bit,
    int64 [B, N] in [0, Q)."""
    B, N = a.shape
    _, ipsis, n_inv = _tables(N, Q, a.device)
    x = a.to(torch.int64)
    m, t = N, 1
    while m > 1:
        h = m // 2
        x = x.view(B, h, 2, t)
        w = ipsis[h:2 * h].view(1, h, 1)
        u, v = x[:, :, 0], x[:, :, 1]
        x = torch.stack([(u + v) % Q, (u - v) % Q * w % Q], dim=-2).view(B, N)
        m = h
        t *= 2
    return x * n_inv % Q


def negacyclic_mul_ntt_dev(a: torch.Tensor, b: torch.Tensor, Q: int = Q27) -> torch.Tensor:
    """a ⊛ b [B, N] via the NTT: golden.negacyclic_mul exactly."""
    return ntt_inverse_dev(ntt_forward_dev(a, Q) * ntt_forward_dev(b, Q) % Q, Q)


def step_product_ntt(dig: torch.Tensor, key_ntt: torch.Tensor, Q: int = Q27) -> torch.Tensor:
    """One GINX step's product in NTT form: digit polynomials int8 [B, R, N]
    (the gadget digits of a gate's accumulator) against a step key already
    in the NTT domain, int64 [R, M, N] -> int64 [B, M, N] = sum_r dig[:, r]
    ⊛ key[r] mod Q: B*R forward and B*M inverse transforms around a
    pointwise multiply-accumulate.  The dense design computes the same
    product (before its mod-Q combine) as one int8 GEMM."""
    B, R, N = dig.shape
    M = key_ntt.shape[1]
    f = ntt_forward_dev(dig.to(torch.int64).reshape(B * R, N) % Q, Q).view(B, R, 1, N)
    acc = (f * key_ntt[None] % Q).sum(1) % Q  # R products < 2**27 each: the sum fits int64
    return ntt_inverse_dev(acc.view(B * M, N), Q).view(B, M, N)
