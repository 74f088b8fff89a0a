"""LWE operations on torch tensors (counterpart of oece_tpu.fhe.lwe's device
ops).  Host encryption and decryption are oece_tpu.fhe.lwe's own
``encrypt_bits`` / ``decrypt_bits``, reused unchanged (NumPy, no JAX).

Ciphertexts are int32 [..., n+1] = (a_0..a_{n-1}, b) mod q with the q/4
bit encoding.  The inner products <a, s> are multiply-and-sum (torch has no
integer matmul on CUDA): |sum| <= n*q, far inside int64.
"""

from __future__ import annotations

import torch

from oece_tpu.fhe.lwe import decrypt_bits, encrypt_bits  # noqa: F401  (re-export)


def eval_not_batch(cts: torch.Tensor, q: int) -> torch.Tensor:
    """EvalNOT, batched: (-a, q/4 - b) mod q."""
    out = (q - cts) & (q - 1)
    out[..., -1] = (out[..., -1] + q // 4) & (q - 1)
    return out


def _phase(s: torch.Tensor, cts: torch.Tensor, q: int) -> torch.Tensor:
    dot = (cts[..., :-1].to(torch.int64) * s.to(torch.int64)).sum(-1)
    return (cts[..., -1].to(torch.int64) - dot) % q


def decrypt_bits_dev(s: torch.Tensor, cts: torch.Tensor, q: int) -> torch.Tensor:
    """cts int32 [..., n+1] -> bits int32 [...]."""
    phase = _phase(s, cts, q)
    return ((((phase + q // 8) // (q // 4)) % 4) & 1).to(torch.int32)


def phase_margin_dev(s: torch.Tensor, cts: torch.Tensor, q: int):
    """Nearest valid decode and centred phase error: (bit, err), int32."""
    phase = _phase(s, cts, q)
    bit = (((phase - q // 8) % q) < (q // 2)).to(torch.int64)
    err = (phase - bit * (q // 4) + q // 2) % q - q // 2
    return bit.to(torch.int32), err.to(torch.int32)
