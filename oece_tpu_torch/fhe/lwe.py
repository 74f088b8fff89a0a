"""LWE operations (counterpart of oece_tpu.fhe.lwe): host encryption and
decryption in NumPy, where the randomness lives (copies of the JAX
package's ``encrypt_bits`` / ``decrypt_bits``, drawing the same numbers
from the same generator), and the device ops on torch tensors.

Ciphertexts are int32 [..., n+1] = (a_0..a_{n-1}, b) mod q with the q/4
bit encoding.  The inner products <a, s> are multiply-and-sum (torch has no
integer matmul on CUDA): |sum| <= n*q, far inside int64.
"""

from __future__ import annotations

import numpy as np
import torch

from .golden import LWESecretKey, gauss


def encrypt_bits(sk: LWESecretKey, bits: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Encrypt a batch of bits -> int32 [B, n+1] mod q (host, vectorized)."""
    p = sk.params
    bits = np.asarray(bits, dtype=np.int64).reshape(-1)
    B = bits.shape[0]
    a = rng.integers(0, p.q, (B, p.n), dtype=np.int64)
    e = gauss(rng, p.sigma, (B,))
    b = (a @ sk.s + e + bits * (p.q // 4)) % p.q
    return np.concatenate([a, b[:, None]], axis=1).astype(np.int32)


def decrypt_bits(sk: LWESecretKey, cts: np.ndarray) -> np.ndarray:
    """Decrypt a batch of ciphertexts -> bits [B] (host, vectorized)."""
    p = sk.params
    cts = np.asarray(cts, dtype=np.int64)
    phase = (cts[..., -1] - cts[..., :-1] @ sk.s) % p.q
    return (((phase + p.q // 8) // (p.q // 4)) % 4 & 1).astype(np.int32)


def eval_not_batch(cts: torch.Tensor, q: int) -> torch.Tensor:
    """EvalNOT, batched: (-a, q/4 - b) mod q."""
    out = (q - cts) & (q - 1)
    out[..., -1] = (out[..., -1] + q // 4) & (q - 1)
    return out


def phase_dev(s: torch.Tensor, cts: torch.Tensor, q: int) -> torch.Tensor:
    """The phase b - <a, s> mod q of cts int32 [..., n+1], int64 [...]."""
    dot = (cts[..., :-1].to(torch.int64) * s.to(torch.int64)).sum(-1)
    return (cts[..., -1].to(torch.int64) - dot) % q


def encrypt_bits_dev(s: torch.Tensor, m: torch.Tensor, gen: torch.Generator, params) -> torch.Tensor:
    """Encrypt on the device of ``s`` with ``gen``: m [B] in 0..3 (a bit,
    or the quarter of a gate's prep phase) -> int32 [B, n+1] mod q, with a
    uniform, e the params' rounded Gaussian and b = <a, s> + e + m*q/4.
    The distributions of encrypt_bits and of the JAX package's device
    encryption; the values differ (another generator)."""
    p = params
    m = m.reshape(-1).to(torch.int64)
    B = m.shape[0]
    a = torch.randint(0, p.q, (B, p.n), generator=gen, device=s.device, dtype=torch.int64)
    e = torch.round(p.sigma * torch.randn(B, generator=gen, device=s.device)).to(torch.int64)
    b = ((a * s.to(torch.int64)).sum(-1) + e + m * (p.q // 4)) % p.q
    return torch.cat([a, b[:, None]], dim=1).to(torch.int32)


def decrypt_bits_dev(s: torch.Tensor, cts: torch.Tensor, q: int) -> torch.Tensor:
    """cts int32 [..., n+1] -> bits int32 [...]."""
    phase = phase_dev(s, cts, q)
    return ((((phase + q // 8) // (q // 4)) % 4) & 1).to(torch.int32)


def phase_margin_dev(s: torch.Tensor, cts: torch.Tensor, q: int):
    """Nearest valid decode and centred phase error: (bit, err), int32."""
    phase = phase_dev(s, cts, q)
    bit = (((phase - q // 8) % q) < (q // 2)).to(torch.int64)
    err = (phase - bit * (q // 4) + q // 2) % q - q // 2
    return bit.to(torch.int32), err.to(torch.int32)
