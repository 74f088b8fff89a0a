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
