"""Negacyclic NTT over Z_Q[X]/(X^N+1), Q = 2**27 - 2**11 + 1: the port's
own copy of the JAX package's NumPy reference (oece_tpu.fhe.ntt), the
definition that fhe/ntt_dev.py is held to.

The reference's polynomial arithmetic lives inside OpenFHE (SURVEY.md §2.8,
"negacyclic ring arithmetic ... the inner hot kernel").  The port's
bootstrap (fhe/boot.py) avoids the NTT: the negacyclic product is an int8
tensor-core GEMM.  The NTT is provided as the O(N log N) reference
transform (tests, and the "speed-of-light" comparison of fhe/ntt_dev.py).

Q - 1 = 2**11 * (2**16 - 1), so the maximal power-of-two NTT size is 2048 =
2N for N = 1024: exactly what FHEW needs, with psi a primitive 2N-th root of
unity.  Negacyclic convolution: NTT_psi(a) ∘ NTT_psi(b) -> INTT, with the
psi-powers folded into the twiddle tables (standard Longa-Naehrig layout).

The host reference multiplies in int64 (every product < 2**54).
"""

from __future__ import annotations

import functools

import numpy as np

from .params import Q27


def _pow_mod(b: int, e: int, m: int) -> int:
    return pow(b, e, m)


@functools.lru_cache(maxsize=None)
def find_psi(N: int, Q: int = Q27) -> int:
    """Primitive 2N-th root of unity mod Q (host, exact)."""
    assert (Q - 1) % (2 * N) == 0
    # find a generator by trial: Q is prime, group order Q-1 = 2^11 * 65535
    # 65535 = 3 * 5 * 17 * 257
    factors = [2, 3, 5, 17, 257]
    for g in range(2, 1000):
        if all(_pow_mod(g, (Q - 1) // f, Q) != 1 for f in factors):
            psi = _pow_mod(g, (Q - 1) // (2 * N), Q)
            assert _pow_mod(psi, N, Q) == Q - 1  # psi^N = -1
            return psi
    raise RuntimeError("no generator found")


@functools.lru_cache(maxsize=None)
def _tables(N: int, Q: int = Q27):
    """Per-stage twiddle tables in bit-reversed (CT, DIT/DIF) order.

    Returns (fwd_tw, inv_tw, n_inv) as numpy int64 arrays; fwd_tw[s] has
    N//2 entries used by stage s of the forward DIF transform.
    """
    psi = find_psi(N, Q)
    psi_inv = _pow_mod(psi, 2 * N - 1, Q)
    # standard psi-powers in bit-reversed order
    logN = int(np.log2(N))
    br = np.zeros(N, dtype=np.int64)
    for i in range(N):
        br[i] = int(format(i, f"0{logN}b")[::-1], 2)
    psis = np.array([_pow_mod(psi, int(b), Q) for b in br], dtype=np.int64)
    ipsis = np.array([_pow_mod(psi_inv, int(b), Q) for b in br], dtype=np.int64)
    n_inv = _pow_mod(N, Q - 2, Q)
    return psis, ipsis, n_inv


def _mulmod_const_np(x: np.ndarray, w: np.ndarray, Q: int = Q27) -> np.ndarray:
    """Exact (x * w) mod Q in int64 (host reference)."""
    return (x.astype(np.int64) * w) % Q


def ntt_forward(a: np.ndarray, Q: int = Q27) -> np.ndarray:
    """Forward negacyclic NTT (CT butterflies, psi folded), batch on axis 0.

    Host/NumPy exact reference; output in bit-reversed order.
    """
    a = np.asarray(a, dtype=np.int64) % Q
    N = a.shape[-1]
    psis, _, _ = _tables(N, Q)
    t = N
    m = 1
    a = a.copy()
    while m < N:
        t //= 2
        a = a.reshape(a.shape[:-1] + (m, 2, t))
        w = psis[m : 2 * m].reshape((m, 1))  # [m, 1]
        u = a[..., 0, :]
        v = _mulmod_const_np(a[..., 1, :], w, Q)
        a = np.concatenate([(u + v) % Q, (u - v) % Q], axis=-1)
        a = a.reshape(a.shape[:-2] + (m * 2, t)).reshape(a.shape[:-2] + (-1,))
        m *= 2
    return a.reshape(a.shape[:-1] + (N,)) if a.shape[-1] != N else a


def ntt_inverse(a: np.ndarray, Q: int = Q27) -> np.ndarray:
    """Inverse negacyclic NTT (GS butterflies), exact host reference."""
    a = np.asarray(a, dtype=np.int64) % Q
    N = a.shape[-1]
    _, ipsis, n_inv = _tables(N, Q)
    t = 1
    m = N
    a = a.copy()
    while m > 1:
        h = m // 2
        a = a.reshape(a.shape[:-1] + (h, 2, t))
        w = ipsis[h : 2 * h].reshape((h, 1))
        u = a[..., 0, :]
        v = a[..., 1, :]
        s = (u + v) % Q
        d = _mulmod_const_np((u - v) % Q, w, Q)
        a = np.stack([s, d], axis=-2)
        a = a.reshape(a.shape[:-3] + (h * 2 * t,))
        m = h
        t *= 2
    return _mulmod_const_np(a, np.int64(n_inv), Q)


def negacyclic_mul_ntt(a: np.ndarray, b: np.ndarray, Q: int = Q27) -> np.ndarray:
    """a ⊛ b via NTT — must equal golden.negacyclic_mul exactly."""
    fa = ntt_forward(a, Q)
    fb = ntt_forward(b, Q)
    return ntt_inverse((fa * fb) % Q, Q)
