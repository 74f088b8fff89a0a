"""The NumPy golden model's key records and samplers, as the port needs them.

The port's own copy of the parts of ``oece_tpu.fhe.golden`` that its code
calls, kept in step with it (tests/test_torch_copies.py): the port imports
nothing of the JAX package.  Sampling, the ring secret, the LWE secret
(``lwe_keygen``, ``LWESecretKey``), the ``BootstrapKey`` record that
``keys.pack_bootstrap_key`` packs, and ``make_test_vector``.  Given the
same ``np.random.Generator`` state, each sampler draws the same numbers in
the same order.  The bootstrap keys themselves are made by
``fhe/hostkeygen.py``: golden's draws, with the ring products on the
device, held to ``oece_tpu.fhe.golden.bootstrap_keygen`` by the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .params import BinFHEMethod, BinFHEParams, BinGate

# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def gauss(rng: np.random.Generator, sigma: float, shape) -> np.ndarray:
    """Rounded continuous Gaussian (the standard FHEW noise sampler)."""
    return np.rint(rng.normal(0.0, sigma, shape)).astype(np.int64)


def ternary(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(-1, 2, shape, dtype=np.int64)


def binary(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 2, shape, dtype=np.int64)


def ring_secret(params: BinFHEParams, rng: np.random.Generator) -> np.ndarray:
    """The ring secret z [N]: ternary or binary like the LWE secret."""
    return ternary(rng, (params.N,)) if params.secret == "ternary" else binary(rng, (params.N,))


# ---------------------------------------------------------------------------
# LWE: ciphertexts are length n+1 vectors (a_0..a_{n-1}, b) mod q,
#   b = <a, s> + e + m * q/4.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LWESecretKey:
    s: np.ndarray  # [n] in {-1,0,1} (ternary) or {0,1}
    params: BinFHEParams


def lwe_keygen(params: BinFHEParams, rng: np.random.Generator) -> LWESecretKey:
    sample = ternary if params.secret == "ternary" else binary
    return LWESecretKey(s=sample(rng, (params.n,)), params=params)


# ---------------------------------------------------------------------------
# Bootstrapping keys
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BootstrapKey:
    """Everything BTKeyGen produces.

    brk_pos/brk_neg : GINX refresh keys, RGSW(s+_i)/RGSW(s-_i), [n, 2*d_g, 2, N]
    ak              : AP refresh keys, [n, d_r, B_r, 2*d_g, 2, N]
    ksk             : key-switch key [N, d_ks, n+1] int64 mod Q_ks
    z               : ring secret (kept for tests only)
    """

    brk_pos: np.ndarray | None
    brk_neg: np.ndarray | None
    ak: np.ndarray | None
    ksk: np.ndarray
    z: np.ndarray
    params: BinFHEParams
    method: BinFHEMethod


# ---------------------------------------------------------------------------
# Test vectors
# ---------------------------------------------------------------------------

# Gate windows over the q-phase circle with q/4 bit encoding: window [lo, hi)
# in units of q/8 where the test function is +Q/8 (antiperiodic).
GATE_WINDOW = {
    BinGate.AND: (3, 7),
    BinGate.NAND: (7, 11),
    BinGate.OR: (1, 5),
    BinGate.NOR: (5, 9),
    BinGate.XOR: (2, 6),
    BinGate.XNOR: (6, 10),
}


def make_test_vector(params: BinFHEParams, gate: BinGate) -> np.ndarray:
    """Test polynomial t(X) with t_j = f_ext(-j) on the 2N circle, folded
    negacyclically onto N coefficients; f_ext = +Q/8 inside the gate's
    window, -Q/8 mod Q outside."""
    N, Q, q = params.N, params.Q, params.q
    lo8, hi8 = GATE_WINDOW[gate]
    scale = 2 * N // q  # q <= 2N guaranteed
    lo, hi = lo8 * q // 8 * scale, hi8 * q // 8 * scale
    j = np.arange(2 * N)
    inside = ((j - lo) % (2 * N)) < (hi - lo)
    f_ext = np.where(inside, Q // 8, Q - Q // 8).astype(np.int64)
    idx = (-np.arange(N)) % (2 * N)
    return f_ext[idx] % Q
