"""FHEW/TFHE parameter sets for the TPU-native boolean-circuit evaluator.

Role parity: the reference obtains these from OpenFHE's
``BinFHEContext::GenerateBinFHEContext(set, method)``
(reference: src/circuit.cpp:88, src/utils.cpp:166-185).  The reference only
*selects* ``TOY`` or ``STD128_OPT`` and method ``AP`` or ``GINX``
(src/utils.cpp:166-185, src/circuit.cpp:69-78); the parameter records
themselves live inside OpenFHE.  Here they are first-class, self-contained
records chosen from the FHEW/TFHE literature (Ducas-Micciancio FHEW;
Micciancio-Polyakov "Bootstrapping in FHEW-like Cryptosystems") and sized so
every hot operation maps onto TPU int8 MXU matmuls with exact int32
accumulation:

* ``B_g``  <= 256 so signed gadget digits fit int8,
* ``B_ks`` <= 256 so key-switch digits fit int8,
* ``Q``    < 2**27 so 4 signed base-2**8 limbs cover ring coefficients and
  int32 accumulators never overflow (see fhe/modmath.py),
* ``Q`` is an NTT-friendly prime (Q ≡ 1 mod 2N) so the negacyclic NTT path
  (fhe/ntt.py) shares the same modulus.

Security note: STD128 / STD128_OPT are sized to the standard 128-bit
FHEW/TFHE settings (n≈500, q=1024, N=1024, Q≈2**27, sigma=3.19).  TOY is
deliberately insecure and fast, mirroring the reference's warning
(src/circuit.cpp:70-76, README.md:208-211).

The port's own copy of ``oece_tpu.fhe.params``, kept in step with it
(tests/test_torch_copies.py): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class BinFHEMethod(enum.Enum):
    """Blind-rotation method.  Parity: lbcrypto::BINFHE_METHOD (AP | GINX),
    selected in reference src/utils.cpp:180-185."""

    AP = "AP"
    GINX = "GINX"


class BinGate(enum.Enum):
    """Bootstrapped binary gates.  Parity: lbcrypto::BINGATE used at
    reference src/gate.cpp:133,171 (AND/OR); the rest for completeness."""

    AND = "AND"
    OR = "OR"
    NAND = "NAND"
    NOR = "NOR"
    XOR = "XOR"
    XNOR = "XNOR"


# The classic FHEW 27-bit NTT prime: Q = 2**27 - 2**11 + 1, Q ≡ 1 (mod 2048),
# so it supports negacyclic NTTs up to N=1024.
Q27 = 134215681


def _is_prime(v: int) -> bool:
    if v < 2:
        return False
    for p in range(2, int(math.isqrt(v)) + 1):
        if v % p == 0:
            return False
    return True


@dataclasses.dataclass(frozen=True)
class BinFHEParams:
    """One FHEW/TFHE parameter record.

    Attributes mirror the quantities OpenFHE's ``binfhe`` keeps internally
    (reference call sites: SURVEY.md §2.8):

    n      : LWE dimension of gate ciphertexts.
    q      : LWE ciphertext modulus (power of two, q <= 2N).
    N      : ring dimension of the accumulator ring Z_Q[X]/(X^N+1).
    Q      : ring modulus (NTT-friendly prime, < 2**27).
    Q_ks   : key-switching modulus (power of two).
    B_g    : gadget (decomposition) base for RGSW external products.
    B_ks   : key-switching decomposition base.
    B_r    : AP-method rotation base (per-digit value grouping).
    sigma  : discrete-Gaussian noise std-dev.
    secret : 'ternary' or 'binary' LWE secret distribution.
    """

    name: str
    n: int
    q: int
    N: int
    Q: int
    Q_ks: int
    B_g: int
    B_ks: int
    B_r: int
    sigma: float
    secret: str = "ternary"
    # Approximate gadget decomposition (TFHE-style): keep only the top
    # ``d_g_eff`` digits of the centered-and-rounded accumulator; the dropped
    # low bits become a small uniform noise term (bounded by 2**(g_shift-1)
    # per coefficient per external product — see NOISE.md).  0 = exact.
    # Halves the blind-rotation MXU work at STD128 (R = 2*d_g_used rows).
    d_g_eff: int = 0

    # ---- derived quantities -------------------------------------------------
    @property
    def d_g(self) -> int:
        """Number of gadget digits covering Q exactly."""
        return int(math.ceil(math.log2(self.Q) / math.log2(self.B_g)))

    @property
    def d_g_used(self) -> int:
        """Gadget digits actually used (approximate when d_g_eff > 0)."""
        return self.d_g_eff or self.d_g

    @property
    def g_shift(self) -> int:
        """Low bits dropped by the approximate decomposition (0 = exact).

        The gadget values become B_g**j * 2**g_shift, covering [0, Q) after
        centered rounding by 2**g_shift."""
        if not self.d_g_eff:
            return 0
        return int(math.ceil(math.log2(self.Q))) - self.log_B_g * self.d_g_eff

    @property
    def d_ks(self) -> int:
        """Number of key-switch digits covering Q_ks."""
        return int(math.ceil(math.log2(self.Q_ks) / math.log2(self.B_ks)))

    @property
    def d_r(self) -> int:
        """Number of AP rotation digits covering the 2N phase domain."""
        return int(math.ceil(math.log2(2 * self.N) / math.log2(self.B_r)))

    @property
    def log_B_g(self) -> int:
        return int(round(math.log2(self.B_g)))

    @property
    def log_B_ks(self) -> int:
        return int(round(math.log2(self.B_ks)))

    def __post_init__(self):
        assert self.q & (self.q - 1) == 0, "q must be a power of two"
        assert self.Q_ks & (self.Q_ks - 1) == 0, "Q_ks must be a power of two"
        assert self.B_g & (self.B_g - 1) == 0 and self.B_g <= 256
        assert self.B_ks & (self.B_ks - 1) == 0 and self.B_ks <= 256
        assert self.N & (self.N - 1) == 0
        assert self.q <= 2 * self.N, "q must divide into the 2N phase domain"
        assert self.Q < 2**27
        assert self.Q % (2 * self.N) == 1, "Q must be ≡ 1 mod 2N (negacyclic NTT)"
        assert _is_prime(self.Q), "Q must be prime"
        assert self.secret in ("ternary", "binary")
        if self.d_g_eff:
            assert 0 < self.d_g_eff <= self.d_g
            assert self.g_shift >= 0
            # centered-rounded digits must stay int8-safe: |v| <= 2**(bits-1)
            # where bits = ceil(log2 Q) - g_shift = log_B_g * d_g_eff, and the
            # top digit then lies in [-B_g/2, B_g/2] (see golden.gadget_digits
            # docstring for the boundary case).
            assert self.B_g ** self.d_g_eff * 2 ** self.g_shift >= self.Q


# ---------------------------------------------------------------------------
# Parameter registry.  Names mirror lbcrypto::BINFHE_PARAMSET values accepted
# by the reference CLI (src/utils.cpp:166-177): TOY and STD128_OPT; STD128
# added for completeness.
# ---------------------------------------------------------------------------

# MICRO is ours alone: a tiny self-test set making exhaustive golden<->device
# bitwise differential tests affordable (the golden model is O(N^2) NumPy).
# It offers no security whatsoever.
MICRO = BinFHEParams(
    name="MICRO",
    n=16,
    q=256,
    N=128,
    Q=Q27,
    Q_ks=1 << 15,
    B_g=1 << 7,
    B_ks=1 << 2,  # d_ks = 8
    B_r=1 << 5,
    sigma=3.19,
    secret="ternary",
)

TOY = BinFHEParams(
    name="TOY",
    n=64,
    q=512,
    N=512,
    Q=Q27,
    Q_ks=1 << 15,
    B_g=1 << 7,  # d_g = 4
    B_ks=1 << 2,  # d_ks = 8: small base keeps matmul-form key-switch noise low
    B_r=1 << 5,
    sigma=3.19,
    secret="ternary",
)

STD128 = BinFHEParams(
    name="STD128",
    n=512,
    q=1024,
    N=1024,
    Q=Q27,
    Q_ks=1 << 15,
    B_g=1 << 7,  # d_g = 4
    B_ks=1 << 2,  # d_ks = 8: small base keeps matmul-form key-switch noise low
    # AP rotation base 2 (d_r = 11): the TPU-native choice — every AP step
    # becomes ONE shared-key MXU external product + a public-bit select
    # (boot._blind_rotate_ap_fused), and the AP key stays ~2.7 GB instead of
    # the O(n*d_r*B_r) blowup of larger bases.  MICRO keeps B_r=32 to
    # exercise the generic-base golden/jnp path.
    B_r=1 << 1,
    sigma=3.19,
    secret="ternary",
)

# "Optimized" 128-bit set: slightly reduced LWE dimension, matching the
# reference's default CLI choice (src/utils.cpp:137, TB_*.cpp:83).  The
# d_g_eff=2 approximate gadget decomposition is the "OPT" part here: it
# halves the blind-rotation matmul (R = 4 digit rows instead of 8) while the
# dropped-bits noise (uniform, <= 2**12 per coefficient per step) stays far
# below the key-noise floor — measured failure rates in NOISE.md.
STD128_OPT = BinFHEParams(
    name="STD128_OPT",
    n=502,
    q=1024,
    N=1024,
    Q=Q27,
    Q_ks=1 << 15,
    B_g=1 << 7,
    B_ks=1 << 2,
    B_r=1 << 1,  # binary AP digits (see STD128 note)
    sigma=3.19,
    secret="ternary",
    d_g_eff=2,  # g_shift = 27 - 7*2 = 13
)

# MICRO-scale twin of the approximate-decomposition path (affordable golden
# differential tests of d_g_eff > 0; MICRO itself keeps the exact gadget).
MICRO_A = dataclasses.replace(MICRO, name="MICRO_A", d_g_eff=2)

PARAM_SETS = {p.name: p for p in (MICRO, MICRO_A, TOY, STD128, STD128_OPT)}


def get_params(name: str) -> BinFHEParams:
    """Look up a parameter set by name (CLI parity: src/utils.cpp:166-177)."""
    try:
        return PARAM_SETS[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown BINFHE_PARAMSET {name!r}; known: {sorted(PARAM_SETS)}"
        ) from None
