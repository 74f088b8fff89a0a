"""Int32 modular arithmetic on torch tensors (counterpart of oece_tpu.fhe.modmath).

The ring modulus is the FHEW prime Q = 2**27 - 2**11 + 1 with the reduction
identity 2**27 == 2**11 - 1 (mod Q).  Every function takes and returns int32
tensors, keeps every intermediate below 2**31 and returns canonical residues
in [0, Q) — bit-identical to the JAX/NumPy versions on the same inputs.
torch's ``>>`` on negative int32 is an arithmetic shift, as in jnp.
"""

from __future__ import annotations

import torch

from .params import Q27

N_LIMBS = 4


def red31(x: torch.Tensor, Q: int = Q27) -> torch.Tensor:
    """Reduce 0 <= x < 2**31 to [0, Q)."""
    hi = x >> 27
    lo = x & ((1 << 27) - 1)
    y = hi * ((1 << 11) - 1) + lo
    return y - Q * (y >= Q).to(y.dtype)


def mod_q(x: torch.Tensor, Q: int = Q27) -> torch.Tensor:
    """Reduce signed int32 x with |x| <= 2**30 to [0, Q)."""
    return red31(x + 8 * Q, Q)


def mul_pow8_mod(x: torch.Tensor, Q: int = Q27) -> torch.Tensor:
    """(x * 2**8) mod Q for x in [0, Q)."""
    hi = x >> 19
    lo = x & ((1 << 19) - 1)
    y = hi * ((1 << 11) - 1) + (lo << 8)
    return y - Q * (y >= Q).to(y.dtype)


def combine_limbs_mod_q(r_limbs: torch.Tensor, Q: int = Q27) -> torch.Tensor:
    """sum_l r_l * 2**(8l) mod Q over the last axis (Horner), |r_l| <= 2**27."""
    L = r_limbs.shape[-1]
    acc = mod_q(r_limbs[..., L - 1], Q)
    for l in range(L - 2, -1, -1):
        acc = mul_pow8_mod(acc, Q) + mod_q(r_limbs[..., l], Q)
        acc = acc - Q * (acc >= Q).to(acc.dtype)
    return acc


def mod_switch_from_q27(x: torch.Tensor, M_log2: int, Q: int = Q27) -> torch.Tensor:
    """round(x * 2**M_log2 / Q) for x in [0, Q), exactly, in int32."""
    assert M_log2 + 12 <= 27
    sh = 27 - M_log2
    x1 = x >> sh
    x0 = x & ((1 << sh) - 1)
    z = x1 * ((1 << 11) - 1) + (x0 << M_log2) + Q // 2
    q2 = (z >= Q).to(x.dtype) + (z >= 2 * Q).to(x.dtype) + (z >= 3 * Q).to(x.dtype)
    return x1 + q2


def to_limbs_i8(v: torch.Tensor) -> torch.Tensor:
    """[...] int32 in [0, 2**31) -> [..., 4] int8 signed base-256 limbs, exact."""
    digs = []
    cur = v
    for _ in range(N_LIMBS - 1):
        r = cur & 0xFF
        r = r - ((r >= 128).to(r.dtype) << 8)
        digs.append(r.to(torch.int8))
        cur = (cur - r) >> 8
    digs.append(cur.to(torch.int8))
    return torch.stack(digs, dim=-1)
