"""Bootstrap key tensors of the GINX rotated-difference path.

Counterpart of ``oece_tpu.fhe.boot.DeviceBootKeys`` restricted to what the
rev2 main path reads:

  rev2     : int8 [n, (2*nt-1)*2*R*T, 8*T]  part-interleaved prebuilt
             reversed diagonals of every step's RGSW key pair; row
             (d', part, r, u) sits at d'*2RT + part*RT + r*T + u, column
             (out, limb, t) at (out*4 + limb)*T + t   (T = 128, nt = N/T,
             R = 2*d_g_used).  The layout of oece_tpu's devkeygen "rev2".
  ksk      : int8 [N*d_ks, n+1, 2]  centred base-256 limbs of the key-switch
             key mod Q_ks.
  tv_table : int32 [6, N]  test vectors mod Q, in GATE_ORDER.

``from_jax`` carries keys generated by the JAX package across unchanged
(numpy copies); ``from_golden`` builds them from a NumPy golden
``BootstrapKey`` with the same layout rules.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from oece_tpu.fhe import golden
from oece_tpu.fhe.params import BinFHEParams, BinGate

from . import modmath

TILE = 128

# Fixed gate enumeration of the test-vector table (oece_tpu.fhe.boot).
GATE_ORDER = [
    BinGate.AND, BinGate.OR, BinGate.NAND, BinGate.NOR, BinGate.XOR, BinGate.XNOR,
]
GATE_INDEX = {g: i for i, g in enumerate(GATE_ORDER)}


@dataclasses.dataclass
class BootKeys:
    params: BinFHEParams
    rev2: torch.Tensor
    ksk: torch.Tensor
    tv_table: torch.Tensor

    def to(self, device) -> "BootKeys":
        return BootKeys(
            self.params, self.rev2.to(device), self.ksk.to(device),
            self.tv_table.to(device),
        )


def tv_table(params: BinFHEParams, device="cpu") -> torch.Tensor:
    tv = np.stack([golden.make_test_vector(params, g) for g in GATE_ORDER])
    return torch.from_numpy(tv.astype(np.int32)).to(device)


def ksk_limbs(ksk: torch.Tensor, Q_ks: int) -> torch.Tensor:
    """Key-switch key [N*d_ks, n+1] in [0, Q_ks) -> centred int8 limbs
    [N*d_ks, n+1, 2] with value = l0 + 256*l1."""
    kc = ksk - (ksk >= Q_ks // 2).to(ksk.dtype) * Q_ks
    l0 = kc - (((kc + 128) >> 8) << 8)
    l1 = (kc - l0) >> 8
    return torch.stack([l0, l1], dim=-1).to(torch.int8)


def _rev2_index(N: int, device) -> torch.Tensor:
    """[2nt-1, T(u), T(t)] int64: ((nt-1-d')*T + t - u) mod 2N."""
    nt = N // TILE
    dp = torch.arange(2 * nt - 1, device=device)[:, None, None]
    u = torch.arange(TILE, device=device)[None, :, None]
    t = torch.arange(TILE, device=device)[None, None, :]
    return ((nt - 1 - dp) * TILE + t - u) % (2 * N)


def rev2_step(brk_i: torch.Tensor, Q: int, idx: torch.Tensor) -> torch.Tensor:
    """One step's RGSW pair int32 [part=2, R, out=2, N] mod Q -> its rev2
    block int8 [(2nt-1)*2*R*T, 8*T]."""
    _, R, _, N = brk_i.shape
    ndiag = idx.shape[0]
    neg = torch.where(brk_i == 0, 0, Q - brk_i)
    ext = torch.cat([brk_i, neg], dim=-1)  # [2, R, 2, 2N]: v, then -v mod Q
    perm = modmath.to_limbs_i8(ext).movedim(-1, -2).reshape(2, R * 8, 2 * N)
    g = perm[:, :, idx]  # [part, R*8, ndiag, u, t]
    g = g.reshape(2, R, 8, ndiag, TILE, TILE).permute(3, 0, 1, 4, 2, 5)
    return g.reshape(ndiag * 2 * R * TILE, 8 * TILE)


def build_rev2(brk: torch.Tensor, Q: int) -> torch.Tensor:
    """brk int32 [n, part=2, R, out=2, N] mod Q -> rev2 int8, built one step
    at a time (a whole-array gather would hold two copies of ~8 GB at
    STD128_OPT)."""
    n, _, R, _, N = brk.shape
    assert N % TILE == 0, "rev2 needs N % 128 == 0"
    idx = _rev2_index(N, brk.device)
    out = torch.empty(
        (n, idx.shape[0] * 2 * R * TILE, 8 * TILE), dtype=torch.int8,
        device=brk.device,
    )
    for i in range(n):
        out[i] = rev2_step(brk[i], Q, idx)
    return out


def from_jax(dkeys) -> BootKeys:
    """Numpy copies of a JAX ``DeviceBootKeys`` with the rev2 layout."""
    if dkeys.ginx_rev2 is None:
        raise ValueError("from_jax needs keys generated with layout='rev2'")
    return BootKeys(
        params=dkeys.params,
        rev2=torch.from_numpy(np.array(dkeys.ginx_rev2, dtype=np.int8)),
        ksk=torch.from_numpy(np.array(dkeys.ksk, dtype=np.int8)),
        tv_table=torch.from_numpy(np.array(dkeys.tv_table, dtype=np.int32)),
    )


def from_golden(bk: golden.BootstrapKey) -> BootKeys:
    """Pack a NumPy golden GINX ``BootstrapKey`` into the rev2 layout."""
    p = bk.params
    if bk.brk_pos is None:
        raise ValueError("from_golden needs GINX refresh keys")
    brk = np.stack([bk.brk_pos, bk.brk_neg], axis=1) % p.Q  # [n, 2, R, 2, N]
    ksk = np.asarray(bk.ksk, dtype=np.int64).reshape(p.N * p.d_ks, p.n + 1) % p.Q_ks
    return BootKeys(
        params=p,
        rev2=build_rev2(torch.from_numpy(brk.astype(np.int32)), p.Q),
        ksk=ksk_limbs(torch.from_numpy(ksk), p.Q_ks),
        tv_table=tv_table(p),
    )
