"""Bootstrap key tensors of the GINX and the binary-base AP rotations.

Counterpart of ``oece_tpu.fhe.boot.DeviceBootKeys`` restricted to what the
port's two rotations read (T = 128, nt = N/T, R = 2*d_g_used):

  rev2     : GINX only.  int8 [n, (2*nt-1)*2*R*T, 8*T]  part-interleaved
             prebuilt reversed diagonals of every step's RGSW key pair; row
             (d', part, r, u) sits at d'*2RT + part*RT + r*T + u, column
             (out, limb, t) at (out*4 + limb)*T + t.  The layout of
             oece_tpu's devkeygen "rev2".
  ap_ext   : AP (B_r = 2) only.  int8 [n*d_r, R, 8, 2N]  the limb planes
             (plane = out*4 + limb) of each v=1 step key followed by those
             of its negation mod Q: oece_tpu's ``_ext_limb_planes`` form,
             before the TPU's byte-phase window packing.  The rotation
             expands one step at a time into reversed diagonals.
  ksk      : int8 [N*d_ks, n+1, 2]  centred base-256 limbs of the key-switch
             key mod Q_ks.
  tv_table : int32 [6, N]  test vectors mod Q, in GATE_ORDER.

``from_jax`` carries keys generated by the JAX package across (numpy
copies; AP windows are unpacked); ``from_golden`` builds them from a NumPy
golden ``BootstrapKey`` with the same layout rules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from oece_tpu.fhe import golden
from oece_tpu.fhe.params import BinFHEMethod, BinFHEParams, BinGate

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
    ksk: torch.Tensor
    tv_table: torch.Tensor
    method: BinFHEMethod = BinFHEMethod.GINX
    rev2: Optional[torch.Tensor] = None
    ap_ext: Optional[torch.Tensor] = None

    def to(self, device) -> "BootKeys":
        def move(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, ksk=move(self.ksk), tv_table=move(self.tv_table),
            rev2=move(self.rev2), ap_ext=move(self.ap_ext),
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


def rev_index(N: int, device) -> torch.Tensor:
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
    idx = rev_index(N, brk.device)
    out = torch.empty(
        (n, idx.shape[0] * 2 * R * TILE, 8 * TILE), dtype=torch.int8,
        device=brk.device,
    )
    for i in range(n):
        out[i] = rev2_step(brk[i], Q, idx)
    return out


def ap_ext_planes(rows: torch.Tensor, Q: int) -> torch.Tensor:
    """AP step keys int32 [steps, R, out=2, N] mod Q -> ap_ext int8
    [steps, R, 8, 2N]: limb planes of v, then of -v mod Q."""
    steps, R, _, N = rows.shape
    neg = torch.where(rows == 0, 0, Q - rows)
    ext = torch.cat([rows, neg], dim=-1)  # [steps, R, 2, 2N]
    planes = modmath.to_limbs_i8(ext).movedim(-1, -2)  # [steps, R, 2, L, 2N]
    return planes.reshape(steps, R, 8, 2 * N).contiguous()


def unpack_ap_windows(wins: np.ndarray, R: int, N: int) -> torch.Tensor:
    """oece_tpu's ``ap_pallas`` windows int32 [steps, 2nt-1, 4, R*8*64] ->
    ap_ext int8 [steps, R, 8, 2N].

    Window d at byte phase 0 holds the 256 bytes of the cyclic 2N sequence
    that start at ((d - nt)*T) mod 2N, four per little-endian int32 word.
    The first T bytes of every window and the last T of the last window
    are the sequence rolled by N."""
    steps, ndiag = wins.shape[:2]
    by = np.ascontiguousarray(wins[:, :, 0]).view(np.int8)  # little-endian bytes
    by = by.reshape(steps, ndiag, R * 8, 2 * TILE)
    seq = np.concatenate(
        [by[:, d, :, :TILE] for d in range(ndiag)] + [by[:, -1, :, TILE:]], axis=-1
    )
    ext = np.roll(seq, N, axis=-1)  # seq[k] = ext[(k + N) mod 2N]
    return torch.from_numpy(np.ascontiguousarray(ext.reshape(steps, R, 8, 2 * N)))


def from_jax(dkeys) -> BootKeys:
    """Numpy copies of a JAX ``DeviceBootKeys``: GINX keys with the rev2
    layout, or binary-base AP keys with the ``ap_pallas`` windows."""
    p = dkeys.params
    common = dict(
        params=p, method=dkeys.method,
        ksk=torch.from_numpy(np.array(dkeys.ksk, dtype=np.int8)),
        tv_table=torch.from_numpy(np.array(dkeys.tv_table, dtype=np.int32)),
    )
    if dkeys.method == BinFHEMethod.AP:
        if dkeys.ap_pallas is None:
            raise ValueError("from_jax needs binary-base AP keys in the ap_pallas layout")
        wins = np.array(dkeys.ap_pallas, dtype=np.int32)
        return BootKeys(**common, ap_ext=unpack_ap_windows(wins, 2 * p.d_g_used, p.N))
    if dkeys.ginx_rev2 is None:
        raise ValueError("from_jax needs keys generated with layout='rev2'")
    return BootKeys(**common, rev2=torch.from_numpy(np.array(dkeys.ginx_rev2, dtype=np.int8)))


def from_golden(bk: golden.BootstrapKey) -> BootKeys:
    """Pack a NumPy golden ``BootstrapKey``: GINX refresh keys into the
    rev2 layout, binary-base AP keys (their v=1 entries) into ap_ext."""
    p = bk.params
    ksk = np.asarray(bk.ksk, dtype=np.int64).reshape(p.N * p.d_ks, p.n + 1) % p.Q_ks
    common = dict(
        params=p, method=bk.method, ksk=ksk_limbs(torch.from_numpy(ksk), p.Q_ks),
        tv_table=tv_table(p),
    )
    if bk.method == BinFHEMethod.AP:
        if p.B_r != 2:
            raise ValueError(f"from_golden packs binary-base AP keys only, got B_r={p.B_r}")
        rows = bk.ak[:, :, 1].reshape(p.n * p.d_r, 2 * p.d_g_used, 2, p.N) % p.Q
        return BootKeys(
            **common, ap_ext=ap_ext_planes(torch.from_numpy(rows.astype(np.int32)), p.Q)
        )
    brk = np.stack([bk.brk_pos, bk.brk_neg], axis=1) % p.Q  # [n, 2, R, 2, N]
    return BootKeys(**common, rev2=build_rev2(torch.from_numpy(brk.astype(np.int32)), p.Q))
