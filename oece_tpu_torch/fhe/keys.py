"""Bootstrap key tensors of the blind rotations.

Counterpart of ``oece_tpu.fhe.boot.DeviceBootKeys`` restricted to what the
port's rotations read (T = 128, nt = N/T, R = 2*d_g_used, L = 4 limbs):

  ginx_ext : GINX, standard form (fhe/std.py).  int8 [n, R, 16, 2N]  the
             limb planes, plane = (part*2 + out)*4 + limb, of each step's
             RGSW pair (part 0: RGSW(s+_i), part 1: RGSW(s-_i)) over v,
             then over -v mod Q: the array oece_tpu's ``pack_bootstrap_key``
             builds before the TPU's byte-phase window packing (the
             ``ginx_pallas`` layout).  65.8 MB at STD128_OPT, 134 MB at
             STD128.
  rev      : GINX, standard form on prebuilt diagonals (fhe/rev.py).  int8
             [n, (2*nt-1)*R*T, 16*T]  every step's ginx_ext block expanded
             once at keygen: row (d', r, u) at d'*RT + r*T + u, column
             (m, t) at m*T + t with plane m = (part*2 + out)*4 + limb
             (``rev_block``).  The layout of oece_tpu's devkeygen "rev",
             the default of its ``device_keygen``.  7.9 GB at STD128_OPT.
             On the card rev is K-major, as rev2 is (below): int8 [n, 16,
             T, (2*nt-1)*R*T], entry [i, m, t, x] = the row-major [i, x,
             m*T + t] (csrc/rev_step.cu reads it so); ``build_rev``,
             ``rev_to`` and ``BootKeys.to`` follow the device the same way.
  rev2     : GINX, rotated-difference form (fhe/rot.py: one step loop, or
             one rot_step_true call per step under OECE_ROT_MEGA=0).  int8
             [n, (2*nt-1)*2*R*T, 8*T]  part-interleaved prebuilt reversed
             diagonals of every step's RGSW key pair; row (d', part, r, u)
             sits at d'*2RT + part*RT + r*T + u, column (out, limb, t) at
             (out*4 + limb)*T + t.  The layout of oece_tpu's devkeygen
             "rev2".  7.9 GB at STD128_OPT.
             On the card rev2 is K-major instead, the layout its GEMM reads
             (csrc/rot_step.cu): int8 [n, 8, T, (2*nt-1)*2*R*T], entry
             [i, out*4 + limb, t, x] = the row-major [i, x, (out*4 + limb)*T
             + t], each step's block transposed.  The shape tells the two
             layouts apart: a K-major key has one dimension more (4 for the
             whole key, 3 for one step's block; row-major 3 and 2).  The
             CPU holds rev2 row-major (``from_jax`` carries it across so,
             and every plain twin reads it so); device keygen on the card,
             ``pack_rotated_form(..., device="cuda")`` and ``BootKeys.to``
             write it K-major, one step at a time (``rev2_to``), so the card
             never holds both layouts of a whole key.
  ap_ext   : AP.  int8 [n*d_r, R, 8, 2N] for the binary base (B_r = 2)
             the limb planes (plane = out*4 + limb) of each v=1 step key,
             over v then -v mod Q: oece_tpu's ``_ext_limb_planes`` form,
             before the TPU's window packing.  362 MB at STD128_OPT.  A
             generic base (B_r != 2, MICRO and TOY) keeps every digit
             value: int8 [n*d_r*B_r, R, 8, 2N], key (i, j, v) at (i*d_r +
             j)*B_r + v, v = 0 included and never read: oece_tpu's
             ``ap_kext`` [n, d_r, B_r, R, out, L, 2N] with (out, L) as one
             plane axis.  268 MB at TOY.
  ksk      : int8 [N*d_ks, n+1, 2]  centred base-256 limbs of the key-switch
             key mod Q_ks.
  tv_table : int32 [6, N]  test vectors mod Q, in GATE_ORDER.

The two GINX forms give different ciphertext bits for the same golden keys
(golden.blind_rotate_ginx against blind_rotate_ginx_rot), so each key
layout selects its own rotation (fhe/boot.py): ginx_ext and rev the
standard form, rev2 the rotated form.

``build_rev`` and ``build_rev2`` expand GINX refresh keys into rev and
rev2 one step at a time (fhe/devkeygen.py), each in its device's layout.  ``pack_bootstrap_key``
packs a golden ``BootstrapKey`` (the port's ``fhe/golden.py`` record) as
the JAX package does on an accelerator (GINX -> ginx_ext, binary-base AP
-> ap_ext); ``pack_rotated_form`` packs GINX golden keys into rev2
instead.  ``from_jax`` carries keys made by the JAX package across (numpy
copies; the TPU's windows are unpacked), translating its params by field
and its method by name: it is the one place where a record of the JAX
package enters the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import golden, modmath
from .params import BinFHEMethod, BinFHEParams, BinGate

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
    rev: Optional[torch.Tensor] = None
    rev2: Optional[torch.Tensor] = None
    ap_ext: Optional[torch.Tensor] = None
    ginx_ext: Optional[torch.Tensor] = None

    def to(self, device) -> "BootKeys":
        """The keys on ``device``, rev and rev2 in that device's layout."""
        def move(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, ksk=move(self.ksk), tv_table=move(self.tv_table),
            rev=None if self.rev is None else rev_to(self.rev, device),
            rev2=None if self.rev2 is None else rev2_to(self.rev2, device),
            ap_ext=move(self.ap_ext), ginx_ext=move(self.ginx_ext),
        )


def tv_table(params: BinFHEParams, device) -> torch.Tensor:
    tv = np.stack([golden.make_test_vector(params, g) for g in GATE_ORDER])
    return torch.from_numpy(tv.astype(np.int32)).to(device)


def ksk_limbs(ksk: torch.Tensor, Q_ks: int) -> torch.Tensor:
    """Key-switch key [N*d_ks, n+1] in [0, Q_ks) -> centred int8 limbs
    [N*d_ks, n+1, 2] with value = l0 + 256*l1."""
    kc = ksk - (ksk >= Q_ks // 2).to(ksk.dtype) * Q_ks
    l0 = kc - (((kc + 128) >> 8) << 8)
    l1 = (kc - l0) >> 8
    return torch.stack([l0, l1], dim=-1).to(torch.int8)


def ext_planes(polys: torch.Tensor, Q: int) -> torch.Tensor:
    """Polynomials int32 [..., N] mod Q -> int8 [..., L=4, 2N]: the limbs of
    v, then of -v mod Q (boot._poly_ext_limbs)."""
    neg = torch.where(polys == 0, 0, Q - polys)
    ext = torch.cat([polys, neg], dim=-1)
    return modmath.to_limbs_i8(ext).movedim(-1, -2)


def rev_index(N: int, device) -> torch.Tensor:
    """[2nt-1, T(u), T(t)] int64: ((nt-1-d')*T + t - u) mod 2N."""
    nt = N // TILE
    dp = torch.arange(2 * nt - 1, device=device)[:, None, None]
    u = torch.arange(TILE, device=device)[None, :, None]
    t = torch.arange(TILE, device=device)[None, None, :]
    return ((nt - 1 - dp) * TILE + t - u) % (2 * N)


def rev_block(ext_s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One step's compact key int8 [R, M, 2N] -> reversed diagonals int8
    [(2nt-1)*R*T, M*T]: rev[d'*RT + r*T + u, m*T + t] =
    ext_s[r, m, ((nt-1-d')*T + t - u) mod 2N] (idx = rev_index).  Output
    tile k contracts rows [(nt-1-k)*RT, (2nt-1-k)*RT)."""
    R, M = ext_s.shape[:2]
    ndiag = idx.shape[0]
    g = ext_s[:, :, idx]  # [R, M, ndiag, u, t]
    return g.permute(2, 0, 3, 1, 4).reshape(ndiag * R * TILE, M * TILE)


def rev_block_kmajor(ext_s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rev_block`` K-major: int8 [M, T, (2nt-1)*R*T], entry [m, t,
    d'*RT + r*T + u] = ext_s[r, m, ((nt-1-d')*T + t - u) mod 2N], the
    row-major block transposed."""
    R, M = ext_s.shape[:2]
    g = ext_s[:, :, idx]  # [R, M, ndiag, u, t]
    return g.permute(1, 4, 2, 0, 3).reshape(M, TILE, idx.shape[0] * R * TILE)


def rev2_step(brk_i: torch.Tensor, Q: int, idx: torch.Tensor, kmajor: bool = False) -> torch.Tensor:
    """One step's RGSW pair int32 [part=2, R, out=2, N] mod Q -> its rev2
    block int8 [(2nt-1)*2*R*T, 8*T], or K-major [8, T, (2nt-1)*2*R*T]."""
    _, R, _, N = brk_i.shape
    ndiag = idx.shape[0]
    perm = ext_planes(brk_i, Q).reshape(2, R * 8, 2 * N)
    g = perm[:, :, idx].reshape(2, R, 8, ndiag, TILE, TILE)  # [part, r, plane, d', u, t]
    if kmajor:
        return g.permute(2, 5, 3, 0, 1, 4).reshape(8, TILE, ndiag * 2 * R * TILE)
    return g.permute(3, 0, 1, 4, 2, 5).reshape(ndiag * 2 * R * TILE, 8 * TILE)


def rev2_shape(n: int, R: int, N: int, kmajor: bool) -> tuple:
    """The shape of a rev2 key of n steps, row-major or K-major."""
    rows = (2 * (N // TILE) - 1) * 2 * R * TILE
    return (n, 8, TILE, rows) if kmajor else (n, rows, 8 * TILE)


def build_rev2(brk: torch.Tensor, Q: int) -> torch.Tensor:
    """brk int32 [n, part=2, R, out=2, N] mod Q -> rev2 int8 in its
    device's layout (K-major on the card), built one step at a time (a
    whole-array gather would hold two copies of ~8 GB at STD128_OPT)."""
    n, _, R, _, N = brk.shape
    assert N % TILE == 0, "rev2 needs N % 128 == 0"
    kmajor = brk.is_cuda
    idx = rev_index(N, brk.device)
    out = torch.empty(rev2_shape(n, R, N, kmajor), dtype=torch.int8, device=brk.device)
    for i in range(n):
        out[i] = rev2_step(brk[i], Q, idx, kmajor)
    return out


def _key_to(key: torch.Tensor, planes: int, device, kmajor: Optional[bool]) -> torch.Tensor:
    """A whole prebuilt key of ``planes`` key planes (rev 16, rev2 8) on
    ``device``: row-major [n, rows, planes*T] or K-major [n, planes, T,
    rows], K-major on the card and row-major elsewhere unless ``kmajor``
    says otherwise.  A change of layout goes one step at a time: the new
    key plus one step's block."""
    device = torch.device(device)
    kmajor = device.type == "cuda" if kmajor is None else kmajor
    if (key.ndim == 4) == kmajor:
        return key.to(device)
    n, rows = key.shape[0], key.shape[-1] if key.ndim == 4 else key.shape[1]
    out = torch.empty(
        (n, planes, TILE, rows) if kmajor else (n, rows, planes * TILE), dtype=torch.int8,
        device=device,
    )
    for i in range(n):
        blk = key[i].to(device)
        if kmajor:
            out[i].view(planes * TILE, rows).copy_(blk.t())
        else:
            out[i].copy_(blk.view(planes * TILE, rows).t())
    return out


def rev2_to(rev2: torch.Tensor, device, kmajor: Optional[bool] = None) -> torch.Tensor:
    """A whole rev2 key on ``device``, K-major on the card and row-major
    elsewhere unless ``kmajor`` says otherwise (``_key_to``)."""
    return _key_to(rev2, 8, device, kmajor)


def rev_to(rev: torch.Tensor, device, kmajor: Optional[bool] = None) -> torch.Tensor:
    """A whole rev key on ``device``, K-major on the card ([n, 16, T,
    rows]) and row-major elsewhere ([n, rows, 16T]) unless ``kmajor`` says
    otherwise (``_key_to``)."""
    return _key_to(rev, 16, device, kmajor)


def rev_shape(n: int, R: int, N: int, kmajor: bool) -> tuple:
    """The shape of a rev key of n steps, row-major or K-major."""
    rows = (2 * (N // TILE) - 1) * R * TILE
    return (n, 16, TILE, rows) if kmajor else (n, rows, 16 * TILE)


def rev_step(brk_i: torch.Tensor, Q: int, idx: torch.Tensor, kmajor: bool = False) -> torch.Tensor:
    """One step's RGSW pair int32 [part=2, R, out=2, N] mod Q -> its rev
    block int8 [(2nt-1)*R*T, 16*T] (``rev_block`` of its ginx_ext planes),
    or K-major [16, T, (2nt-1)*R*T]."""
    ext_s = ginx_ext_planes(brk_i[None], Q)[0]  # [R, 16, 2N]
    return rev_block_kmajor(ext_s, idx) if kmajor else rev_block(ext_s, idx)


def build_rev(brk: torch.Tensor, Q: int, kmajor: Optional[bool] = None) -> torch.Tensor:
    """brk int32 [n, part=2, R, out=2, N] mod Q -> rev int8 in its
    device's layout (K-major on the card) unless ``kmajor`` says
    otherwise, built one step at a time as ``build_rev2`` is."""
    n, _, R, _, N = brk.shape
    assert N % TILE == 0, "rev needs N % 128 == 0"
    kmajor = brk.is_cuda if kmajor is None else kmajor
    idx = rev_index(N, brk.device)
    out = torch.empty(rev_shape(n, R, N, kmajor), dtype=torch.int8, device=brk.device)
    for i in range(n):
        out[i] = rev_step(brk[i], Q, idx, kmajor)
    return out


def ginx_ext_planes(brk: torch.Tensor, Q: int) -> torch.Tensor:
    """GINX refresh keys int32 [n, part=2, R, out=2, N] mod Q -> ginx_ext
    int8 [n, R, 16, 2N], plane (part*2 + out)*4 + limb."""
    n, _, R, _, N = brk.shape
    planes = ext_planes(brk, Q)  # [n, part, R, out, L, 2N]
    return planes.permute(0, 2, 1, 3, 4, 5).reshape(n, R, 16, 2 * N).contiguous()


def ap_ext_planes(rows: torch.Tensor, Q: int) -> torch.Tensor:
    """AP step keys int32 [steps, R, out=2, N] mod Q -> ap_ext int8
    [steps, R, 8, 2N]: limb planes of v, then of -v mod Q."""
    steps, R, _, N = rows.shape
    return ext_planes(rows, Q).reshape(steps, R, 8, 2 * N).contiguous()


def unpack_windows(wins: np.ndarray, R: int, M: int, N: int) -> torch.Tensor:
    """oece_tpu's byte-phase key windows int32 [steps, 2nt-1, 4, R*M*64]
    (``pack_keys_for_pallas`` of each step) -> int8 [steps, R, M, 2N].

    Window d at byte phase 0 holds the 256 bytes of the cyclic 2N sequence
    that start at ((d - nt)*T) mod 2N, four per little-endian int32 word.
    The first T bytes of every window and the last T of the last window
    are the sequence rolled by N."""
    steps, ndiag = wins.shape[:2]
    by = np.ascontiguousarray(wins[:, :, 0]).view(np.int8)  # little-endian bytes
    by = by.reshape(steps, ndiag, R * M, 2 * TILE)
    seq = np.concatenate(
        [by[:, d, :, :TILE] for d in range(ndiag)] + [by[:, -1, :, TILE:]], axis=-1
    )
    ext = np.roll(seq, N, axis=-1)  # seq[k] = ext[(k + N) mod 2N]
    return torch.from_numpy(np.ascontiguousarray(ext.reshape(steps, R, M, 2 * N)))


def from_jax(dkeys) -> BootKeys:
    """Numpy copies of a JAX ``DeviceBootKeys``: GINX keys in the rev or
    rev2 layout or the ``ginx_pallas`` windows, binary-base AP keys in the
    ``ap_pallas`` windows, or generic-base AP keys in ``ap_kext``."""
    p = BinFHEParams(**{f.name: getattr(dkeys.params, f.name)
                        for f in dataclasses.fields(BinFHEParams)})
    method = BinFHEMethod[dkeys.method.name]
    R = 2 * p.d_g_used
    common = dict(
        params=p, method=method,
        ksk=torch.from_numpy(np.array(dkeys.ksk, dtype=np.int8)),
        tv_table=torch.from_numpy(np.array(dkeys.tv_table, dtype=np.int32)),
    )
    if method == BinFHEMethod.AP:
        if dkeys.ap_kext is not None and p.B_r != 2:
            kext = np.array(dkeys.ap_kext, dtype=np.int8)  # [n, d_r, B_r, R, out, L, 2N]
            return BootKeys(**common, ap_ext=torch.from_numpy(
                np.ascontiguousarray(kext.reshape(-1, R, 8, 2 * p.N))))
        if dkeys.ap_pallas is None:
            raise ValueError("from_jax needs binary-base AP keys in the ap_pallas layout "
                             "or generic-base AP keys in ap_kext")
        wins = np.array(dkeys.ap_pallas, dtype=np.int32)
        return BootKeys(**common, ap_ext=unpack_windows(wins, R, 8, p.N))
    if dkeys.ginx_rev is not None:
        return BootKeys(**common, rev=torch.from_numpy(np.array(dkeys.ginx_rev, dtype=np.int8)))
    if dkeys.ginx_rev2 is not None:
        return BootKeys(**common, rev2=torch.from_numpy(np.array(dkeys.ginx_rev2, dtype=np.int8)))
    if dkeys.ginx_pallas is not None:
        wins = np.array(dkeys.ginx_pallas, dtype=np.int32)
        return BootKeys(**common, ginx_ext=unpack_windows(wins, R, 16, p.N))
    raise ValueError("from_jax needs GINX keys in the rev, rev2 or ginx_pallas layout")


def _ksk_and_tv(bk, p: BinFHEParams, device) -> dict:
    ksk = np.asarray(bk.ksk, dtype=np.int64).reshape(p.N * p.d_ks, p.n + 1) % p.Q_ks
    return dict(
        ksk=ksk_limbs(torch.from_numpy(ksk), p.Q_ks).to(device),
        tv_table=tv_table(p, device),
    )


def _port_record(bk: golden.BootstrapKey) -> tuple[BinFHEParams, BinFHEMethod]:
    if not isinstance(bk.params, BinFHEParams) or not isinstance(bk.method, BinFHEMethod):
        raise TypeError("want a BootstrapKey with the port's params and method "
                        "(keys made by the JAX package go through from_jax)")
    return bk.params, bk.method


def _brk(bk, p: BinFHEParams, device) -> torch.Tensor:
    brk = np.stack([bk.brk_pos, bk.brk_neg], axis=1) % p.Q  # [n, 2, R, 2, N]
    return torch.from_numpy(brk.astype(np.int32)).to(device)


def pack_bootstrap_key(bk: golden.BootstrapKey, device="cuda") -> BootKeys:
    """Pack a golden ``BootstrapKey`` on ``device`` (boot.pack_bootstrap_key
    on an accelerator): GINX refresh keys into ginx_ext (the standard
    form), AP keys into ap_ext (binary base: their v=1 entries; a generic
    base: every v, as the JAX package's ap_kext)."""
    p, method = _port_record(bk)
    common = dict(params=p, method=method, **_ksk_and_tv(bk, p, device))
    if method == BinFHEMethod.AP:
        ak = bk.ak[:, :, 1] if p.B_r == 2 else bk.ak
        rows = ak.reshape(-1, 2 * p.d_g_used, 2, p.N) % p.Q
        rows = torch.from_numpy(rows.astype(np.int32)).to(device)
        return BootKeys(**common, ap_ext=ap_ext_planes(rows, p.Q))
    return BootKeys(**common, ginx_ext=ginx_ext_planes(_brk(bk, p, device), p.Q))


def pack_rotated_form(bk: golden.BootstrapKey, device="cuda") -> BootKeys:
    """Pack GINX golden keys into rev2 (K-major on the card), for the
    rotated-difference form (golden.bootstrap(form="rot") is its twin)."""
    p, method = _port_record(bk)
    if method != BinFHEMethod.GINX:
        raise ValueError("the rotated form is a GINX key layout")
    return BootKeys(
        params=p, method=method, **_ksk_and_tv(bk, p, device),
        rev2=build_rev2(_brk(bk, p, device), p.Q),
    )
