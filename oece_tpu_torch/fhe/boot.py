"""Batched gate bootstrapping on torch tensors (counterpart of
oece_tpu.fhe.boot: the GINX paths and the AP paths).

eval_bin_gate_batch = prepare_gates -> q->2N mod switch -> accumulator init
-> blind rotation -> sample extract -> Q->Q_ks mod switch -> key switch ->
Q_ks->q.  The key layout selects the rotation, as in the JAX package's
blind_rotate_ginx_dev:
  ginx_ext  the standard GINX form, each step's diagonals built per step
            (fhe/std.py; golden host keys);
  rev       the standard GINX form on diagonals prebuilt at keygen
            (fhe/rev.py; device keygen layout="rev", OECE_LAYOUT=rev);
  rev2      the rotated-difference form (fhe/rot.py; device keygen
            layout="rev2", the Circuit default): the whole-rotation step
            loop, or with OECE_ROT_MEGA=0 (``ROT_MEGA`` False) one
            ``rot_step_true`` call per step;
  ap_ext    the AP method (fhe/ap.py): kernel #13 for the binary base,
            blind_rotate_ap_generic (torch ops) for a generic one.
Every stage is exact integer arithmetic, so given the same keys and
ciphertexts the result is bit-identical to the JAX package's and to
golden.bootstrap (form="std" for ginx_ext and rev, form="rot" for rev2).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..utils import trace
from . import modmath
from .ap import blind_rotate_ap, blind_rotate_ap_generic
from .keys import BootKeys
from .rot import (  # noqa: F401  (re-export: the gadget helpers live with the rotation)
    acc_gadget_digits_dev,
    blind_rotate_rot,
    blind_rotate_rot_steps,
    gadget_digits_approx_dev,
    gadget_digits_dev,
    monomial_rotate,
)
from .rev import blind_rotate_rev
from .std import blind_rotate_std, blind_rotate_std_tp

# rev2 keys: the whole rotation as one step loop (True) or one call per
# step (False), read at import as in the JAX package (boot.py:62).
ROT_MEGA = os.environ.get("OECE_ROT_MEGA", "1") == "1"

# gate_prepare weights (golden.gate_prepare): prep = w1*c1 + w2*c2 mod q.
PREP_WEIGHTS = np.array(
    [[1, 1], [1, 1], [1, 1], [1, 1], [2, -2], [2, -2]], dtype=np.int32
)


def signed_digits_dev(x: torch.Tensor, B: int, d: int) -> torch.Tensor:
    """All-signed base-B digits (key switching); golden.signed_digits."""
    log_b = int(math.log2(B))
    half = B // 2
    digs = []
    cur = x
    for _ in range(d):
        r = cur & (B - 1)
        r = r - B * (r >= half).to(r.dtype)
        digs.append(r.to(torch.int8))
        cur = (cur - r) >> log_b
    return torch.stack(digs, dim=-1)


def acc_init(tv_sel: torch.Tensor, b2N: torch.Tensor, N: int, Q: int) -> torch.Tensor:
    """ACC = (0, tv * X^{b~}) as int32 [B, 2, N]."""
    rot = monomial_rotate(tv_sel, b2N, N, Q)
    return torch.stack([torch.zeros_like(rot), rot], dim=1)


def sample_extract(acc: torch.Tensor, Q: int) -> torch.Tensor:
    """RLWE [B, 2, N] -> LWE [B, N+1] mod Q (coefficient 0)."""
    a = acc[:, 0]
    rest = a[:, 1:].flip(-1)
    neg = torch.where(rest == 0, 0, Q - rest)
    return torch.cat([a[:, :1], neg, acc[:, 1, :1]], dim=1)


def key_switch_dev(ct_N: torch.Tensor, keys: BootKeys, tp=None) -> torch.Tensor:
    """LWE [B, N+1] mod Q_ks -> [B, n+1] mod Q_ks.  The int8 product runs in
    float32, exact because |sum| <= N*d_ks * 2 * 128 = 2**21 < 2**24 (torch
    has no integer matmul on CUDA); TF32 would round it, so it must be off.
    Under tensor parallelism (``tp``, a parallel.mesh.Mesh) keys.ksk holds
    this rank's rows of the contraction, and the partial products are
    summed over the tp group (the JAX package's psum)."""
    p = keys.params
    Qks, N, n = p.Q_ks, p.N, p.n
    if ct_N.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("key_switch_dev needs torch.backends.cuda.matmul.allow_tf32 = False")
    B = ct_N.shape[0]
    digs = signed_digits_dev(ct_N[:, :N], p.B_ks, p.d_ks).reshape(B, N * p.d_ks)
    k = keys.ksk.shape[0]
    if tp is not None:
        digs = digs[:, tp.tp_rank * k:(tp.tp_rank + 1) * k]
    ksk = keys.ksk.reshape(k, (n + 1) * 2)
    prod = (digs.to(torch.float32) @ ksk.to(torch.float32)).to(torch.int32)
    if tp is not None:
        import torch.distributed as dist

        dist.all_reduce(prod, group=tp.tp_group)
    prod = prod.reshape(B, n + 1, 2)
    out = -(prod[..., 0] + (prod[..., 1] << 8))
    out[:, n] += ct_N[:, N]
    return out & (Qks - 1)


def mod_switch_pow2(x: torch.Tensor, from_log2: int, to_log2: int) -> torch.Tensor:
    if to_log2 >= from_log2:
        return (x << (to_log2 - from_log2)) & ((1 << to_log2) - 1)
    sh = from_log2 - to_log2
    return ((x + (1 << (sh - 1))) >> sh) & ((1 << to_log2) - 1)


def blind_rotation(acc: torch.Tensor, a2N: torch.Tensor, keys: BootKeys) -> torch.Tensor:
    """The rotation that the keys' layout selects."""
    p = keys.params
    if keys.ap_ext is not None:
        rotate = blind_rotate_ap if p.B_r == 2 else blind_rotate_ap_generic
        return rotate(acc, keys.ap_ext, a2N, p)
    if keys.ginx_ext is not None:
        return blind_rotate_std(acc, keys.ginx_ext, a2N, p)
    if keys.rev is not None:
        return blind_rotate_rev(acc, keys.rev, a2N, p)
    if keys.rev2 is not None:
        rotate = blind_rotate_rot if ROT_MEGA else blind_rotate_rot_steps
        return rotate(acc, keys.rev2, a2N, p)
    raise ValueError("keys hold no rotation key (ap_ext, ginx_ext, rev or rev2)")


def bootstrap_batch(prep: torch.Tensor, gate_ids: torch.Tensor, keys: BootKeys, tp=None) -> torch.Tensor:
    """Bootstrap prepared LWE cts [B, n+1] mod q -> fresh cts [B, n+1].
    With ``tp`` (a parallel.mesh.Mesh with tp > 1) ``keys`` is this rank's
    tp shard of host GINX keys, and the rotation and the key switch sum
    their partial products over the tp group.  Under a traced Clock it is
    span ``boot`` with ``boot.pre``, ``boot.rotation`` and ``boot.post``,
    and counts the rotation, its lanes and (GINX: all n) its steps, and at
    a level's first rotation whether the card still ran the level before
    (``trace.edge``); inside
    ``boot.rotation`` a GINX rotation without tp counts its own step GEMM
    (rot.py's ``count_gemm``) and AP its live steps."""
    p = keys.params
    Q, N, q, Qks = p.Q, p.N, p.q, p.Q_ks
    log_q, log_qks = int(math.log2(q)), int(math.log2(Qks))
    with trace.span("boot", device=True):
        with trace.span("boot.pre", device=True):
            ct2N = mod_switch_pow2(prep, log_q, int(math.log2(2 * N)))
            a2N = ct2N[:, :-1].contiguous()
            acc = acc_init(keys.tv_table[gate_ids.long()], ct2N[:, -1], N, Q)
        with trace.span("boot.rotation", device=True):
            trace.edge()
            trace.count("rotations")
            trace.count("lanes", prep.shape[0])
            if keys.ap_ext is None:
                trace.count("steps", p.n)  # AP counts its live steps
            if tp is None:
                acc = blind_rotation(acc, a2N, keys)
            else:
                if keys.ginx_ext is None:
                    raise ValueError("tensor parallelism runs on host GINX keys (ginx_ext) only")
                acc = blind_rotate_std_tp(acc, keys.ginx_ext, a2N, p, tp)
        with trace.span("boot.post", device=True):
            ct_N = sample_extract(acc, Q)
            ct_N[:, -1] = (ct_N[:, -1] + Q // 8) % Q
            ct_ks = modmath.mod_switch_from_q27(ct_N, log_qks, Q)
            return mod_switch_pow2(key_switch_dev(ct_ks, keys, tp), log_qks, log_q)


def prepare_gates(ct1: torch.Tensor, ct2: torch.Tensor, gate_ids: torch.Tensor, q: int) -> torch.Tensor:
    """Per-gate linear combination w1*c1 + w2*c2 mod q (golden.gate_prepare).
    The weights' upload does not wait for the card: a blocking copy would
    make the host wait for every earlier launch at each gate batch."""
    w = torch.from_numpy(PREP_WEIGHTS).to(ct1.device, non_blocking=True)[gate_ids.long()]
    y = w[:, :1] * ct1 + w[:, 1:] * ct2
    return (y + 4 * q) & (q - 1)


def eval_bin_gate_batch(
    keys: BootKeys, gate_ids: torch.Tensor, ct1: torch.Tensor, ct2: torch.Tensor
) -> torch.Tensor:
    """Batched EvalBinGate: one bootstrap per lane."""
    prep = prepare_gates(ct1, ct2, gate_ids, keys.params.q)
    return bootstrap_batch(prep, gate_ids, keys)
