"""Bootstrap key generation on the device (counterpart of
oece_tpu.fhe.devkeygen): GINX keys in the "rev" layout (the standard form's
prebuilt diagonals, JAX's default; fhe/rev.py) or the "rev2" layout (the
rotated form's, ``Circuit``'s default; fhe/rot.py runs it as one step loop
or, under OECE_ROT_MEGA=0, one step per call), binary-base AP keys in the
``ap_ext`` layout.  The two GINX layouts hold the same key material: one
seed gives the same secrets and key-switch key in both.

Split in two so the arithmetic can be checked bit for bit against the JAX
package: ``sample`` / ``sample_ap`` draw the secrets, masks and noise from
``torch.Generator``s (torch's generator is not threefry, so its draws differ
from JAX's); ``assemble`` / ``assemble_ap`` are deterministic functions of
those draws and, fed JAX's own draws, return JAX's keys exactly.

As in the JAX package, every draw comes from one of eight named streams
(``STREAMS``), each seeded from the same 8 seed words: one seed gives the
GINX and the AP keygen the same LWE secret, ring secret and key-switch key.

The two plain products of keygen run in float64, which is exact here:
the negacyclic product A ⊛ z has |sum| <= N*Q < 2**37 and the key-switch
mask product |sum| <= n*Q_ks < 2**24, both below 2**53.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from . import golden, modmath
from . import keys as keys_mod
from .params import BinFHEMethod, BinFHEParams

# The JAX keygen's PRF split order (oece_tpu.fhe.devkeygen._prf_root_and_secrets):
# LWE secret, ring secret, GINX masks and noise, AP masks and noise,
# key-switch masks and noise.
STREAMS = ("s", "z", "ba", "be", "aa", "ae", "ka", "ke")


def seed_generators(seed_words: Optional[np.ndarray], device) -> Dict[str, torch.Generator]:
    """One torch.Generator on ``device`` per stream of ``STREAMS``, each
    seeded with SHA-256 of the 8 uint32 seed words and the stream's index
    (OS entropy replaces the words when ``seed_words`` is None, the
    production default)."""
    words = (
        np.frombuffer(os.urandom(32), dtype=np.uint32)
        if seed_words is None
        else np.asarray(seed_words, dtype=np.uint32).reshape(8)
    )
    gens = {}
    for k, name in enumerate(STREAMS):
        digest = hashlib.sha256(words.tobytes() + k.to_bytes(4, "little")).digest()
        gen = torch.Generator(device=device)
        gen.manual_seed(int.from_bytes(digest[:8], "little"))
        gens[name] = gen
    return gens


def _gauss(sigma: float, shape, gen: torch.Generator) -> torch.Tensor:
    """Rounded continuous Gaussian (golden.gauss semantics)."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return torch.round(sigma * x).to(torch.int32)


def _randint(lo: int, hi: int, shape, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device, dtype=torch.int32)


def _sample_streams(p: BinFHEParams, gens, key_shape, a: str, e: str):
    s = _randint(-1, 2, (p.n,), gens["s"])
    z = _randint(-1, 2, (p.N,), gens["z"])
    A = _randint(0, p.Q, key_shape, gens[a])
    E = _gauss(p.sigma, key_shape, gens[e])
    Aks = _randint(0, p.Q_ks, (p.N * p.d_ks, p.n), gens["ka"])
    Eks = _gauss(p.sigma, (p.N * p.d_ks,), gens["ke"])
    return s, z, A, E, Aks, Eks


def sample(params: BinFHEParams, gens):
    """GINX draws (s, z, A, E, Aks, Eks), int32 tensors on the generators'
    device: s [n] and z [N] ternary; A [n, 2, 2d, N] uniform mod Q and E
    Gaussian of the same shape (refresh keys); Aks [N*d_ks, n] uniform mod
    Q_ks and Eks [N*d_ks] Gaussian (key-switch key)."""
    p = params
    return _sample_streams(p, gens, (p.n, 2, 2 * p.d_g_used, p.N), "ba", "be")


def sample_ap(params: BinFHEParams, gens):
    """AP draws: as ``sample``, with A and E [n*d_r, 2d, N] from the AP
    streams (one RGSW key per rotation step)."""
    p = params
    return _sample_streams(p, gens, (p.n * p.d_r, 2 * p.d_g_used, p.N), "aa", "ae")


def negacyclic_by_ternary(A: torch.Tensor, z: torch.Tensor, Q: int) -> torch.Tensor:
    """A [..., N] mod Q ⊛ z [N] ternary -> [..., N] in [0, Q)."""
    N = A.shape[-1]
    i = torch.arange(N, device=A.device)
    idx = (i[None, :] - i[:, None]) % (2 * N)  # [i, k] -> (k - i) mod 2N
    Zm = torch.cat([z, -z]).to(torch.float64)[idx]  # [N, N]
    prod = A.reshape(-1, N).to(torch.float64) @ Zm
    return (prod.to(torch.int64) % Q).to(torch.int32).reshape(A.shape)


def keyswitch_key(params: BinFHEParams, s, z, Aks, Eks) -> torch.Tensor:
    p = params
    gk = torch.tensor(
        [pow(p.B_ks, j, p.Q_ks) for j in range(p.d_ks)], dtype=torch.int64,
        device=z.device,
    )
    zg = (z.to(torch.int64).repeat_interleave(p.d_ks) * gk.repeat(p.N)) % p.Q_ks
    As = (Aks.to(torch.float64) @ s.to(torch.float64)).to(torch.int64)
    bks = (As + Eks.to(torch.int64) + zg) % p.Q_ks
    ksk = torch.cat([Aks.to(torch.int64), bks[:, None]], dim=1)
    return keys_mod.ksk_limbs(ksk, p.Q_ks)


def _gadget(p: BinFHEParams, device) -> torch.Tensor:
    """Gadget values (B_g**j << g_shift) mod Q, int32 [d]."""
    return torch.tensor(
        [(pow(p.B_g, j, p.Q) << p.g_shift) % p.Q for j in range(p.d_g_used)],
        dtype=torch.int32, device=device,
    )


def _rgsw_rows(p: BinFHEParams, z, A, E, mg) -> torch.Tensor:
    """RGSW rows with the message-times-gadget term mg [..., d, N] < Q:
    golden.rgsw_encrypt layout (rows j < d add mg to the a slot, rows d+j
    to the b slot).  A, E [..., 2d, N] -> [..., 2d, out=2, N] mod Q."""
    Q = p.Q
    Bv = modmath.mod_q(negacyclic_by_ternary(A, z, Q) + E + 2 * Q, Q)
    zero = torch.zeros_like(mg)
    a_slot = modmath.mod_q(A + torch.cat([mg, zero], dim=-2), Q)
    b_slot = modmath.mod_q(Bv + torch.cat([zero, mg], dim=-2), Q)
    return torch.stack([a_slot, b_slot], dim=-2)


def refresh_keys(params: BinFHEParams, s, z, A, E) -> torch.Tensor:
    """GINX refresh keys brk int32 [n, part=2, 2d, out=2, N] mod Q:
    RGSW(s == 1) and RGSW(s == -1); the message is a scalar, so only
    coefficient 0 carries the gadget term."""
    p = params
    m = torch.stack([s == 1, s == -1], dim=1).to(torch.int32)  # [n, 2]
    mg = m[:, :, None] * _gadget(p, A.device)[None, None, :]  # [n, 2, d]
    coeff0 = torch.zeros(p.N, dtype=torch.int32, device=A.device)
    coeff0[0] = 1
    return _rgsw_rows(p, z, A, E, mg[..., None] * coeff0)


def ap_refresh_keys(params: BinFHEParams, s, z, A, E, values=(1,)) -> torch.Tensor:
    """AP refresh keys int32 [n*d_r*len(values), 2d, out=2, N] mod Q: step
    key (i, j, v), v = values[k], at (i*d_r + j)*len(values) + k holds
    RGSW(X^c) with c = (v * B_r**j * s_i) mod 2N (golden.bootstrap_keygen),
    the monomial ±1 at c mod N (negative when c >= N).  The binary base
    keeps v = 1 only (v = 0 is the identity), a generic base every v in
    0 .. B_r-1.  The gadget term is formed without the int32-overflowing
    product (Q-1)*g."""
    p = params
    Q, N = p.Q, p.N
    powers = torch.tensor([pow(p.B_r, j, 2 * N) for j in range(p.d_r)], dtype=torch.int64,
                          device=s.device)
    vals = torch.tensor(list(values), dtype=torch.int64, device=s.device)
    c = s[:, None, None].to(torch.int64) * powers[None, :, None] * vals[None, None, :]
    c = (c % (2 * N)).reshape(-1)  # floor mod: s_i = -1 lands in [N, 2N)
    at_c = torch.arange(N, device=s.device)[None, :] == (c % N)[:, None]  # [steps, N]
    pos = (at_c & (c < N)[:, None])[:, None, :]
    neg = (at_c & (c >= N)[:, None])[:, None, :]
    g = _gadget(p, A.device)[None, :, None]  # [1, d, 1]
    mg = pos * g + neg * (Q - g)  # [steps, d, N], < Q
    return _rgsw_rows(p, z, A, E, mg.to(torch.int32))


GINX_LAYOUTS = ("rev", "rev2")


def _check_layout(layout: str) -> None:
    if layout not in GINX_LAYOUTS:
        raise ValueError(f"unknown GINX key layout {layout!r}: want one of {GINX_LAYOUTS}")


def assemble(params: BinFHEParams, s, z, A, E, Aks, Eks, layout: str = "rev") -> keys_mod.BootKeys:
    """Deterministic GINX key assembly from the sampled material, with the
    refresh keys expanded into ``layout`` ("rev" or "rev2")."""
    _check_layout(layout)
    p = params
    build = keys_mod.build_rev if layout == "rev" else keys_mod.build_rev2
    return keys_mod.BootKeys(
        params=p,
        ksk=keyswitch_key(p, s, z, Aks, Eks),
        tv_table=keys_mod.tv_table(p, device=A.device),
        method=BinFHEMethod.GINX,
        **{layout: build(refresh_keys(p, s, z, A, E), p.Q)},
    )


def assemble_ap(params: BinFHEParams, s, z, A, E, Aks, Eks) -> keys_mod.BootKeys:
    """Deterministic binary-base AP key assembly from the sampled material."""
    p = params
    return keys_mod.BootKeys(
        params=p,
        ksk=keyswitch_key(p, s, z, Aks, Eks),
        tv_table=keys_mod.tv_table(p, device=A.device),
        method=BinFHEMethod.AP,
        ap_ext=keys_mod.ap_ext_planes(ap_refresh_keys(p, s, z, A, E), p.Q),
    )


def _secret_key(params: BinFHEParams, s: torch.Tensor) -> golden.LWESecretKey:
    return golden.LWESecretKey(s=s.cpu().numpy().astype(np.int64), params=params)


def device_keygen(params: BinFHEParams, seed_words=None, device="cuda", layout: str = "rev"):
    """Generate GINX keys on ``device`` (the card unless the caller asks
    for the CPU) in ``layout``: "rev" (the default, as in the JAX package)
    or "rev2", each K-major on the card and row-major on the CPU (keys.py).  Returns (sk_host, keys): the LWE secret comes back to the
    host (n int8 values) for host-side encryption and decryption; the keys
    stay on the device."""
    _check_layout(layout)
    if params.N % keys_mod.TILE:
        raise ValueError(f"{layout} keys need N % 128 == 0")
    draws = sample(params, seed_generators(seed_words, device))
    return _secret_key(params, draws[0]), assemble(params, *draws, layout=layout)


def device_keygen_ap(params: BinFHEParams, seed_words=None, device="cuda"):
    """Generate binary-base AP keys on ``device``; returns (sk_host, keys)
    as ``device_keygen`` does.  The same seed words give the same LWE
    secret and key-switch key as ``device_keygen``."""
    if params.B_r != 2:
        raise ValueError(f"device AP keygen needs the binary rotation base, got B_r={params.B_r}")
    if params.N % keys_mod.TILE:
        raise ValueError("AP keys need N % 128 == 0")
    draws = sample_ap(params, seed_generators(seed_words, device))
    return _secret_key(params, draws[0]), assemble_ap(params, *draws)
