"""GINX bootstrap key generation on the device (counterpart of
oece_tpu.fhe.devkeygen, layout "rev2").

Split in two so the arithmetic can be checked bit for bit against the JAX
package: ``sample`` draws the secrets, masks and noise from a
``torch.Generator`` (torch's generator is not threefry, so its draws differ
from JAX's); ``assemble`` is a deterministic function of those draws and,
fed JAX's own draws, returns JAX's rev2 and ksk exactly.

The two plain products of keygen run in float64, which is exact here:
the negacyclic product A ⊛ z has |sum| <= N*Q < 2**37 and the key-switch
mask product |sum| <= n*Q_ks < 2**24, both below 2**53.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from oece_tpu.fhe import golden
from oece_tpu.fhe.params import BinFHEParams

from . import keys as keys_mod
from . import modmath


def seed_generator(seed_words: Optional[np.ndarray], device) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from 8 uint32 words (or from
    OS entropy when ``seed_words`` is None, the production default).  The
    generator takes a 64-bit seed: the words are folded with SHA-256."""
    words = (
        np.frombuffer(os.urandom(32), dtype=np.uint32)
        if seed_words is None
        else np.asarray(seed_words, dtype=np.uint32).reshape(8)
    )
    digest = hashlib.sha256(words.tobytes()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little"))
    return gen


def _gauss(sigma: float, shape, gen: torch.Generator) -> torch.Tensor:
    """Rounded continuous Gaussian (golden.gauss semantics)."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return torch.round(sigma * x).to(torch.int32)


def sample(params: BinFHEParams, gen: torch.Generator):
    """Draw (s, z, A, E, Aks, Eks), int32 tensors on the generator's device:
    s [n] and z [N] ternary; A [n, 2, 2d, N] uniform mod Q and E Gaussian of
    the same shape (refresh keys); Aks [N*d_ks, n] uniform mod Q_ks and Eks
    [N*d_ks] Gaussian (key-switch key)."""
    p = params
    d = p.d_g_used
    dev = gen.device

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    s = randint(-1, 2, (p.n,))
    z = randint(-1, 2, (p.N,))
    A = randint(0, p.Q, (p.n, 2, 2 * d, p.N))
    E = _gauss(p.sigma, (p.n, 2, 2 * d, p.N), gen)
    Aks = randint(0, p.Q_ks, (p.N * p.d_ks, p.n))
    Eks = _gauss(p.sigma, (p.N * p.d_ks,), gen)
    return s, z, A, E, Aks, Eks


def negacyclic_by_ternary(A: torch.Tensor, z: torch.Tensor, Q: int) -> torch.Tensor:
    """A [..., N] mod Q ⊛ z [N] ternary -> [..., N] in [0, Q)."""
    N = A.shape[-1]
    i = torch.arange(N, device=A.device)
    idx = (i[None, :] - i[:, None]) % (2 * N)  # [i, k] -> (k - i) mod 2N
    Zm = torch.cat([z, -z]).to(torch.float64)[idx]  # [N, N]
    prod = A.reshape(-1, N).to(torch.float64) @ Zm
    return (prod.to(torch.int64) % Q).to(torch.int32).reshape(A.shape)


def _keyswitch_key(params: BinFHEParams, s, z, Aks, Eks) -> torch.Tensor:
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


def refresh_keys(params: BinFHEParams, s, z, A, E) -> torch.Tensor:
    """GINX refresh keys brk int32 [n, part=2, 2d, out=2, N] mod Q:
    RGSW(s == 1) and RGSW(s == -1), golden.rgsw_encrypt row layout (rows
    j < d add m*g to the a slot, rows d+j to the b slot)."""
    p = params
    Q, N, d = p.Q, p.N, p.d_g_used
    Bv = modmath.mod_q(negacyclic_by_ternary(A, z, Q) + E + 2 * Q, Q)
    m = torch.stack([s == 1, s == -1], dim=1).to(torch.int32)  # [n, 2]
    g = torch.tensor(
        [(pow(p.B_g, j, Q) << p.g_shift) % Q for j in range(d)],
        dtype=torch.int32, device=A.device,
    )
    mg = m[:, :, None] * g[None, None, :]  # [n, 2, d]
    zero = torch.zeros_like(mg)
    coeff0 = torch.zeros(N, dtype=torch.int32, device=A.device)
    coeff0[0] = 1  # the message is a scalar
    add_a = torch.cat([mg, zero], dim=2)[..., None] * coeff0
    add_b = torch.cat([zero, mg], dim=2)[..., None] * coeff0
    a_slot = modmath.mod_q(A + add_a, Q)
    b_slot = modmath.mod_q(Bv + add_b, Q)
    return torch.stack([a_slot, b_slot], dim=3)


def assemble(params: BinFHEParams, s, z, A, E, Aks, Eks) -> keys_mod.BootKeys:
    """Deterministic key assembly from the sampled material."""
    p = params
    brk = refresh_keys(p, s, z, A, E)
    return keys_mod.BootKeys(
        params=p,
        rev2=keys_mod.build_rev2(brk, p.Q),
        ksk=_keyswitch_key(p, s, z, Aks, Eks),
        tv_table=keys_mod.tv_table(p, device=A.device),
    )


def device_keygen(params: BinFHEParams, seed_words=None, device="cpu"):
    """Generate GINX rev2 keys on ``device``.  Returns (sk_host, keys): the
    LWE secret comes back to the host (n int8 values) for host-side
    encryption and decryption; the keys stay on the device."""
    if params.N % keys_mod.TILE:
        raise ValueError("rev2 keys need N % 128 == 0")
    gen = seed_generator(seed_words, device)
    s, z, A, E, Aks, Eks = sample(params, gen)
    bkeys = assemble(params, s, z, A, E, Aks, Eks)
    sk = golden.LWESecretKey(s=s.cpu().numpy().astype(np.int64), params=params)
    return sk, bkeys
