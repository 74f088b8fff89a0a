"""The key material, drawn by the benchmark from its seed on the device.

The LWE secret, the ring secret, the masks and the noise of the refresh
and key-switching keys come from one ``torch.Generator`` seeded from
``--seed``, in a few large calls.  The benchmark keeps the LWE secret for
its reference's decryption and hands all of it to the program's key
assembly, so the reference never takes a secret from the program.

Distributions (FHEW/TFHE, OpenFHE binfhe): ternary secrets, masks uniform
mod Q (refresh keys) and mod Q_ks (key switching), noise the rounded
Gaussian of standard deviation sigma.  Shapes are those of the program's
assembly: GINX A, E [n, 2, 2d, N] (an RGSW key for s_i = 1 and one for
s_i = -1), binary-base AP A, E [n*d_r, 2d, N] (one RGSW key per rotation
digit); the key-switching key [N*d_ks, n] and [N*d_ks].
"""

from __future__ import annotations

import math

import torch


def draw(cfg: dict, seed: int, device) -> dict:
    """{s, z, A, E, Aks, Eks}, int32 tensors on ``device``, from ``seed``."""
    p = cfg["params"]
    n, N, Q, Q_ks, sigma = p["n"], p["N"], p["Q"], p["Q_ks"], p["sigma"]
    d = gadget_digits(p)
    d_ks = math.ceil(math.log2(Q_ks) / math.log2(p["B_ks"]))
    if cfg["method"] == "AP":
        d_r = math.ceil(math.log2(2 * N) / math.log2(p["B_r"]))
        key_shape = (n * d_r, 2 * d, N)
    else:
        key_shape = (n, 2, 2 * d, N)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    def gauss(shape):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return torch.round(sigma * x).to(torch.int32)

    return dict(
        s=uniform(-1, 2, (n,)), z=uniform(-1, 2, (N,)),
        A=uniform(0, Q, key_shape), E=gauss(key_shape),
        Aks=uniform(0, Q_ks, (N * d_ks, n)), Eks=gauss((N * d_ks,)),
    )


def gadget_digits(p: dict) -> int:
    """Gadget digits in use: d_g_eff when the decomposition is approximate,
    else enough base-B_g digits to cover Q."""
    return p["d_g_eff"] or math.ceil(math.log2(p["Q"]) / math.log2(p["B_g"]))
