"""Host-generated bootstrap keys: golden.bootstrap_keygen's draws, with the
ring products on the device.

``golden.bootstrap_keygen`` is the key generation of the JAX package's
``BinFHEContext.BTKeyGen`` and of ``Circuit`` under ``OECE_HOST_KEYGEN=1``:
every number comes from one ``np.random.Generator``, and one seed gives
the same keys on both packages.  Its cost is the O(N^2) NumPy product
a ⊛ z of every RGSW row (1,004 RGSW keys, about 92 s at STD128_OPT on one
CPU core).  ``bootstrap_keygen`` here takes the same draws from the
generator in the same order (``sample``), so the generator ends in the
same state, and computes the products on the device in one exact float64
product (``devkeygen.negacyclic_by_ternary``: z is ternary or binary, so
|sum| <= N*Q < 2**53).  The result is golden's keys packed as
``keys.pack_bootstrap_key`` packs them, bit for bit.

Draw order (golden.bootstrap_keygen): the ring secret z [N]; the key-switch
key, per row (i, j) a [n] uniform mod Q_ks then one Gaussian; then each
RGSW key's 2*d_g_used rows, each a [N] uniform mod Q then e [N] Gaussian,
for GINX every RGSW(s+_i) then every RGSW(s-_i), for AP every (i, j, v).
The binary base (B_r = 2) keeps only the v = 1 AP keys (v = 0 is the
identity, and kernel #13 reads v = 1 only); a generic base keeps all B_r
of each (i, j), v = 0 included, in golden's order.
"""

from __future__ import annotations

import numpy as np
import torch

from . import devkeygen, golden
from . import keys as keys_mod
from .params import BinFHEMethod, BinFHEParams


def _rgsw_draws(p: BinFHEParams, rng: np.random.Generator):
    """One RGSW key's draws (golden.rgsw_encrypt): per row, a [N] uniform
    mod Q, then e [N] Gaussian.  Returns A, E [2d, N]."""
    rows = [(rng.integers(0, p.Q, (p.N,), dtype=np.int64), golden.gauss(rng, p.sigma, (p.N,)))
            for _ in range(2 * p.d_g_used)]
    return np.stack([a for a, _ in rows]), np.stack([e for _, e in rows])


def sample(params: BinFHEParams, rng: np.random.Generator, method: BinFHEMethod):
    """golden.bootstrap_keygen's draws: (z [N], Aks [N*d_ks, n], Eks
    [N*d_ks], A [keys, 2d, N], E [keys, 2d, N]), int64 NumPy.  GINX keys
    are ordered (part, i), AP keys (i, j) with v = 1 for B_r = 2, else
    (i, j, v) with every v."""
    p = params
    z = golden.ring_secret(p, rng)
    rows = p.N * p.d_ks
    Aks = np.empty((rows, p.n), dtype=np.int64)
    Eks = np.empty(rows, dtype=np.int64)
    for r in range(rows):
        Aks[r] = rng.integers(0, p.Q_ks, (p.n,), dtype=np.int64)
        Eks[r] = int(golden.gauss(rng, p.sigma, ()))
    if method == BinFHEMethod.GINX:
        keys = [_rgsw_draws(p, rng) for _ in range(2 * p.n)]
    elif p.B_r == 2:  # every (i, j, v); keep v = 1
        keys = [[_rgsw_draws(p, rng) for _ in range(p.B_r)][1] for _ in range(p.n * p.d_r)]
    else:
        keys = [_rgsw_draws(p, rng) for _ in range(p.n * p.d_r * p.B_r)]
    A = np.stack([a for a, _ in keys])
    E = np.stack([e for _, e in keys])
    return z, Aks, Eks, A, E


def bootstrap_keygen(
    params: BinFHEParams,
    sk: golden.LWESecretKey,
    rng: np.random.Generator,
    method: BinFHEMethod = BinFHEMethod.GINX,
    device="cuda",
) -> keys_mod.BootKeys:
    """golden.bootstrap_keygen + keys.pack_bootstrap_key, with the products
    on ``device``: GINX keys as ginx_ext, AP keys as ap_ext (v = 1 only
    for B_r = 2, every v for a generic base)."""
    p = params

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)

    z, Aks, Eks, A, E = (dev(x) for x in sample(p, rng, method))
    s = dev(sk.s)
    common = dict(
        params=p, method=method,
        ksk=devkeygen.keyswitch_key(p, s, z, Aks, Eks),
        tv_table=keys_mod.tv_table(p, device),
    )
    if method == BinFHEMethod.GINX:
        # [part, n, 2d, N] in draw order -> [n, part, 2d, N]
        A = A.reshape(2, p.n, *A.shape[1:]).transpose(0, 1).contiguous()
        E = E.reshape(2, p.n, *E.shape[1:]).transpose(0, 1).contiguous()
        brk = devkeygen.refresh_keys(p, s, z, A, E)
        return keys_mod.BootKeys(**common, ginx_ext=keys_mod.ginx_ext_planes(brk, p.Q))
    values = (1,) if p.B_r == 2 else range(p.B_r)
    rows = devkeygen.ap_refresh_keys(p, s, z, A, E, values)
    return keys_mod.BootKeys(**common, ap_ext=keys_mod.ap_ext_planes(rows, p.Q))
