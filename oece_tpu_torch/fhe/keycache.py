"""Disk cache of the port's host bootstrap keys (counterpart of
oece_tpu.fhe.keycache), keyed by parameter set, method and seed.

Golden host keygen (``hostkeygen.bootstrap_keygen``: golden's draws from
``np.random.default_rng(seed)``, the LWE secret first) is what a seeded
``BinFHEContext`` or ``Circuit(OECE_HOST_KEYGEN=1)`` makes.  The cache
keeps its result as the port packs it: the secret, the key-switch limbs,
the test vectors and ginx_ext or ap_ext, in an ``.npz`` under
``$OECE_KEY_CACHE/oece_tpu_torch`` (default ``.keycache/oece_tpu_torch`` in
the checkout, gitignored): a directory of the port's own, so it never reads
or overwrites the JAX package's cached golden keys.  The file's tag hashes
every parameter field, and a loaded key must have the shapes its
parameters give.  Parity note: the reference regenerates keys every run
(circuit.cpp:45-98); the cache is a developer and benchmark convenience,
and secret keys on disk are not for production use.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional

import numpy as np
import torch

from . import golden, hostkeygen
from .keys import BootKeys
from .params import BinFHEMethod, BinFHEParams


def cache_dir() -> str:
    root = os.environ.get(
        "OECE_KEY_CACHE",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".keycache"),
    )
    return os.path.join(root, "oece_tpu_torch")


def _check_shapes(sk, keys: BootKeys, p: BinFHEParams, method: BinFHEMethod, path: str) -> None:
    """Refuse a loaded key whose shapes are not its parameters'."""
    R = 2 * p.d_g_used
    want = {"s": (p.n,), "ksk": (p.N * p.d_ks, p.n + 1, 2), "tv_table": (6, p.N)}
    if method == BinFHEMethod.GINX:
        want["ginx_ext"] = (p.n, R, 16, 2 * p.N)
    else:
        steps = p.n * p.d_r * (1 if p.B_r == 2 else p.B_r)
        want["ap_ext"] = (steps, R, 8, 2 * p.N)
    got = {"s": tuple(np.shape(sk.s))}
    got.update({k: tuple(getattr(keys, k).shape) for k in want if k != "s"})
    if got != want:
        raise ValueError(f"{path}: cached key shapes {got}, want {want}")


def key_path(params: BinFHEParams, method: BinFHEMethod, seed: int) -> str:
    phash = hashlib.sha256(repr(dataclasses.astuple(params)).encode()).hexdigest()[:12]
    return os.path.join(cache_dir(), f"bk_{params.name}_{method.value}_{seed}_{phash}.npz")


def load_or_generate(
    params: BinFHEParams, method: BinFHEMethod, seed: int, device="cuda",
    rng: Optional[np.random.Generator] = None,
):
    """(sk, keys on ``device``), read from the cache or generated from
    ``rng`` (default ``np.random.default_rng(seed)``) and written to it."""
    path = key_path(params, method, seed)
    field = "ginx_ext" if method == BinFHEMethod.GINX else "ap_ext"
    if os.path.exists(path):
        with np.load(path) as z:
            sk = golden.LWESecretKey(s=z["s"], params=params)
            keys = BootKeys(
                params=params, method=method,
                ksk=torch.from_numpy(z["ksk"]).to(device),
                tv_table=torch.from_numpy(z["tv_table"]).to(device),
                **{field: torch.from_numpy(z[field]).to(device)},
            )
        _check_shapes(sk, keys, params, method, path)
        return sk, keys
    rng = rng or np.random.default_rng(seed)
    sk = golden.lwe_keygen(params, rng)
    keys = hostkeygen.bootstrap_keygen(params, sk, rng, method, device)
    os.makedirs(cache_dir(), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, s=np.asarray(sk.s), ksk=keys.ksk.cpu().numpy(),
                 tv_table=keys.tv_table.cpu().numpy(), **{field: getattr(keys, field).cpu().numpy()})
    os.replace(tmp, path)
    return sk, keys
