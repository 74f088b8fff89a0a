"""#7 of the port's kernel-level API, ``negacyclic.build_rev_conj``, on the
CPU, bit for bit (tolerance 0): against ``pk.build_rev_pallas`` in
interpret mode on the same key's byte-phase windows, and, with the
conjugated basis undone, against the true-order block ``keys.rev_block``.
Random keys are asymmetric, so a row or column permutation taken
backwards fails (checked).  Also chip_smoke.py's library form of #7, one
``torch.take`` through a fixed index.  The CUDA kernel is held to the same
plain twin on the card by chip_smoke.py (phase neg-kernel).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import pallas_kernels as pk
from oece_tpu_torch.fhe import keys
from oece_tpu_torch.fhe import negacyclic as ng

T = 128
ROOT = Path(__file__).resolve().parents[1]
LANE = np.arange(T)
TRUEIDX = 4 * (LANE % 32) + LANE // 32  # lane c of a conjugated tile holds true index TRUEIDX[c]


def _key(N, R, M, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, (R, M, 2 * N)).astype(np.int8)


def _tiles(block, M, idx):
    """Row u and column t of every T x T tile of block taken from idx[u],
    idx[t]."""
    return block.reshape(-1, T, M, T)[:, idx][..., idx].reshape(block.shape)


@pytest.mark.parametrize("N,R,M", [(128, 4, 16), (256, 4, 16), (256, 8, 8)])
def test_build_rev_conj_matches_pallas(N, R, M):
    ext = _key(N, R, M, N + R + M)
    want = np.asarray(pk.build_rev_pallas(
        jnp.asarray(pk.pack_keys_for_pallas(ext.reshape(R * M, 2 * N))), R, M, interpret=True,
    ))
    got = ng.build_rev_conj(torch.from_numpy(ext)).numpy()
    assert got.dtype == np.int8 and got.shape == ((2 * N // T - 1) * R * T, M * T)
    np.testing.assert_array_equal(got, want)
    true = keys.rev_block(torch.from_numpy(ext), keys.rev_index(N, "cpu")).numpy()
    inverse = np.argsort(TRUEIDX)
    np.testing.assert_array_equal(_tiles(got, M, inverse), true)
    np.testing.assert_array_equal(_tiles(true, M, TRUEIDX), got)
    assert not np.array_equal(_tiles(true, M, inverse), got)  # the permutation taken backwards


def test_build_rev_conj_is_one_take():
    """chip_smoke.py's library form of #7: one torch.take of ext through
    a fixed index gives the conjugated block."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for N, R in [(128, 4), (256, 8)]:
        ext = torch.from_numpy(_key(N, R, 16, R))
        assert torch.equal(torch.take(ext, cs.conj_take_index(N, R, "cpu")), ng.build_rev_conj(ext))
