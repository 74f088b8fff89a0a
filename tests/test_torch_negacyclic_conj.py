"""#7 of the port's kernel-level API, ``negacyclic.build_rev_conj``, on the
CPU, bit for bit (tolerance 0): against ``pk.build_rev_pallas`` in
interpret mode on the same key's byte-phase windows (compiled with
``test_torch_std.jax_fast``), and, with the conjugated basis undone,
against the true-order block ``keys.rev_block``.  Random keys are
asymmetric, so a row or column permutation taken backwards fails
(checked).  The card's build kernel (csrc/int8_mm.cuh: rev_build_kernel,
#7 and, with conj = 0, #1 alone) is modelled store by store: each block's
staged span (``negacyclic.build_span_index``), each thread's window of it
(``build_window_start``) and its four 16-byte stores, transposed 4 x 4 by
the kernel's byte permutes (``transpose4x4``) in the conjugated basis,
rebuild both blocks.  Also chip_smoke.py's library form of #7, one
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
from test_torch_std import jax_fast, one_torch_thread  # noqa: F401

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


def _build_by_spans(ext, conj):
    """rev_build_kernel store by store, every block (m, r, d') at once:
    each stages its span (16 loads of 16 bytes, none wrapping); thread
    (u', h) stores at columns 32g + 16h the span bytes a + 32g .. +15, or
    in the conjugated basis byte g of the words W_i = span[a + 4i .. a +
    4i + 3], i = 0 .. 15.  Every byte of the block is written once."""
    R, M, two_n = ext.shape
    N, nt = two_n // 2, two_n // 2 // T
    idx = ng.build_span_index(N)  # [d', 256]
    groups = idx.view(-1, 16, 16)
    assert (groups[..., 0] % 16 == 0).all() and (groups.diff(dim=-1) == 1).all()
    span = ext[:, :, idx]  # [r, m, d', 256]
    up, h = torch.arange(T)[:, None], torch.arange(2)[None, :]
    a = ng.build_window_start(up, h, conj)  # [u', h]
    if conj:  # [.., u', h, g, i, byte] -> stores j: column 32j + 16h + 4g + byte
        W = span[..., a[..., None] + torch.arange(64)].view(R, M, 2 * nt - 1, T, 2, 4, 4, 4)
        seg = ng.transpose4x4(W).permute(0, 1, 2, 3, 6, 4, 5, 7)
    else:  # [.., u', h, g, 16] -> column 32g + 16h + byte
        seg = span[..., a[..., None, None] + 32 * torch.arange(4)[:, None] + torch.arange(16)]
        seg = seg.transpose(-3, -2)
    cols = 32 * torch.arange(4)[:, None, None] + 16 * torch.arange(2)[None, :, None] + torch.arange(16)
    assert torch.equal(cols.reshape(-1).sort().values, torch.arange(T))  # each column once
    seg = seg.reshape(R, M, 2 * nt - 1, T, T)  # [r, m, d', u', column]
    return seg.permute(2, 0, 3, 1, 4).reshape((2 * nt - 1) * R * T, M * T)


@pytest.mark.parametrize("N,R,M", [(128, 4, 16), (256, 4, 16), (256, 8, 8)])
def test_build_rev_conj_matches_pallas(N, R, M):
    """#7 == the interpret-mode Pallas build == the kernel's stores from
    staged spans; with the basis undone, and with conj = 0 (#1 alone),
    keys.rev_block."""
    ext = _key(N, R, M, N + R + M)
    build = jax_fast(lambda w: pk.build_rev_pallas(w, R, M, interpret=True))
    want = np.asarray(build(jnp.asarray(pk.pack_keys_for_pallas(ext.reshape(R * M, 2 * N)))))
    got = ng.build_rev_conj(torch.from_numpy(ext)).numpy()
    assert got.dtype == np.int8 and got.shape == ((2 * N // T - 1) * R * T, M * T)
    np.testing.assert_array_equal(got, want)
    true = keys.rev_block(torch.from_numpy(ext), keys.rev_index(N, "cpu")).numpy()
    inverse = np.argsort(TRUEIDX)
    np.testing.assert_array_equal(_tiles(got, M, inverse), true)
    np.testing.assert_array_equal(_tiles(true, M, TRUEIDX), got)
    assert not np.array_equal(_tiles(true, M, inverse), got)  # the permutation taken backwards
    np.testing.assert_array_equal(_build_by_spans(torch.from_numpy(ext), True).numpy(), want)
    np.testing.assert_array_equal(_build_by_spans(torch.from_numpy(ext), False).numpy(), true)


def test_build_rev_conj_is_one_take():
    """chip_smoke.py's library form of #7: one torch.take of ext through
    a fixed index gives the conjugated block."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for N, R in [(128, 4), (256, 8)]:
        ext = torch.from_numpy(_key(N, R, 16, R))
        assert torch.equal(torch.take(ext, cs.conj_take_index(N, R, "cpu")), ng.build_rev_conj(ext))
