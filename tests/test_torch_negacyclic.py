"""The port's kernel-level negacyclic products (oece_tpu_torch.fhe.negacyclic)
on the CPU, bit for bit (tolerance 0), against the JAX package's Pallas
kernels in interpret mode, with inputs drawn by numpy from a seed over the
full int8 range:

  * #5: ``negacyclic_matmul`` against ``pk.negacyclic_matmul_pallas`` and
    the port's reference against ``pk.negacyclic_matmul_reference`` (the
    cases of tests/test_pallas.py, plus R = 4);
  * #3: ``diag_matmul`` against ``pk.diag_matmul_pallas`` fed the same
    block in the TPU's layout (forward diagonals, plane-permuted columns),
    its output un-permuted; ``negacyclic_matmul_split`` against
    ``pk.negacyclic_matmul_split`` with the batch chunked raggedly on the
    JAX side;
  * chip_smoke.py's library form of #3 (one ``torch._int_mm`` against the
    materialized negacyclic matrix), empty batches, the wrappers' shape,
    type and device errors and their launch counters.

The JAX kernels of #5 and the split pipeline compile with
``test_torch_std.jax_fast``.

#2 and #6 are in tests/test_torch_negacyclic_window.py, #7 in
tests/test_torch_negacyclic_conj.py.  The CUDA kernels are held to the same
plain twins on the card by chip_smoke.py (phase neg-kernel).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import pallas_kernels as pk
from oece_tpu_torch.fhe import negacyclic as ng
from oece_tpu_torch.fhe import rev, rot
from oece_tpu_torch.fhe.params import Q27
from test_torch_std import _undo_planes, jax_fast, one_torch_thread  # noqa: F401

T = 128
ROOT = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(seed, B, N, R, M):
    """digits int8 [R, B, N] and a key int8 [R*M, 2N], the full int8 range."""
    rng = np.random.default_rng(seed)
    digs = rng.integers(-128, 128, (R, B, N)).astype(np.int8)
    kx = rng.integers(-128, 128, (R * M, 2 * N)).astype(np.int8)
    return digs, kx


def _to_planes(block, R, M):
    """The port's block [(2nt-1)*R*T, M*T] -> the TPU's dense_all
    [2nt-1, R*T, M*T]: forward diagonal order, column 32j + w holding
    true column 4w + j."""
    dense = block.reshape(-1, R * T, M, T // 4, 4)[::-1]
    return np.ascontiguousarray(np.swapaxes(dense, -1, -2).reshape(-1, R * T, M * T))


@pytest.mark.parametrize("B,N,R", [(8, 128, 8), (4, 256, 8), (8, 128, 4)])
def test_negacyclic_matmul_matches_pallas(B, N, R):
    """#5 == the interpret-mode Pallas kernel == the reference contraction."""
    M = 16
    digs, kx = _inputs(B + N + R, B, N, R, M)
    dt = pk.pack_digits_for_pallas(jnp.asarray(digs))
    pallas = jax_fast(lambda d, k: pk.negacyclic_matmul_pallas(d, k, R, interpret=True))
    want = np.asarray(pallas(dt, jnp.asarray(pk.pack_keys_for_pallas(kx))))
    ref = np.asarray(pk.negacyclic_matmul_reference(jnp.asarray(digs), jnp.asarray(kx)))
    dig = ng.pack_digits_rows(_t(digs))
    np.testing.assert_array_equal(dig.numpy(), np.asarray(pk.pack_digits_rows(jnp.asarray(digs))))
    got = ng.negacyclic_matmul(dig, _t(kx.reshape(R, M, 2 * N)))
    assert got.dtype == torch.int32 and got.shape == (B, M, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ng.negacyclic_matmul_reference(_t(digs), _t(kx)).numpy(), ref)
    np.testing.assert_array_equal(ref, want)


@pytest.mark.parametrize("B,N,R,M", [(8, 128, 8, 16), (5, 256, 4, 8)])
def test_diag_matmul_matches_pallas(B, N, R, M):
    """#3 on the port's block == the TPU's #3 on that block in its own
    layout, un-permuted; == #5 on the key the block was built from."""
    digs, kx = _inputs(B * M, B, N, R, M)
    ext = _t(kx.reshape(R, M, 2 * N))
    block = ng.build_diagonals(ext)
    dig = ng.pack_digits_rows(_t(digs))
    dt = pk.pack_digits_for_pallas(jnp.asarray(digs))
    raw = pk.diag_matmul_pallas(dt, jnp.asarray(_to_planes(block.numpy(), R, M)), R, interpret=True)
    got = ng.diag_matmul(dig, block, R)
    np.testing.assert_array_equal(got.numpy(), _undo_planes(np.asarray(raw)))
    np.testing.assert_array_equal(got.numpy(), ng.negacyclic_matmul(dig, ext).numpy())


@pytest.mark.parametrize("B,N,R,max_b", [(13, 256, 4, 8)])
def test_negacyclic_matmul_split_matches_pallas(B, N, R, max_b):
    """#1 then #3 == pk.negacyclic_matmul_split on the key's byte-phase
    windows, the JAX side chunking B by max_b (13 = 8 + 5)."""
    M = 16
    digs, kx = _inputs(B + max_b, B, N, R, M)
    dt = pk.pack_digits_for_pallas(jnp.asarray(digs))
    split = jax_fast(lambda d, k: pk.negacyclic_matmul_split(d, k, R, max_b=max_b, interpret=True))
    want = np.asarray(split(dt, jnp.asarray(pk.pack_keys_for_pallas(kx))))
    # the port's digits from JAX's tiled layout, as the tests of fhe/std.py take them
    dig = _t(np.array(dt).transpose(1, 0, 2).reshape(B, -1))
    got = ng.negacyclic_matmul_split(dig, _t(kx.reshape(R, M, 2 * N)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_raw_product_combines_to_the_window_product():
    """rot.tile_products == combine_planes(tile_products_raw): #3's limb
    sums, Horner-combined, are #2's output."""
    digs, kx = _inputs(7, 6, 256, 4, 16)
    dig, ext = ng.pack_digits_rows(_t(digs)), _t(kx.reshape(4, 16, 512))
    block = ng.build_diagonals(ext)
    raw = ng.diag_matmul(dig, block, 4)
    np.testing.assert_array_equal(rot.combine_planes(raw, Q27).numpy(),
                                  ng.window_matmul(dig, block, 4, Q27).numpy())


def test_library_form_is_one_int_mm():
    """chip_smoke.py's library yardstick for #3 and #5: digits times the
    materialized negacyclic matrix, one torch._int_mm, is #3's product."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for B, N, R, M in [(20, 128, 8, 16), (24, 256, 4, 8)]:
        digs, kx = _inputs(B, B, N, R, M)
        dig, ext = ng.pack_digits_rows(_t(digs)), _t(kx.reshape(R, M, 2 * N))
        full = cs.negacyclic_matrix(ext)
        assert full.shape == (N * R, M * N)
        got = torch._int_mm(dig, full).view(B, M, N)
        assert torch.equal(got, ng.negacyclic_matmul(dig, ext))


def test_empty_batch():
    digs, kx = _inputs(1, 0, 128, 4, 16)
    dig, ext = ng.pack_digits_rows(_t(digs)), _t(kx.reshape(4, 16, 256))
    assert ng.negacyclic_matmul(dig, ext).shape == (0, 16, 128)
    assert ng.negacyclic_matmul_split(dig, ext).shape == (0, 16, 128)
    assert ng.negacyclic_matmul_window(dig, ext, Q27).shape == (0, 4, 128)


def test_cpu_calls_count_as_plain():
    """On CPU tensors every wrapper runs its plain twin once per call and
    launches nothing; the pipelines count their build and their matmul;
    #2 and #6 count under their own names only, not as fhe/rev.py's #8
    and #10."""
    digs, kx = _inputs(3, 3, 128, 4, 16)
    dig, ext = ng.pack_digits_rows(_t(digs)), _t(kx.reshape(4, 16, 256))
    P = torch.zeros((3, 2, 2, 128), dtype=torch.int32)
    acc = torch.zeros((3, 2, 128), dtype=torch.int32)
    amt = torch.zeros((3, 2), dtype=torch.int32)
    launches, plain, rev_plain = dict(ng.LAUNCHES), dict(ng.PLAIN_LAUNCHES), rev.PLAIN_LAUNCHES
    block = ng.build_diagonals(ext)
    ng.build_rev_conj(ext)
    ng.diag_matmul(dig, block, 4)
    ng.negacyclic_matmul(dig, ext)
    ng.window_matmul(dig, block, 4, Q27)
    ng.cmux_epilogue(P, acc, amt, Q27)
    ng.negacyclic_matmul_split(dig, ext)
    ng.negacyclic_matmul_window(dig, ext, Q27)
    assert ng.LAUNCHES == launches
    assert {k: ng.PLAIN_LAUNCHES[k] - plain[k] for k in ng.KERNELS} == {
        "build_diagonals": 3, "diag_matmul": 2, "negacyclic_matmul": 1, "window_matmul": 2,
        "cmux_epilogue": 1, "build_rev_conj": 1,
    }
    assert rev.PLAIN_LAUNCHES == rev_plain


class _FakeLib:
    """The kernel library's entry points of #2 and #10, returning ``rc``."""

    def __init__(self, rc: int):
        self.rc, self.calls = rc, 0

    def _entry(self, *args) -> int:
        self.calls += 1
        return self.rc

    oece_window_matmul = oece_cmux_epilogue_true = _entry

    def oece_error_string(self, rc: int) -> bytes:
        return b"stub failure"


@pytest.mark.parametrize("rc", [0, 7])
def test_card_calls_count_where_they_launch(monkeypatch, rc):
    """#2 and #6 on the card route, with the device check and the kernel
    library stubbed: a launch that returns 0 adds one to the wrapper's own
    count and to no other, a failed launch raises and counts nothing."""
    lib = _FakeLib(rc)
    monkeypatch.setattr(rev, "_on_card", lambda name, *ts: True)
    monkeypatch.setattr(rev, "_aligned", lambda name, *ts: None)
    monkeypatch.setattr(rev, "_stream", lambda t: 0)
    monkeypatch.setattr(rev._build, "load", lambda: lib)
    digs, kx = _inputs(3, 3, 128, 4, 16)
    dig, block = ng.pack_digits_rows(_t(digs)), ng.build_diagonals_plain(_t(kx.reshape(4, 16, 256)))
    P = torch.zeros((3, 2, 2, 128), dtype=torch.int32)
    acc = torch.zeros((3, 2, 128), dtype=torch.int32)
    amt = torch.zeros((3, 2), dtype=torch.int32)
    launches, counts = dict(ng.LAUNCHES), (rev.LAUNCHES, rev.PLAIN_LAUNCHES, dict(ng.PLAIN_LAUNCHES))
    for name, call in (("window_matmul", lambda: ng.window_matmul(dig, block, 4, Q27)),
                       ("cmux_epilogue", lambda: ng.cmux_epilogue(P, acc, amt, Q27))):
        if rc:
            with pytest.raises(RuntimeError, match=f"{name}: CUDA launch failed: stub failure"):
                call()
        else:
            call()
        launches[name] += rc == 0
    assert lib.calls == 2
    assert ng.LAUNCHES == launches
    assert (rev.LAUNCHES, rev.PLAIN_LAUNCHES, ng.PLAIN_LAUNCHES) == counts


def test_wrappers_refuse_bad_input():
    """Shapes, types, devices and layouts the kernels do not take raise
    before anything runs (in place of the TPU-only VMEM guard test)."""
    R, N, B = 4, 128, 3
    nt = N // T
    dig = torch.zeros((B, nt * R * T), dtype=torch.int8)
    ext = torch.zeros((R, 16, 2 * N), dtype=torch.int8)
    block = torch.zeros(((2 * nt - 1) * R * T, 16 * T), dtype=torch.int8)
    counts = (dict(ng.LAUNCHES), dict(ng.PLAIN_LAUNCHES))
    with pytest.raises(ValueError, match="key"):  # M = 12
        ng.negacyclic_matmul(dig, torch.zeros((R, 12, 2 * N), dtype=torch.int8))
    with pytest.raises(ValueError, match="key"):  # 2N not a power of two
        ng.build_diagonals(torch.zeros((R, 16, 3 * T * 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="key"):
        ng.build_rev_conj(ext.to(torch.int32))
    with pytest.raises(ValueError, match="digits"):  # digits of another R
        ng.negacyclic_matmul(torch.zeros((B, nt * 8 * T), dtype=torch.int8), ext)
    with pytest.raises(ValueError, match="digits"):
        ng.diag_matmul(dig.to(torch.int32), block, R)
    with pytest.raises(ValueError, match="M = 16 or 8"):
        ng.diag_matmul(dig, block[:, : 12 * T].contiguous(), R)
    with pytest.raises(ValueError, match="bad block shape"):
        ng.diag_matmul(dig, block[T:], R)
    with pytest.raises(ValueError, match="contiguous"):
        ng.diag_matmul(dig, block[:, : 8 * T], R)
    with pytest.raises(ValueError, match="contiguous"):
        ng.negacyclic_matmul(dig, ext[:, :8])
    meta = lambda *ts: [t.to("meta") for t in ts]  # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        ng.diag_matmul(*meta(dig, block), R)
    with pytest.raises(ValueError, match="no kernel"):
        ng.negacyclic_matmul(*meta(dig, ext))
    with pytest.raises(ValueError, match="no kernel"):
        ng.build_diagonals(*meta(ext))
    with pytest.raises(ValueError, match="no kernel"):
        ng.build_rev_conj(*meta(ext))
    with pytest.raises(ValueError, match="no kernel"):
        ng.window_matmul(*meta(dig, block), R, Q27)
    with pytest.raises(ValueError, match="different devices"):
        ng.negacyclic_matmul(dig, ext.to("meta"))
    assert (ng.LAUNCHES, ng.PLAIN_LAUNCHES) == counts
