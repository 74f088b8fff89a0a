"""The K-major rev2 key and the tiling of the rotation's step GEMM
(oece_tpu_torch/csrc/rot_step.cu, ``rot_gemm_kernel``), on the CPU, bit for
bit (tolerance 0).

On the card rev2 is K-major, [n, 8, T, (2nt-1)*2RT], each step's block
transposed (keys.py); the GEMMs read it by TMA boxes of 4 planes (the
limbs of one output poly) x 16 coefficients x 128 contraction bytes.  The
tiled GEMM (B > 16) takes one per stage of an output tile for each math
warpgroup and the digits by boxes of NB gates, from scratch whose rows
run to the last gate tile's end, zero from B on (``rot.digit_scratch``);
the split GEMM (B <= 16) one per stage of a diagonal, all output tiles at
once against digit tiles it keeps in shared memory (from NB rows of the
same scratch), and adds partial sums; over a whole rotation each of its
blocks loads its first key stages before it waits for the digits kernel
(``rot.early_boxes``).  ``rot.gemm_config`` is the one rule of every
rotation's step GEMM, which the GINX wrappers pass to the kernels;
``rot.split_groups``, ``rot.split_digit_box``, ``rot.gemm_tiles`` and
``rot.key_box_origin`` repeat the kernels' choices.  Here:

  * ``rot.gemm_config`` for each family (the rotated form, the standard
    form at 16 and 8 planes, AP) picks the narrowest tile, fitted to B in
    steps of 16, step_gemm.cuh's gemm_tile (built with g++) agrees with
    it, and each GINX wrapper's card path passes that tile and sizes its
    scratch by it;
  * the K-major conversion (``keys.rev2_to``) and the K-major step blocks
    that ``build_rev2`` writes on the card equal each step's block
    transposed, for a ``keys.from_jax`` rev2 and for ``build_rev2``, and
    convert back;
  * the boxes at their origins rebuild every A tile of every stage from
    the K-major key (STD128_OPT widths with n=2, MICRO_A, TOY);
  * the tiled GEMM's walk covers every tile once, and its digit boxes lie
    inside the padded scratch (STD128 and STD128_OPT, B = 17 ... 4096);
  * the key boxes a split GEMM block loads before its wait are its first
    stages in its loader's order, none off the whole rotation or for
    the tiled GEMM, and a rotation counts their bytes;
  * the digits times those tiles, summed stage by stage over NB-gate tiles
    padded with zero rows (both GEMMs' from the digit scratch; the split
    GEMM's digit chunks outside the key's range are zeros), then combined
    through the
    epilogue's (limb, coefficient) rows, equal ``rot.rot_step_plain`` and
    ``rot.blind_rotate_rot_plain`` (ragged B, a=0 lanes, both GEMMs).

The plain twins are held to the JAX package in tests/test_torch_rot*.py;
the CUDA kernel to them on the card by chip_smoke.py (kernel, rot-step).
"""

import dataclasses
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from oece_tpu.fhe import devkeygen as jdevkeygen
from oece_tpu_torch.fhe import _build, ap, keys, modmath, rev, rot, std
from oece_tpu_torch.fhe.params import MICRO_A, STD128, STD128_OPT, TOY
from test_torch_copies import jax_params
from test_torch_std import one_torch_thread  # noqa: F401

T = 128
STD_N2 = dataclasses.replace(STD128_OPT, name="STD128_OPT_N2", n=2)


def _brk(p, n, seed):
    rng = np.random.default_rng(seed)
    R = 2 * p.d_g_used
    return torch.from_numpy(rng.integers(0, p.Q, (n, 2, R, 2, p.N)).astype(np.int32))


def _transposed(rev2):
    """Each step's row-major block transposed, as [n, 8, T, rows]."""
    n, rows, _ = rev2.shape
    return rev2.transpose(1, 2).reshape(n, 8, T, rows)


def test_kmajor_from_jax_rev2():
    """A JAX device-keygen rev2 carried across by from_jax stays row-major
    on the CPU; its K-major form is each block transposed, and converts
    back."""
    p = MICRO_A
    _, _, dkeys = jdevkeygen.device_keygen(jax_params(p), seed=7, layout="rev2")
    kt = keys.from_jax(dkeys)
    assert kt.rev2.shape == keys.rev2_shape(p.n, 2 * p.d_g_used, p.N, kmajor=False)
    kT = keys.rev2_to(kt.rev2, "cpu", kmajor=True)
    assert kT.shape == keys.rev2_shape(p.n, 2 * p.d_g_used, p.N, kmajor=True)
    assert torch.equal(kT, _transposed(kt.rev2))
    assert torch.equal(keys.rev2_to(kT, "cpu"), kt.rev2)
    assert keys.rev2_to(kt.rev2, "cpu") is kt.rev2  # the CPU layout already
    moved = kt.to("cpu")
    assert torch.equal(moved.rev2, kt.rev2)


def _id(x):
    return getattr(x, "name", str(x))


@pytest.mark.parametrize("p, n", [(MICRO_A, 3), (TOY, 2), (STD_N2, 1)], ids=_id)
def test_build_rev2_kmajor(p, n):
    """The step blocks build_rev2 writes on the card (rev2_step K-major),
    from the same refresh keys, are the CPU's row-major blocks transposed;
    so is rev2_to's conversion."""
    brk = _brk(p, n, seed=n + p.N)
    rm = keys.build_rev2(brk, p.Q)
    assert rm.shape == keys.rev2_shape(n, 2 * p.d_g_used, p.N, kmajor=False)
    idx = keys.rev_index(p.N, "cpu")
    km = torch.stack([keys.rev2_step(brk[i], p.Q, idx, kmajor=True) for i in range(n)])
    assert torch.equal(km, _transposed(rm))
    assert torch.equal(keys.rev2_to(rm, "cpu", kmajor=True), km)


def _a_tile(keyT_i, x, cc):
    """The A tile of column chunk cc at contraction byte x: the box of 4
    planes x 16 coefficients x 128 bytes at its origin, as 64 rows (limb l
    at rows 16l)."""
    rows = keyT_i.shape[-1]
    x, t0, plane = rot.key_box_origin(x, cc)
    assert 0 <= x and x + rot.GEMM_BK <= rows and t0 + rot.GEMM_CHUNK <= T and plane + 4 <= 8
    box = keyT_i[plane:plane + 4, t0:t0 + rot.GEMM_CHUNK, x:x + rot.GEMM_BK]
    return box.reshape(4 * rot.GEMM_CHUNK, rot.GEMM_BK)


@pytest.mark.parametrize("p", [STD_N2, MICRO_A, TOY], ids=_id)
def test_key_boxes_rebuild_every_tile(p):
    """Every A tile of every stage, for every output tile k and column
    chunk cc = (o, t0), is the row-major block's contraction rows
    (nt-1-k)*2RT + 128c .. +127 at the columns (o*4 + l)*T + t0 + j,
    ordered (l, j), transposed."""
    n = min(p.n, 2)
    rm = keys.build_rev2(_brk(p, n, seed=3), p.Q)
    km = keys.rev2_to(rm, "cpu", kmajor=True)
    nt, R2T = p.N // T, 4 * p.d_g_used * T
    t = torch.arange(rot.GEMM_CHUNK)
    for i in range(n):
        for k in range(nt):
            for cc in range(2 * T // rot.GEMM_CHUNK):
                o, t0 = divmod(cc, T // rot.GEMM_CHUNK)
                cols = torch.cat([(o * 4 + limb) * T + t0 * rot.GEMM_CHUNK + t for limb in range(4)])
                x0 = (nt - 1 - k) * R2T
                want = rm[i, x0:x0 + nt * R2T][:, cols].t()  # [64, K]
                got = torch.cat([_a_tile(km[i], x0 + c * rot.GEMM_BK, cc)
                                 for c in range(nt * R2T // rot.GEMM_BK)], dim=1)
                assert torch.equal(got, want), (i, k, cc)
            # the split GEMM's stages (d', s) cover every diagonal once
            full = torch.cat([_a_tile(km[i], x, cc) for x in range(0, (2 * nt - 1) * R2T, rot.GEMM_BK)], dim=1)
            assert torch.equal(full, rm[i][:, cols].t())


# The step GEMM's families: (digit substages per d_used, output polys,
# split GEMM's shared memory, the last split batch at STD128's N = 1024,
# d = 4, and the split_groups pins of their polys).
FAMILIES = {
    "rot": (4, 2, rot.split_smem, 8),
    "rev": (2, 4, rot.split_smem, 8),
    "rev_m8": (2, 2, rot.split_smem, 16),
    "ap": (2, 2, ap.split_smem, 8),
}
SPLIT_GROUPS = {2: {1024: (2, 8), 512: (1, 7), 128: (1, 1)},
                4: {1024: (4, 4), 512: (2, 4), 128: (1, 1)}}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gemm_config_picks_the_narrowest_tile(family):
    """The one rule of the step GEMM's shape (``rot.gemm_config``) for each
    family: the rotated form (2RT/128 substages, 2 polys), the standard
    form's 16 planes and #8's 8 (RT/128, 4 or 2 polys) and AP's steps (RT/128,
    2 polys, its own split GEMM's shared memory); ``rot.split_groups`` and
    ``rot.gemm_tiles`` at the family's polys.  Above 16 gates the tiled
    GEMM's gate tiles are fitted to B in steps of 16: ceil(B/256) tiles of
    the least multiple of 16 (at least 32) that holds B, two warpgroups
    exactly above 256 gates."""
    per_d, polys, smem, last_split = FAMILIES[family]
    config = lambda B, N, d: rot.gemm_config(B, N, per_d * d, polys, smem)  # noqa: E731
    N, d = STD128_OPT.N, STD128_OPT.d_g_used
    for B in range(1, 600):
        NB, MW, split = config(B, N, d)
        if B <= 16:
            assert split and MW == 1 and NB == (8 if B <= 8 else 16)
            assert smem(NB, per_d * d, rot.split_groups(N, polys)[0]) <= rot.SMEM_MAX
        else:
            gate_tiles = -(-B // 256)
            assert not split and NB % 16 == 0 and 32 <= NB <= 256
            assert -(-B // NB) == gate_tiles and B <= gate_tiles * NB < B + 16 * gate_tiles
            assert MW == (2 if B > 256 else 1)
            assert NB == 32 or gate_tiles * (NB - 16) < B
    assert [config(B, N, d)[:2] for B in (17, 33, 132, 180, 256, 257, 300, 512, 684, 4096)] == [
        (32, 1), (48, 1), (144, 1), (192, 1), (256, 1), (144, 2), (160, 2), (256, 2), (240, 2), (256, 2)]
    # where the split GEMM does not fit, the tiled one's narrowest tile
    assert config(last_split + 1, 1024, 4)[:2] == (32, 1)
    # STD128 (exact gadget, d = 4): 16 gates' digits do not fit beside the
    # ring (or, for AP, the key tiles), except at 2 polys of 8 planes
    assert config(last_split, 1024, 4)[2] and not config(last_split + 1, 1024, 4)[2]
    assert not config(4, 2048, 2)[2]  # nt > 8: one wgmma cannot hold every output tile
    for N, groups in SPLIT_GROUPS[polys].items():
        assert rot.split_groups(N, polys) == groups
    for N in (128, 512, 1024):
        dpg, groups = rot.split_groups(N, polys)
        assert groups * polys * T // rot.GEMM_CHUNK <= rot.SPLIT_BLOCKS and groups <= 8
        assert (groups - 1) * dpg < 2 * N // T - 1 <= groups * dpg
    if family == "ap":
        assert config(16, 512, 4)[2] and config(16, 128, 2)[2]
        assert max(ap.split_smem(16, 4, 2), ap.split_smem(8, 8, 2)) <= rot.SMEM_MAX
    if family == "rev":
        assert rot.gemm_tiles(300, 1024, 4, 4)[:3] == [(0, 0, 0), (1, 0, 0), (0, 0, 1)]
        assert len(rot.gemm_tiles(300, 1024, 4, 4)) == 2 * 8 * 16
    if family == "rev_m8":
        assert len(rot.gemm_tiles(17, 512, 4, 2)) == 1 * 4 * 16


def test_gemm_tile_in_cuda_is_gemm_config(tmp_path):
    """step_gemm.cuh's gemm_tile (AP's per-step copy of the rule), built
    with g++ on its own, returns ``rot.gemm_config``'s NB for every B in
    1 .. 4096 and each pair of split-GEMM fits; with_tile's instances
    (NB = 32 .. 256 in steps of 16 with one warpgroup, NB_TWO_WG .. 256
    with two) are every tile the rule returns."""
    src = (Path(rot.__file__).parent.parent / "csrc" / "step_gemm.cuh").read_text()
    body = re.search(r"inline int gemm_tile\(int B, const bool \(&fits\)\[2\]\) \{.*?\n\}\n", src, re.S).group(0)
    prog = tmp_path / "gemm_tile.cpp"
    prog.write_text("#include <cstdio>\n" + body + """
int main() {
  for (int f = 0; f < 4; ++f) {
    const bool fits[2] = {(f & 1) != 0, (f & 2) != 0};
    for (int B = 1; B <= 4096; ++B) std::printf("%d\\n", gemm_tile(B, fits));
  }
}
""")
    exe = tmp_path / "gemm_tile"
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe), str(prog)], check=True)
    got = [int(v) for v in subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout.split()]
    want = []
    for f in range(4):
        fits = (bool(f & 1), bool(f & 2))
        smem = lambda NB, sub, dpg, fits=fits: 0 if fits[NB == 16] else rot.SMEM_MAX + 1  # noqa: E731
        want += [rot.gemm_config(B, 1024, 8, 2, smem)[0] for B in range(1, 4097)]
    assert got == want
    two_wg = int(re.search(r"constexpr int NB_TWO_WG = (\d+);", src).group(1))
    assert re.search(r"with_tiled<32>\(NB, B, f\)", src) and "if constexpr (NB < 256) return with_tiled<NB + 16>" in src
    rule = {rot.gemm_config(B, 1024, 16, 2)[:2] for B in range(17, 4097)}
    assert rule == {(nb, 1) for nb in range(32, 257, 16)} | {(nb, 2) for nb in range(two_wg, 257, 16)}


def test_digit_scratch_runs_to_the_gate_tile_in_zeros():
    """The step loop's digit scratch: rows to the last gate tile's end,
    for the split GEMM its one tile of NB = 8 or 16 gates, for the tiled
    one NB = 32, 48 ... 256 fitted to B, the rows from B on zero, which the
    digits kernel never writes (so no digit box reads past the map's
    rows)."""
    for p in (STD128, STD128_OPT):
        K = p.N // T * 4 * p.d_g_used * T
        for B in (1, 4, 8, 9, 16, 17, 132, 180, 256, 257, 300, 684, 4096):
            NB, _, split = rot.gemm_config(B, p.N, 4 * p.d_g_used, 2)
            acc = torch.zeros((B, 2, p.N), dtype=torch.int32)
            dig, sums = rot._scratch(acc, p, NB)
            assert dig.shape == (-(-B // NB) * NB, K) and dig.dtype == torch.int8
            assert not dig[B:].any() and (dig.shape[0] == NB or not split)
            assert sums.shape == ((2, B, 2, p.N) if split else (0,))
            # a tile of 144 rows at 132 gates (not 256), 2 x 160 at 300
            assert dig.shape[0] == {132: 144, 180: 192, 300: 320, 684: 720}.get(B, dig.shape[0])


class _Recorder:
    """A stand-in for ``_build.load()``: records each entry's arguments
    and returns 0."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("p", [TOY, STD128_OPT], ids=_id)
@pytest.mark.parametrize("B", [1, 8, 9, 16, 17, 200, 257])
def test_wrappers_size_their_scratch_by_the_tile_they_pass(monkeypatch, p, B):
    """Each GINX wrapper's card path, run on the CPU against a recording
    library: the gate tile it passes is ``rot.gemm_config``'s for its form,
    its digit scratch has the rows it passes (B rounded up to that tile)
    and its sums or products are the split GEMM's at NB <= 16, the tiled
    GEMM's above."""
    made = {}
    empty = torch.empty

    def recorded_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        made[t.data_ptr()] = t
        return t

    lib = _Recorder()
    monkeypatch.setattr(torch, "empty", recorded_empty)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(rev, "_on_card", lambda name, *ts: True)
    N, d, n = p.N, p.d_g_used, 3
    R, nt = 2 * d, N // T
    rows = lambda NB: -(-B // NB) * NB  # noqa: E731
    acc = torch.zeros((B, 2, N), dtype=torch.int32)
    a2N = torch.zeros((B, n), dtype=torch.int32)
    key = torch.zeros((n, 1), dtype=torch.int8)

    NB = rot.gemm_config(B, N, 4 * d, 2)[0]
    rot._blind_rotate_rot_cuda(acc, key, a2N, p, NB)
    rot._rot_step_cuda(acc, key[0], a2N[:, :2].contiguous(), p, None)
    for name in ("oece_blind_rotate_rot", "oece_rot_step"):
        args = lib.calls[name]
        dig, sums = made[args[2]], made[args[3]]
        assert args[6:8] == (B, NB) and dig.shape == (args[8], nt * 2 * R * T) == (rows(NB), nt * 2 * R * T)
        assert sums.shape == ((2, B, 2, N) if NB <= 16 else (0,))

    NB = rot.gemm_config(B, N, R, 4)[0]
    rev._blind_rotate_rev_cuda(acc, key, a2N, p, NB)
    std._blind_rotate_std_cuda(acc, torch.zeros((n, R, 16, 2 * N), dtype=torch.int8), a2N, p, NB)
    for name, dig_at in (("oece_blind_rotate_rev", 2), ("oece_blind_rotate_std", 2)):
        args = lib.calls[name]
        dig, prod = made[args[dig_at]], made[args[1]]
        i = 5 if name.endswith("rev") else 6
        assert args[i:i + 2] == (B, NB) and dig.shape == (args[i + 2], nt * R * T) == (rows(NB), nt * R * T)
        assert prod.shape == ((2, B, 4, N) if NB <= 16 else (B, 4, N))

    for M in (16, 8):
        NB = rot.gemm_config(B, N, R, M // 4)[0]
        block = torch.zeros((M, T, (2 * nt - 1) * R * T), dtype=torch.int8)
        rev.window_matmul_dec_true(acc, block, p)
        args = lib.calls["oece_rev_matmul_dec"]
        assert args[4:6] == (B, NB) and made[args[1]].shape == (args[6], nt * R * T) == (rows(NB), nt * R * T)
        rev.window_matmul_true(torch.zeros((B, nt * R * T), dtype=torch.int8), block, R, p.Q)
        assert lib.calls["oece_rev_window_matmul"][3:5] == (B, NB)
        rev.window_matmul_counted("w", torch.zeros((B, nt * R * T), dtype=torch.int8),
                                  torch.zeros(((2 * nt - 1) * R * T, M * T), dtype=torch.int8), R, p.Q,
                                  None, lambda *a: None)
        assert lib.calls["oece_window_matmul"][4:6] == (B, NB)


def _loader_boxes(cc, grp, step, N, d_used):
    """The key boxes the split GEMM's loader of block (cc, grp) takes at
    key step ``step``, in order: diagonals d_lo .. d_hi-1, substages 0 ..
    2RT/128 - 1 of each."""
    R2T, (dpg, _) = 4 * d_used * T, rot.split_groups(N, 2)
    d_lo, d_hi = grp * dpg, min(grp * dpg + dpg, 2 * (N // T) - 1)
    return [(*rot.key_box_origin(dd * R2T + c * rot.GEMM_BK, cc), step)
            for dd in range(d_lo, d_hi) for c in range(R2T // rot.GEMM_BK)]


@pytest.mark.parametrize("p", [STD128, STD128_OPT, MICRO_A], ids=_id)
def test_early_boxes_are_each_blocks_first_ring_stages(p):
    """Block (cc, grp) of a rotation's split GEMM at step i loads exactly
    the first EARLY_STAGES stages of its own slice of step i, in its
    loader's order, before it waits for the digits kernel: at STD128 4
    of the 32 stages of groups 0-6 and of the 16 of group 7, 4 MiB a step
    in all, which the rotation counts at every step."""
    src = (Path(rot.__file__).parent.parent / "csrc" / "step_gemm.cuh").read_text()
    early = re.search(r"constexpr int EARLY = (\d+);", src).group(1)
    ring = re.search(r"A_BYTES = COLS \* BK, STAGES = (\d+), EPI_PITCH", src).group(1)
    assert int(early) == rot.EARLY_STAGES <= int(ring)  # gemm_split's, within its ring
    N, d = p.N, p.d_g_used
    dpg, groups = rot.split_groups(N, 2)
    chunks = 2 * T // rot.GEMM_CHUNK
    total = 0
    for grp in range(groups):
        for cc in range(chunks):
            want = _loader_boxes(cc, grp, 5, N, d)
            got = rot.early_boxes(cc, grp, 5, N, d)
            assert got == want[:rot.EARLY_STAGES], (grp, cc)
            total += len(got)
    assert [st for _, _, st in rot.split_blocks(N, 4 * d * T, 2, dpg, groups)] == [
        len(_loader_boxes(cc, grp, 0, N, d)) for grp in range(groups) for cc in range(chunks)]
    NB = rot.gemm_config(4, N, 4 * d, 2)[0]
    assert rot.key_prefetch_bytes(5, N, 4 * d * T, 2, NB) == 5 * total * rot.KEY_STAGE_BYTES
    if p is STD128:
        assert groups * chunks == 128 and total * rot.KEY_STAGE_BYTES == 4 * 2**20
        assert len(_loader_boxes(0, 0, 1, N, d)) == 32 and len(_loader_boxes(0, 7, 1, N, d)) == 16


@pytest.mark.parametrize("p", [STD128, STD128_OPT], ids=_id)
def test_no_early_boxes_off_the_rotation_or_in_the_tiled_gemm(p):
    """No key box goes before the wait in #11's one step or on the
    ginx_ext ring (not a whole rotation on a prebuilt key), and the tiled
    GEMM (B > 16) counts none, in either form; both prebuilt forms' split
    GEMMs count theirs at every step."""
    N, d = p.N, p.d_g_used
    dpg, groups = rot.split_groups(N, 2)
    for grp in range(groups):
        for cc in range(2 * T // rot.GEMM_CHUNK):
            assert rot.early_boxes(cc, grp, 0, N, d, whole=False) == []
    forms = ((4 * d, 2), (2 * d, 4))  # (digit substages, output polys): rev2, rev
    prefetch = lambda n, B, sub, polys: rot.key_prefetch_bytes(  # noqa: E731
        n, N, sub * rot.GEMM_BK, polys, rot.gemm_config(B, N, sub, polys)[0])
    for B in (17, 132, 256, 257, 4096):
        assert not rot.gemm_config(B, N, 4 * d, 2)[2]
        assert all(prefetch(p.n, B, *form) == 0 for form in forms)
    for B in (1, 4, 8):
        assert all(prefetch(p.n, B, *form) == p.n * prefetch(1, B, *form) > 0 for form in forms)


WIDE = (17, 33, 65, 129, 132, 180, 200, 256, 257, 300, 684, 1000, 4096)


@pytest.mark.parametrize("p", [STD128, STD128_OPT], ids=_id)
@pytest.mark.parametrize("B", WIDE)
def test_tile_walk_covers_every_tile_once_inside_the_digit_scratch(p, B):
    """The tiled GEMM's persistent blocks (one per SM, any number of them)
    take every (gate tile, output tile, column tile) once, gate tile
    fastest, and each tile's digit box of NB gates lies inside the digit
    scratch, whose rows past B are zeros: no box reads past the map's
    end."""
    N, d = p.N, p.d_g_used
    NB, MW, split = rot.gemm_config(B, N, 4 * d, 2)
    assert not split
    nt, col_tiles, gate_tiles = N // T, 2 * (T // rot.GEMM_CHUNK) // MW, -(-B // NB)
    tiles = rot.gemm_tiles(B, N, 4 * d, 2)
    assert sorted(tiles) == [(gt, k, ct) for gt in range(gate_tiles) for k in range(nt)
                             for ct in range(col_tiles)]
    assert [gt for gt, _, _ in tiles] == [i % gate_tiles for i in range(len(tiles))]
    for grid in (1, 7, 66, 132):  # block b takes tiles b, b + grid, ...
        walked = [tiles[i] for b in range(min(grid, len(tiles))) for i in range(b, len(tiles), grid)]
        assert sorted(walked) == sorted(tiles)
    dig = rot._scratch(torch.zeros((B, 2, N), dtype=torch.int32), p, NB)[0]
    assert dig.shape[0] == gate_tiles * NB and not dig[B:].any()


def _combine(d, p):
    """[64 key columns x NB gates] limb sums -> their combine mod Q, [NB
    gates, 16 coefficients]: coefficient t combines rows 16l + t."""
    limbs = d.to(torch.int32).view(4, rot.GEMM_CHUNK, -1).permute(2, 1, 0)  # [gate, t, limb]
    return modmath.combine_limbs_mod_q(limbs, p.Q)


def _step_by_tiles(acc, keyT_i, amt, p):
    """One step as rot_step.cu computes it: the digits of both rotated
    differences (the digits kernel's twin) in the step's digit scratch
    (``rot.digit_scratch``), gates padded to the NB-gate tile with zero
    rows from the scratch, A tiles from the key's boxes, sums of A_c x dig_c^T stage by stage (float64, exact: |sum| <=
    2**27), each coefficient t of a 16-coefficient chunk combining rows
    16l + t (l = 0..3) mod Q.  The tiled GEMM adds the combined tile to the
    old accumulator with red31; the split GEMM stores one partial sum per
    diagonal group, which the next digits kernel (here: the end of the
    step) adds up with red31."""
    B, _, N = acc.shape
    nt, R2T = N // T, 4 * p.d_g_used * T
    sub = R2T // rot.GEMM_BK
    NB, MW, split = rot.gemm_config(B, N, 4 * p.d_g_used, 2)
    dig, _ = rot._scratch(acc, p, NB)
    dig[:B] = rot.rot_diff_digits(acc, amt, p)
    gates = -(-B // NB) * NB
    assert dig.shape[0] == gates  # every box's NB rows lie in the scratch
    padded = dig.double()
    chunk = lambda q, rows: rows[:, q * rot.GEMM_BK:(q + 1) * rot.GEMM_BK]  # noqa: E731
    if split:  # per block (group, cc): one [64 x 8NB] product per stage, k = column // NB
        dpg, groups = rot.split_groups(N, 2)
        total = torch.zeros((B, 2, N), dtype=torch.int64)
        for grp in range(groups):
            d_lo, d_hi = grp * dpg, min(grp * dpg + dpg, 2 * nt - 1)
            tiles = torch.zeros((sub, dpg + 7, NB, rot.GEMM_BK), dtype=torch.float64)
            for c in range(sub):
                j0, c_box = rot.split_digit_box(c, d_lo, N)
                for jj in range(dpg + 7):
                    if 0 <= j0 + jj < nt:  # else zeros (not loaded at NB = 8, TMA fill at 16)
                        tiles[c, jj] = chunk((j0 + jj) * sub + c_box, padded)
            for cc in range(2 * T // rot.GEMM_CHUNK):
                o, t0 = divmod(cc, T // rot.GEMM_CHUNK)
                t0 *= rot.GEMM_CHUNK
                d = torch.zeros((4 * rot.GEMM_CHUNK, 8 * NB), dtype=torch.float64)
                for dd in range(d_lo, d_hi):
                    for s in range(sub):
                        a = _a_tile(keyT_i, dd * R2T + s * rot.GEMM_BK, cc).double()
                        d += a @ tiles[s, dd - d_lo:dd - d_lo + 8].reshape(8 * NB, -1).t()
                for k in range(nt):
                    comb = _combine(d[:, k * NB:(k + 1) * NB], p)[:B]
                    assert (comb >= 0).all() and (comb < p.Q).all()
                    total[:, o, k * T + t0:k * T + t0 + rot.GEMM_CHUNK] += comb
        assert (total < 8 * p.Q).all()
        return modmath.red31((acc + total).to(torch.int32), p.Q)
    out = torch.full_like(acc, -1)
    for gt, k, ct in rot.gemm_tiles(B, N, 4 * p.d_g_used, 2):
        b_tile = padded[gt * NB:(gt + 1) * NB]
        for w in range(MW):
            cc = ct * MW + w
            o, t0 = divmod(cc, T // rot.GEMM_CHUNK)
            t0 *= rot.GEMM_CHUNK
            d = torch.zeros((4 * rot.GEMM_CHUNK, NB), dtype=torch.float64)
            for c in range(nt * sub):
                a = _a_tile(keyT_i, (nt - 1 - k) * R2T + c * rot.GEMM_BK, cc).double()
                d += a @ chunk(c, b_tile).t()
            n_live = min(NB, B - gt * NB)
            sl = (slice(gt * NB, gt * NB + n_live), o, slice(k * T + t0, k * T + t0 + rot.GEMM_CHUNK))
            out[sl] = modmath.red31(acc[sl] + _combine(d, p)[:n_live], p.Q)
    assert (out >= 0).all()  # every output written
    return out


def _inputs(p, B, seed):
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32))
    scale = 2 * p.N // p.q
    a2N = (scale * rng.integers(0, p.q, (B, p.n))).astype(np.int32)
    a2N[0] = 0
    a2N[:, ::3] = 0
    return acc, torch.from_numpy(a2N)


@pytest.mark.parametrize("p, B", [(MICRO_A, 1), (MICRO_A, 13), (MICRO_A, 300), (TOY, 5), (TOY, 37),
                                  (STD_N2, 13)], ids=_id)
def test_gemm_by_tiles_equals_plain_step(p, B):
    """One step for any amount pair (#11), lane 0 with both amounts 0: the
    split (B <= 16) or the tiled GEMM == rot_step_plain."""
    acc, _ = _inputs(p, B, seed=B)
    rng = np.random.default_rng(B + 1)
    amt = torch.from_numpy(rng.integers(0, 2 * p.N, (B, 2)).astype(np.int32))
    amt[0] = torch.tensor([0, 0])  # a=0: both differences vanish
    rm = keys.build_rev2(_brk(p, 1, seed=B), p.Q)
    km = keys.rev2_to(rm, "cpu", kmajor=True)
    got = _step_by_tiles(acc, km[0], amt, p)
    assert torch.equal(got, rot.rot_step_plain(acc, rm[0], amt, p))
    assert torch.equal(got[0], acc[0])


@pytest.mark.parametrize("p, B", [(dataclasses.replace(MICRO_A, n=3), 5), (dataclasses.replace(TOY, n=2), 37),
                                  (STD_N2, 4)], ids=_id)
def test_gemm_by_tiles_equals_plain_rotation(p, B):
    """The step loop of oece_blind_rotate_rot (#12), step i on the K-major
    key's step i, == blind_rotate_rot_plain on the row-major key."""
    acc, a2N = _inputs(p, B, seed=7 * B)
    rm = keys.build_rev2(_brk(p, p.n, seed=B), p.Q)
    km = keys.rev2_to(rm, "cpu", kmajor=True)
    amt = rot.amount_pairs(a2N, p.N)
    got = acc
    for i in range(p.n):
        got = _step_by_tiles(got, km[i], amt[:, i], p)
    assert torch.equal(got, rot.blind_rotate_rot_plain(acc, rm, a2N, p))
    assert torch.equal(got[0], acc[0])
