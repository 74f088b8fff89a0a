"""The cell ginxhost.adder32.t4: GINX on the client's compact bootstrapping
key (ginx_ext), whose rotation builds each step's block into a ring of two
slots (fhe/std.py, csrc/rev_step.cu).  At MICRO on the CPU: the cell runs
sound through the std rotation, and the control and the planted faults
fail; the reader of build_share.host on hand-made profiles.  On a card:
the ring rotation at the cell's widths against its plain twin, and the
control at the cell's size.

The MICRO runs skip the warm-up evaluation: the CPU's plain std step
builds its block from the key at every step, ~20 s an evaluation on one
thread, and the warm-up changes nothing that is checked here."""

import copy
import time

import pytest
import torch

from fhe_bench import port, readings
from fhe_bench import run as bench_run
from fhe_bench.tests import micro
from fhe_bench.tests.test_fhe_bench_control import _half_batch, _keep, _rotation_unchanged

CELL = "ginxhost.adder32.t4"


def _micro_cell():
    bench, cfg, traffic = micro.cell(CELL)
    traffic = copy.deepcopy(traffic)
    traffic["warmup"]["evaluations"] = 0
    return bench, cfg, traffic


def test_cell_runs_sound_through_the_std_rotation():
    from oece_tpu_torch.fhe import rot, std

    bench, cfg, traffic = _micro_cell()
    assert cfg["key_layout"] == "ginx_ext" and cfg["method"] == "GINX"
    std0, rot0 = std.PLAIN_LAUNCHES, rot.PLAIN_LAUNCHES
    run = micro.run(cfg, traffic)
    assert std.PLAIN_LAUNCHES - std0 == 63 and rot.PLAIN_LAUNCHES == rot0
    assert run["wrong_bits"] == 0 and run["failed"] == 0 and run["attempted"] == 1
    assert run["max_error"] <= cfg["limits"]["max_output_error"]
    line = bench_run.result(run, bench, cfg, CELL, False, 1, "cpu (test)")
    assert line["correct"] is True and set(line["metrics"]) == {"circuit_s.p50", "setup_s"}


def test_control_fails():
    _, cfg, traffic = _micro_cell()
    run = micro.run(readings.lowered(cfg), traffic)
    assert run["wrong_bits"] > 0 and run["failed"] == run["attempted"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_under_the_timed_path_fails(fault):
    _, cfg, traffic = _micro_cell()
    if fault == "state_unchanged":
        restore = port.wrap_spans(_keep, _rotation_unchanged)
    else:
        restore = port.wrap_spans(_half_batch, _keep)
    try:
        run = micro.run(cfg, traffic)
    finally:
        restore()
    assert run["wrong_bits"] > 0


def _profile(ops, busy_s=0.5):
    return {"profile": {"busy_s": busy_s, "window_s": 0.6, "device_ops": ops, "idle_gaps": []}}


def test_build_share_reads_the_build_kernel():
    read = bench_run.reader("build_share.host")
    ops = [["void (anonymous namespace)::rev_gemm_split_kernel<8>(CUtensorMap_st, int)", 0.3],
           ["(anonymous namespace)::std_build_kernel(signed char const*, signed char*, int, int)", 0.1],
           ["(anonymous namespace)::rev_digits_kernel(int*, signed char*, int)", 0.1]]
    assert read(_profile(ops)) == pytest.approx(20.0)
    assert read(_profile([ops[0], ops[2]])) is None
    assert read({"profile": None}) is None and read({}) is None


@pytest.mark.card
@pytest.mark.parametrize("B", [4, 132])
def test_ring_rotation_at_the_cells_widths(card, B):
    """STD128 (R = 8): the ring of two 31.5 MB slots over 6 steps, each
    slot written three times, at the split GEMM's width and at the tiled
    GEMM's, against the plain rotation, bit for bit, on any key bytes."""
    from oece_tpu_torch.fhe import params, std

    p = params.STD128
    n, N, R = 6, p.N, 2 * p.d_g_used
    g = torch.Generator(device=card)
    g.manual_seed(2**31 + B)
    acc = torch.randint(0, p.Q, (B, 2, N), generator=g, device=card, dtype=torch.int32)
    ext = torch.randint(-128, 128, (n, R, 16, 2 * N), generator=g, device=card, dtype=torch.int8)
    a2N = (2 * N // p.q) * torch.randint(0, p.q, (B, n), generator=g, device=card, dtype=torch.int32)
    a2N[0] = 0
    a2N[:, ::5] = 0
    launches = std.LAUNCHES
    got = std.blind_rotate_std(acc, ext, a2N, p)
    assert std.LAUNCHES == launches + 1
    want = std.blind_rotate_std_plain(acc, ext, a2N, p)
    assert torch.equal(got, want) and torch.equal(got[0], acc[0])


@pytest.mark.card
def test_control_at_the_cells_size(card):
    _, cfg, traffic = bench_run.load_cell(CELL)
    sound = bench_run.run_cell(cfg, traffic, 2**31 + 23, 0.0, False, device=card, t_start=time.time())
    control = bench_run.run_cell(readings.lowered(cfg), traffic, 2**31 + 23, 0.0, False,
                                 device=card, t_start=time.time())
    assert sound["wrong_bits"] == 0 and control["wrong_bits"] > 0
