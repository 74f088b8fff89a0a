"""The program-span collection (program_trace.py) and the readers of its
five metric families: the idle split on a synthetic window, the readers on
synthetic run dicts (and on a run dict without program spans, as the
traced run gives today: no value, no error), and ``collect`` on a CPU
Circuit at MICRO, whose outputs the reference judges.  On a card, the
cells at their own size: device spans, host waits per level and the idle
split adding up to the slice's idle."""

import pytest

from fhe_bench import port, program_trace, reference
from fhe_bench import run as bench_run
from fhe_bench.tests import micro

FAMILIES = tuple(program_trace.READERS)
CELLS = ["ginx.adder32.t4", "ap.adder32.t4"]


def test_idle_split_adds_up_and_names_the_host_span():
    # window 0..100 us; work 10-20, 30-70; one rotation's device interval 25-65
    host = [(0, 100, "clock"), (2, 28, "level.host"), (24, 66, "boot.rotation"),
            (40, 50, "ap.live_count")]
    out = program_trace.split_idle(0.0, 100.0, [(10, 20), (30, 60), (55, 70)], [(25, 65)], host)
    assert out["busy_s"] == pytest.approx(50e-6) and out["idle_s"] == pytest.approx(50e-6)
    assert out["rot_s"] == pytest.approx(40e-6)
    assert out["rot_idle_s"] == pytest.approx(5e-6)  # 25-30
    assert out["edge_idle_s"] == pytest.approx(45e-6)  # 0-10, 20-25, 70-100
    by = out["idle_by_span"]
    assert by == pytest.approx({"level.host": 16e-6, "boot.rotation": 2e-6, "clock": 32e-6})
    assert sum(by.values()) == pytest.approx(out["idle_s"])
    bare = program_trace.split_idle(0.0, 10.0, [(2, 4)], [], [])
    assert bare["idle_by_span"] == pytest.approx({program_trace.NOWHERE: 8e-6})
    assert bare["rot_idle_s"] == 0 and bare["edge_idle_s"] == pytest.approx(8e-6)


def test_rotation_interval_from_its_launches():
    launch = sorted([(5.0, 11), (12.0, 12), (30.0, 13), (41.0, 14)])
    kernel = {11: (6.0, 9.0), 12: (14.0, 20.0), 13: (31.0, 38.0), 14: (45.0, 50.0)}
    assert program_trace.launched(launch, kernel, 10.0, 35.0) == (14.0, 38.0)
    assert program_trace.launched(launch, kernel, 60.0, 70.0) is None


def _events(skew: float, copies: bool):
    """A profiled slice 0-100 us: two kernels launched at 5 and 25 us that
    run 10-20 and 30-70 us, the second inside a rotation range (24-66 us on
    the host), on a device clock ``skew`` us off the host's."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from fhe_bench.profile_slice import SLICE

    def ev(name, a, b, cpu=True, id=0):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b), id=id,
                               device_type=DeviceType.CPU if cpu else DeviceType.CUDA)

    evs = [ev(SLICE, 0.0, 100.0), ev("oece.level", 0.0, 100.0), ev("oece.group.gather", 2.0, 20.0),
           ev("oece.boot.rotation", 24.0, 66.0), ev("cudaLaunchKernel", 5.0, 6.0, id=11),
           ev("cudaLaunchKernelExC", 25.0, 26.0, id=12),
           ev("k1", 10.0 + skew, 20.0 + skew, False, 11), ev("k2", 30.0 + skew, 70.0 + skew, False, 12)]
    if copies:
        evs.append(ev("oece.boot.rotation", 30.0 + skew, 70.0 + skew, False))
    return evs


@pytest.mark.parametrize("copies", [True, False])
def test_profile_numbers_from_events(copies):
    out = program_trace.profile_numbers(_events(0.0, copies), 1)
    assert out["clock_shift_us"] == 0 and out["launch_pairs"] == 2
    assert out["rotations_source"].startswith("device copy" if copies else "kernels launched")
    assert out["rot_s"] == pytest.approx(40e-6) and out["busy_s"] == pytest.approx(50e-6)
    assert out["rot_idle_s"] == 0 and out["edge_idle_s"] == pytest.approx(50e-6)
    assert out["idle_by_span"] == pytest.approx({"group.gather": 8e-6, "level": 36e-6,
                                                 "boot.rotation": 6e-6})
    # a device clock 8 us early: kernels seem to start before their launch;
    # they move later by the largest lead, 3 us, past the launch
    skewed = program_trace.profile_numbers(_events(-8.0, copies), 1)
    assert skewed["clock_shift_us"] == pytest.approx(3.0)
    assert skewed["rot_s"] == pytest.approx(40e-6)
    assert skewed["idle_by_span"] == pytest.approx({"group.gather": 8e-6, "level": 40e-6,
                                                    "boot.rotation": 2e-6})


def test_clock_shift_ignores_a_stray_record():
    assert program_trace.clock_shift([]) == 0.0
    assert program_trace.clock_shift([-5.0] * 300 + [10000.0]) == 0.0
    assert program_trace.clock_shift([3.0] * 300 + [-50.0] * 10) == 3.0


def _run(spans=None, profile=None):
    run = {}
    if spans is not None:
        run["program_spans"] = spans
    if profile is not None:
        run["program_profile"] = profile
    return run


def test_readers(capsys):
    spans = dict(levels=8, host_waits=12, lead_levels=4, lead_s=0.002,
                 boot_device_s=0.5, post_device_s=0.02)
    profile = dict(window_s=0.2, idle_s=0.03, rot_s=0.15, rot_idle_s=0.006, edge_idle_s=0.024,
                   levels=4, idle_by_span={"level.host": 0.02, "boot.rotation": 0.01})
    got = {f: read(_run(spans, profile)) for f, read in program_trace.READERS.items()}
    assert got == pytest.approx({"level_lead_ms": 0.5, "host_waits_per_level": 1.5,
                                 "keyswitch_share": 4.0, "idle_rot_share": 4.0,
                                 "idle_edge_ms": 6.0})
    # the in-rotation idle in ms and the edges' add up to the slice's idle
    rebuilt = got["idle_rot_share"] / 100 * profile["rot_s"] + got["idle_edge_ms"] / 1e3 * profile["levels"]
    assert rebuilt == pytest.approx(profile["idle_s"])
    assert "level.host" in capsys.readouterr().err
    for read in program_trace.READERS.values():  # a traced run without program spans
        assert read({"spans": {}, "profile": {}}) is None


@pytest.mark.parametrize("cell", CELLS)
def test_collect_on_the_cpu(cell):
    """The command's own path at MICRO: set-up, an evaluation with tracing
    off, ``collect``; the span metrics read, the device ones not."""
    bench, cfg, traffic = micro.cell(cell)
    line = program_trace.measure(bench, cfg, traffic, cell, 2**33 + 7, 1, "cpu")
    assert line["correct"] and line["attempted"] == 1 + program_trace.EVALUATIONS
    assert line["program_profile"] is None  # the device split needs the card
    spans = line["program_spans"]
    plan = port.circuit(cfg, traffic, port.params(cfg), None, None,
                        str(bench_run.ROOT / traffic["circuit"]), 5, "cpu").plan
    rotating = sum(1 for level in plan.levels if len(level["boot_op"]))
    assert spans["levels"] == program_trace.EVALUATIONS * plan.depth
    assert spans["lead_levels"] == program_trace.EVALUATIONS * rotating and spans["lead_s"] > 0
    assert spans["boot_device_s"] is None  # CUDA events only on the card
    circ = reference.parse(str(bench_run.ROOT / traffic["circuit"]))
    assert spans["counters"]["lanes"] == (program_trace.EVALUATIONS
                                          * bench_run.bootstraps_per_request(circ, traffic))
    metrics = line["metrics"]
    assert metrics["level_lead_ms.narrow"] > 0
    # recovery off, no level synchronize on the CPU: no host wait inside a level
    assert metrics["host_waits_per_level.narrow"] == 0
    assert [metrics[f"{f}.narrow"] for f in FAMILIES[2:]] == [None, None, None]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_collect_at_the_cells_size(card, cell):
    bench, cfg, traffic = bench_run.load_cell(cell)
    line = program_trace.measure(bench, cfg, traffic, cell, 2**31 + 33, 1, card)
    assert line["correct"]
    spans = line["program_spans"]
    plan = port.circuit(cfg, traffic, port.params(cfg), None, None,
                        str(bench_run.ROOT / traffic["circuit"]), 5, "cpu").plan
    rotating = sum(1 for level in plan.levels if len(level["boot_op"]))
    depth = plan.depth
    # GINX waits once a level (its synchronize); AP also once per rotation (the live counts)
    per_level = 1 + (cfg["method"] == "AP") * rotating / depth
    assert spans["host_waits"] == pytest.approx(program_trace.EVALUATIONS * depth * per_level)
    assert 0 < spans["post_device_s"] < spans["boot_device_s"]
    prof = line["program_profile"]
    assert prof is not None and 0 < prof["rot_s"] <= prof["window_s"]
    rebuilt = prof["rot_idle_s"] + prof["edge_idle_s"]
    assert abs(rebuilt - prof["idle_s"]) <= 0.01 * prof["window_s"]
    assert sum(prof["idle_by_span"].values()) == pytest.approx(prof["idle_s"])
