"""The port's spans and counters (utils/trace.py, ``Circuit.setTrace``) on
the CPU at MICRO, GINX and binary-base AP: spans nest under their parents
with the Clock's id, every level has its phase spans, the rotation counts
match the gates and, for AP, the select bits of each rotation's own a2N
(``fhe_bench.spans.ap_live``), GINX's step GEMM rows (``padded_lanes``),
the key bytes its split GEMMs load before their wait
(``key_prefetch_bytes``) and the
linear runs and gates match the plan; with tracing off a Clock
makes no span, no CUDA event and no profiler range."""

import dataclasses

import numpy as np
import pytest
import torch

from fhe_bench.spans import ap_live
from oece_tpu_torch.circuits.gen import gen_adder
from oece_tpu_torch.fhe import boot, rot
from oece_tpu_torch.fhe.params import MICRO, MICRO_A
from oece_tpu_torch.runtime.evaluator import Circuit, linear_runs
from oece_tpu_torch.utils import trace
from test_torch_linear_runs import chain_bristol
from test_torch_std import one_torch_thread  # noqa: F401

MICRO_AP2 = dataclasses.replace(MICRO_A, name="MICRO_AP2", B_r=2)
T = 3
SETS = {"GINX": MICRO, "AP": MICRO_AP2}


@pytest.fixture(scope="module", params=["GINX", "AP"])
def traced(request):
    """A MICRO adder circuit of each method with tracing on, clocked twice
    (a Reset between), and its rotations' a2N recorded."""
    method = request.param
    c = Circuit(set=SETS[method], method=method, seed=7, device="cpu")
    c.LoadNetlist(gen_adder(4))
    c.setEncrypted(True)
    c.setPlaintext(False)
    c.setTrace(True)
    a2Ns = []
    orig = boot.blind_rotation

    def recording(acc, a2N, keys):
        a2Ns.append(a2N.clone())
        return orig(acc, a2N, keys)

    mp = pytest.MonkeyPatch()
    mp.setattr(boot, "blind_rotation", recording)
    rng = np.random.default_rng(3)
    traces = []
    for _ in range(2):
        c.Reset()
        c.SetInput([rng.integers(0, 2, (T, 4)), rng.integers(0, 2, (T, 4))])
        c.Clock()
        traces.append(c.trace)
    mp.undo()
    yield method, c, traces, a2Ns


def _children(tr, k):
    return [s for s in tr.spans if s.parent == k]


def test_spans_nest_with_parent_and_clock_id(traced):
    _, c, traces, _ = traced
    for request, tr in enumerate(traces, start=1):
        assert tr.recording and tr.clock == (0, request)
        assert [s.name for s in tr.spans if s.parent < 0] == ["set_input", "clock"]
        for k, s in enumerate(tr.spans):
            assert s.clock == (0, request) and s.start_ns <= s.end_ns
            if s.parent >= 0:
                up = tr.spans[s.parent]
                assert s.parent < k and up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    assert trace.ACTIVE is None


def test_each_level_has_its_phase_spans(traced):
    method, c, traces, _ = traced
    tr = traces[-1]
    (clock,) = [k for k, s in enumerate(tr.spans) if s.name == "clock"]
    levels = [k for k in range(len(tr.spans)) if tr.spans[k].name == "level"]
    assert [tr.spans[k].parent for k in levels] == [clock] * c.plan.depth
    assert [tr.spans[k].attrs["level"] for k in levels] == list(range(c.plan.depth))
    assert [s.name for s in _children(tr, clock)][-1] == "collect"
    for k, level in zip(levels, c.plan.levels):
        names = [s.name for s in _children(tr, k)]
        if len(level["boot_op"]):
            assert names == ["level.host", "group.gather", "boot", "group.check",
                             "group.scatter", "level.linear"], names
            (b,) = [j for j in range(len(tr.spans)) if tr.spans[j].parent == k
                    and tr.spans[j].name == "boot"]
            assert [s.name for s in _children(tr, b)] == ["boot.pre", "boot.rotation", "boot.post"]
        else:
            assert names == ["level.host", "level.linear"]
    live = [s for s in tr.spans if s.name == "ap.live_count"]
    assert live == []  # the CPU runs the plain rotation, which copies nothing to the host
    assert all(s.device_ms is None for s in tr.spans)  # no CUDA events on the CPU


def test_rotation_counts_match_the_gates(traced):
    method, c, traces, _ = traced
    tr = traces[-1]
    gates = sum(len(level["boot_op"]) for level in c.plan.levels)
    rotating = sum(1 for level in c.plan.levels if len(level["boot_op"]))
    assert tr.counters["lanes"] == gates * T == tr.total_bootstraps
    assert tr.counters["rotations"] == rotating
    for s in tr.spans:
        if s.name == "level":
            rec = tr.records[s.attrs["level"]]
            assert s.attrs.get("lanes", 0) == rec.boot_gates * T == rec.bootstraps
    if method == "GINX":
        assert tr.counters["steps"] == rotating * c.params.n
    # recovery's host-branch check copies bits and errors once each per group,
    # the output collection once per word
    assert tr.counters["host_waits"] == 2 * rotating + len(c.netlist.outputs)


def gate_tile(B: int, p) -> int:
    """The rotated form's step GEMM tile for B gates (rev2 keys)."""
    return rot.gemm_config(B, p.N, 4 * p.d_g_used, 2)[0]


def gemm_rows(B: int, p) -> int:
    return rot.gemm_rows(B, gate_tile(B, p))


def prefetch_bytes(B: int, p) -> int:
    return rot.key_prefetch_bytes(p.n, p.N, 4 * p.d_g_used * rot.TILE, 2, gate_tile(B, p))


def test_padded_lanes_are_the_step_gemms_gate_rows(traced):
    """GINX counts each rotation's step GEMM rows beside its lanes (rev2
    keys: ``rot.gemm_config``); AP counts none."""
    method, c, traces, _ = traced
    tr = traces[-1]
    rots = [s for s in tr.spans if s.name == "boot.rotation"]
    if method == "AP":
        assert "padded_lanes" not in tr.counters
        assert not any("padded_lanes" in s.attrs for s in rots)
        return
    assert c.keys.rev2 is not None
    for s in rots:
        assert s.attrs["padded_lanes"] == gemm_rows(s.attrs["lanes"], c.params)
    want = sum(gemm_rows(len(level["boot_op"]) * T, c.params) for level in c.plan.levels
               if len(level["boot_op"]))
    assert tr.counters["padded_lanes"] == want


def test_key_prefetch_bytes_are_the_plans_sum(traced):
    """A narrow GINX rotation counts the key bytes its split GEMMs load
    ahead of the step chain, before their wait for the digits kernel
    (``rot.key_prefetch_bytes`` over ``rot.gemm_config``'s tile); a
    rotation over 16 lanes and AP count none."""
    method, c, traces, _ = traced
    tr = traces[-1]
    rots = [s for s in tr.spans if s.name == "boot.rotation"]
    if method == "AP":
        assert "key_prefetch_bytes" not in tr.counters
        assert not any("key_prefetch_bytes" in s.attrs for s in rots)
        return
    p = c.params
    assert boot.ROT_MEGA and any(s.attrs["lanes"] <= 16 for s in rots)
    for s in rots:
        want = prefetch_bytes(s.attrs["lanes"], p)
        assert s.attrs["key_prefetch_bytes"] == want and (want > 0) == (s.attrs["lanes"] <= 16)
    want = sum(prefetch_bytes(len(level["boot_op"]) * T, p)
               for level in c.plan.levels if len(level["boot_op"]))
    assert tr.counters["key_prefetch_bytes"] == want > 0


def _traced_chains(tmp_path, T_chain: int):
    """``chain_bristol``'s netlist at MICRO GINX, T_chain cases a word
    (levels of 3 and 6 gates), clocked once with tracing on; the Circuit
    and its input words."""
    path = str(tmp_path / "chains.txt")
    chain_bristol(path)
    c = Circuit(set="MICRO", method="GINX", seed=21, device="cpu")
    c.ReadFile(path)
    c.setPlaintext(False)
    c.setEncrypted(True)
    c.setRecovery(False)
    rng = np.random.default_rng(8)
    words = [rng.integers(0, 2, (T_chain, 6)) for _ in range(2)]
    c.setTrace(True)
    c.SetInput(words)
    c.Clock()
    return c, words


def test_linear_and_padding_counters_match_the_plan(tmp_path):
    """A netlist of linear chains at T = 8 (levels of 24 and 48 lanes, past
    the split GEMM's 16): ``linear_runs`` and ``linear_gates`` in each
    level's ``level.linear`` span equal the plan's runs and gates,
    ``padded_lanes`` the rows of gemm_config's gate tiles; with tracing
    off the same Clock records nothing."""
    c, words = _traced_chains(tmp_path, 8)
    tr = c.trace
    runs = [len(linear_runs(level, c._slot)) for level in c.plan.levels]
    gates = [len(level["lin_op"]) for level in c.plan.levels]
    assert tr.counters["linear_runs"] == sum(runs) > len(c.plan.levels)
    assert tr.counters["linear_gates"] == sum(gates)
    linear = [s for s in tr.spans if s.name == "level.linear"]
    assert [tr.spans[s.parent].attrs["level"] for s in linear] == list(range(c.plan.depth))
    for s, r, g in zip(linear, runs, gates):
        assert s.attrs == ({"linear_runs": r, "linear_gates": g} if r else {})
    lanes = [len(level["boot_op"]) * 8 for level in c.plan.levels if len(level["boot_op"])]
    assert lanes == [24, 48]
    assert tr.counters["padded_lanes"] == gemm_rows(24, c.params) + gemm_rows(48, c.params) == 32 + 48
    assert tr.counters["key_prefetch_bytes"] == 0  # the tiled GEMMs prefetch nothing
    assert tr.counters["lanes"] == sum(lanes)
    c.setTrace(False)
    c.Reset()
    c.SetInput(words)
    c.Clock()
    assert not c.trace.recording and c.trace.spans == [] and c.trace.counters == {}


def test_padded_lanes_fit_the_gate_tile_at_132_lanes(tmp_path):
    """The same netlist at T = 44, levels of 132 and 264 lanes: each
    rotation counts the gate rows of tiles fitted to B in steps of 16
    (``rot.gemm_config``), one tile of 144 and two of 144, not 256 and two
    of 256."""
    c, _ = _traced_chains(tmp_path, 44)
    rots = [s for s in c.trace.spans if s.name == "boot.rotation"]
    assert [s.attrs["lanes"] for s in rots] == [132, 264]
    assert [s.attrs["padded_lanes"] for s in rots] == [gemm_rows(132, c.params), gemm_rows(264, c.params)]
    assert c.trace.counters["padded_lanes"] == 144 + 2 * 144


@pytest.mark.parametrize("traced", ["AP"], indirect=True)
def test_ap_live_counts_match_the_select_bits(traced):
    _, c, traces, a2Ns = traced
    p = {"N": c.params.N, "B_r": c.params.B_r}
    rots = [s for tr in traces for s in tr.spans if s.name == "boot.rotation"]
    assert len(rots) == len(a2Ns)
    for s, a2N in zip(rots, a2Ns):
        pairs, steps = ap_live(a2N, p)
        assert (s.attrs["live_pairs"], s.attrs["steps"]) == (pairs, steps)
        assert 0 < steps <= c.params.n * c.params.d_r
    tr = traces[-1]
    assert tr.counters["live_pairs"] == sum(s.attrs["live_pairs"] for s in tr.spans
                                            if s.name == "boot.rotation")


def test_self_times_subtract_children():
    tr = trace.Trace(circuit="c", mode="encrypted", recording=True)
    with tr.span("clock"):
        with tr.span("level", level=0):
            with tr.span("level.host"):
                pass
            tr.count("host_waits")
        tr.count("host_waits", 2)
    clock, level, host = tr.spans
    assert (clock.attrs, level.attrs, host.attrs) == ({"host_waits": 3}, {"level": 0, "host_waits": 1}, {})
    own = tr.self_times()
    assert own["level.host"] == pytest.approx(host.seconds)
    assert own["level"] == pytest.approx(level.seconds - host.seconds)
    assert own["clock"] == pytest.approx(clock.seconds - level.seconds)


def _refuse(*args, **kwargs):
    raise AssertionError("made while tracing is off")


@pytest.mark.parametrize("method", ["GINX", "AP"])
def test_tracing_off_makes_no_span_event_or_range(method, monkeypatch):
    c = Circuit(set=SETS[method], method=method, seed=9, device="cpu")
    c.LoadNetlist(gen_adder(2))
    c.setVerify(True)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    rng = np.random.default_rng(4)
    for _ in range(2):
        c.Reset()
        c.SetInput([rng.integers(0, 2, (2, 2)), rng.integers(0, 2, (2, 2))])
        c.Clock()
        assert not c.trace.recording and c.trace.spans == [] and c.trace.counters == {}
        assert len(c.trace.records) == c.plan.depth
    assert trace.ACTIVE is None
    assert c.bad_gate_counts == {}


def test_verify_counts_one_host_wait_per_group_and_compound_spans():
    """Verify mode on the host branch copies each group's bits once; a
    compound XOR group gathers and bootstraps twice (AND pair, then OR)."""
    c = Circuit(set="MICRO", method="GINX", seed=11, device="cpu", xor_mode="compound")
    c.LoadNetlist(gen_adder(2))
    c.setVerify(True)
    c.setTrace(True)
    rng = np.random.default_rng(5)
    c.SetInput([rng.integers(0, 2, (2, 2)), rng.integers(0, 2, (2, 2))])
    c.Clock()
    tr = c.trace
    groups = sum(1 for s in tr.spans if s.name == "group.check")
    assert tr.counters["host_waits"] == groups + len(c.netlist.outputs)
    assert tr.counters["lanes"] == tr.total_bootstraps
    gathers = sum(1 for s in tr.spans if s.name == "group.gather")
    boots = sum(1 for s in tr.spans if s.name == "boot")
    assert gathers == boots > groups  # compound groups run two batches
    assert c.bad_gate_counts.get("OUTPUT", 0) == 0


def test_spans_are_profiler_ranges_only_under_a_profiler(monkeypatch):
    """Under torch.profiler a traced Clock's spans are ``oece.<name>``
    ranges, the device spans' user ranges; without a profiler it opens
    none."""
    c = Circuit(set="MICRO", method="GINX", seed=13, device="cpu")
    c.LoadNetlist(gen_adder(2))
    c.setEncrypted(True)
    c.setPlaintext(False)
    c.setTrace(True)
    rng = np.random.default_rng(6)
    words = [rng.integers(0, 2, (2, 2)), rng.integers(0, 2, (2, 2))]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        c.SetInput(words)
        c.Clock()
    evs = [e for e in prof.events() if e.name.startswith("oece.")]
    ranges = [e.name for e in evs]
    assert ranges == ["oece." + s.name for s in sorted(c.trace.spans, key=lambda s: s.start_ns)]
    assert {e.name for e in evs if e.is_user_annotation} == {
        "oece.boot", "oece.boot.pre", "oece.boot.rotation", "oece.boot.post"}
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    c.Reset()
    c.SetInput(words)
    c.Clock()
    assert len(c.trace.spans) == len(ranges)
