"""The evaluator's level edges on the card's path, run on the CPU with stub
timing events in the circuit's event pool (utils/trace.py): a seeded
pure-encrypted MICRO GINX Clock calls no synchronize between its levels,
each ``LevelRecord.wall_s`` is the time between consecutive level events
(the Clock's start first), ``edge_overlap_levels`` counts exactly the
levels whose previous end event reports not done at their first rotation,
and with recovery off no level waits for the host."""

import itertools
import time

import numpy as np
import pytest
import torch

from oece_tpu_torch.circuits.gen import gen_adder
from oece_tpu_torch.runtime.evaluator import Circuit
from oece_tpu_torch.utils import trace
from test_torch_std import one_torch_thread  # noqa: F401

T = 3
BITS = 4


class StubClock:
    """A stand-in for the card's timeline: each recorded event takes the
    next reading of an uneven fake device clock (ms), and ``query``
    answers from a fixed script."""

    def __init__(self):
        self.now_ms = 0.0
        self.steps = itertools.cycle([1.25, 0.5, 3.0, 0.75, 2.0])
        self.answers = itertools.cycle([False, True, False, False, True])
        self.recorded, self.queried, self.synced = [], [], []


class StubEvent:
    def __init__(self, clock: StubClock):
        self.clock = clock

    def record(self):
        c = self.clock
        c.now_ms += next(c.steps)
        self.ms, self.host_ns = c.now_ms, time.perf_counter_ns()
        c.recorded.append(self)

    def query(self):
        done = next(self.clock.answers)
        self.clock.queried.append((self, done, time.perf_counter_ns()))
        return done

    def elapsed_time(self, end):
        return end.ms - self.ms

    def synchronize(self):
        self.clock.synced.append(time.perf_counter_ns())


def _run(traced: bool):
    """One seeded Clock on the card's path: the trace takes timing events
    (from a pool of stubs), and torch.cuda.synchronize is counted."""
    clock, syncs = StubClock(), []
    mp = pytest.MonkeyPatch()
    new_trace = Circuit._new_trace

    def card_trace(self):
        tr = new_trace(self)
        tr.cuda = True
        return tr

    mp.setattr(Circuit, "_new_trace", card_trace)
    mp.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(time.perf_counter_ns()))
    try:
        c = Circuit(set="MICRO", method="GINX", seed=17, device="cpu")
        c.LoadNetlist(gen_adder(BITS))
        c.setPlaintext(False)
        c.setEncrypted(True)
        c.setRecovery(False)
        c.setTrace(traced)
        c._trace_events.extend(StubEvent(clock) for _ in range(2000))
        rng = np.random.default_rng(23)
        a, b = rng.integers(0, 1 << BITS, T), rng.integers(0, 1 << BITS, T)
        bits = lambda v: (v[:, None] >> np.arange(BITS)) & 1  # noqa: E731
        c.SetInput([bits(a), bits(b)])
        c.Clock()
    finally:
        mp.undo()
    assert len(c._trace_events) > 1000  # every event was a stub
    (out,) = c.GetOutput()
    sums = (out.astype(np.int64) << np.arange(out.shape[1])).sum(1)
    return c, clock, syncs, sums, a + b


@pytest.fixture(scope="module", params=[False, True], ids=["untraced", "traced"])
def clocked(request):
    return _run(request.param)


def _levels(tr):
    return [s for s in tr.spans if s.name == "level"]


def _marks(c, clock):
    """The level events: recorded outside every level span (the Clock's
    start, then each level's end); untraced, every event is one."""
    levels = _levels(c.trace)
    return [e for e in clock.recorded
            if not any(s.start_ns <= e.host_ns <= s.end_ns for s in levels)]


def test_no_synchronize_between_levels(clocked):
    c, clock, syncs, sums, want = clocked
    assert syncs == []
    assert len(clock.synced) >= 1
    # finish() waits once, on the last level's event, after the Clock's levels
    last = max(e.host_ns for e in _marks(c, clock))
    assert all(t > last for t in clock.synced)
    np.testing.assert_array_equal(sums, want)


def test_wall_s_is_the_time_between_level_events(clocked):
    c, clock, _, _, _ = clocked
    marks = _marks(c, clock)
    recs = c.trace.records
    assert len(recs) == c.plan.depth and len(marks) == len(recs) + 1
    if not c.trace.recording:
        assert marks == clock.recorded
    for rec, e0, e1 in zip(recs, marks, marks[1:]):
        assert rec.wall_s == pytest.approx((e1.ms - e0.ms) / 1e3)
    assert sum(r.wall_s for r in recs) == pytest.approx((marks[-1].ms - marks[0].ms) / 1e3)
    # the pool has its events back for the next Clock
    assert set(map(id, marks)) <= set(map(id, c._trace_events))


def test_edge_overlap_counts_the_levels_whose_previous_end_is_not_done(clocked):
    c, clock, _, _, _ = clocked
    tr = c.trace
    if not tr.recording:
        assert clock.queried == [] and tr.counters == {}
        return
    marks = _marks(c, clock)
    rotating = [k for k, level in enumerate(c.plan.levels) if len(level["boot_op"])]
    assert 0 < len(rotating) < c.plan.depth
    # one query per rotating level, on the event just before it: the previous
    # level's end (the Clock's start before level 0)
    assert [e for e, _, _ in clock.queried] == [marks[k] for k in rotating]
    for (_, _, t), k in zip(clock.queried, rotating):
        s = _levels(tr)[k]
        assert s.start_ns <= t <= s.end_ns
    not_done = [k for (_, done, _), k in zip(clock.queried, rotating) if not done]
    assert 0 < len(not_done) < len(rotating)
    assert tr.counters["edge_overlap_levels"] == len(not_done)
    assert [s.attrs["level"] for s in _levels(tr)
            if s.attrs.get("edge_overlap_levels")] == not_done


def test_no_host_wait_inside_levels_with_recovery_off(clocked):
    c, _, _, _, _ = clocked
    tr = c.trace
    if not tr.recording:
        assert tr.spans == []
        return
    assert all("host_waits" not in s.attrs for s in _levels(tr))
    # the outputs' decryption in collect is the Clock's only wait
    assert tr.counters["host_waits"] == len(c.netlist.outputs)
    assert trace.ACTIVE is None
