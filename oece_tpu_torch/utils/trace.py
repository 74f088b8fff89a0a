"""Structured tracing / observability for circuit evaluation.

Role parity+: the reference instruments ``Clock`` with wall-clock macros and
prints manager/execution time and an efficiency percentage
(src/circuit.cpp:533-570), plus live ``\\r`` progress lines (815-816).  This
module keeps those human-readable outputs (runtime/evaluator.py) and adds
what the reference lacks: machine-readable per-level records with gate
counts and bootstraps/sec, dumpable as JSON for regression tracking.

The port's own copy of ``oece_tpu.utils.trace``, kept in step with it for
``LevelRecord``, ``summary()`` and ``dump_json()`` (tests/test_torch_copies.py):
the port imports nothing of the JAX package.  The port's copy also carries
spans and counters, which the JAX package's lacks.  They are recorded only
for a Circuit with ``setTrace(True)``:

  * a span is a named interval on the host's ``perf_counter_ns`` clock, with
    its parent span, the Clock's id (cycle since Reset, request sequence of
    the circuit) and integer attributes; while it is open under an active
    profiler it is also a profiler range named ``oece.<name>``, which the
    profiler records on the clock of its device records;
  * a span opened with ``device=True`` runs work on the card: its range is
    a ``torch.profiler.record_function`` (the profiler also makes a device
    copy of it), and on a CUDA circuit it takes a pair of CUDA events on the
    current stream, which ``Trace.finish`` reads once, after the Clock's
    last host wait;
  * ``count(name, k)`` adds k to the Clock's counter ``name`` and to the
    attribute ``name`` of every open span, so a level span holds the counts
    made inside it.

On a CUDA circuit, traced or not, a level's ``wall_s`` is its time on the
device: ``begin`` records a timing event at the Clock's start, ``add`` one
at each level's end, and ``finish`` reads them once, after the Clock's last
host wait, so the host never waits for a level to time it.  Under
``setTrace(True)`` a level's first rotation also asks whether the previous
level's end event has completed (``edge``): where it has not, the host
queued this level while the device still ran the previous one, and the
Clock's counter ``edge_overlap_levels`` counts it.  Every event, the
spans' and the levels', comes from the circuit's ``event_pool``.

Code without a Circuit (fhe/boot.py, fhe/ap.py) finds the Clock's trace
through the module handle ``ACTIVE``, which is None unless a traced Clock
is running: ``span``, ``count`` and ``edge`` then cost one None check and
make no event, no profiler range and no record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

import torch

# the Trace of the traced Clock in flight, else None
ACTIVE: Optional["Trace"] = None
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class LevelRecord:
    level: int
    boot_gates: int      # bootstrap gates in the level (pre-batch)
    linear_gates: int
    batch: int           # test-case batch T
    wall_s: float
    bootstraps: int      # actual bootstraps run (incl. compound-XOR rewrites)

    @property
    def boots_per_sec(self) -> float:
        return self.bootstraps / self.wall_s if self.wall_s > 0 else 0.0


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int                # host perf_counter_ns
    parent: int                  # index of the enclosing span in Trace.spans, -1 at the top
    clock: Tuple[int, int]       # (cycle since Reset, request sequence of the circuit)
    attrs: Dict[str, int]
    end_ns: int = 0
    device_ms: Optional[float] = None  # CUDA-event time of a device span

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Trace:
    """One Clock() invocation's trace."""

    circuit: str
    mode: str            # 'plaintext' | 'encrypted' | 'verify'
    records: List[LevelRecord] = dataclasses.field(default_factory=list)
    t_start: float = 0.0
    total_s: float = 0.0
    recording: bool = False  # spans and counters on (Circuit.setTrace)
    cuda: bool = False       # level walls and device spans take CUDA events
    clock: Tuple[int, int] = (0, 0)
    spans: List[Span] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    # CUDA timing events to reuse, shared by the traces of one circuit:
    # finish() returns the ones it read
    event_pool: list = dataclasses.field(default_factory=list)
    _open: List[int] = dataclasses.field(default_factory=list)
    _events: list = dataclasses.field(default_factory=list)
    _marks: list = dataclasses.field(default_factory=list)  # the Clock's start, then each level's end
    _edge: object = None  # the last mark, until a level's first rotation queries it

    def begin(self) -> None:
        self.t_start = time.perf_counter()
        if self.cuda:
            self._mark()

    def end(self) -> None:
        self.total_s = time.perf_counter() - self.t_start

    def add(self, rec: LevelRecord) -> None:
        """A level's record, added at the level's end; on the card it records
        the level's end event, and finish() sets ``rec.wall_s`` to the
        device time since the previous one."""
        self.records.append(rec)
        if self.cuda:
            self._mark()

    def _event(self):
        pool = self.event_pool
        return pool.pop() if pool else torch.cuda.Event(enable_timing=True)

    def _mark(self) -> None:
        ev = self._event()
        ev.record()
        self._marks.append(ev)
        self._edge = ev

    def edge(self) -> None:
        """At a rotation: the level's first counts ``edge_overlap_levels``
        where the previous level's end event (the Clock's start before the
        first level) has not completed."""
        ev, self._edge = self._edge, None
        if ev is not None and not ev.query():
            self.count("edge_overlap_levels")

    def span(self, name: str, device: bool = False, **attrs: int) -> "_Open":
        """Record the enclosed block as span ``name``."""
        return _Open(self, Span(name, 0, self._open[-1] if self._open else -1, self.clock, attrs),
                     device)

    def count(self, name: str, k: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + k
        for i in self._open:
            attrs = self.spans[i].attrs
            attrs[name] = attrs.get(name, 0) + k

    def finish(self) -> None:
        """Read the level walls' and the device spans' events; the caller
        has waited for the work they enclose."""
        marks, self._marks, self._edge = self._marks, [], None
        if marks:
            marks[-1].synchronize()
            for rec, e0, e1 in zip(self.records, marks, marks[1:]):
                rec.wall_s = e0.elapsed_time(e1) / 1e3
            self.event_pool += marks
        if self._events:
            self._events[-1][2].synchronize()
            for s, e0, e1 in self._events:
                s.device_ms = e0.elapsed_time(e1)
                self.event_pool += (e0, e1)
            self._events = []

    def self_times(self) -> Dict[str, float]:
        """Host seconds per span name, less the time of its child spans."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.seconds
            if s.parent >= 0:
                parent = self.spans[s.parent].name
                out[parent] = out.get(parent, 0.0) - s.seconds
        return out

    @property
    def total_bootstraps(self) -> int:
        return sum(r.bootstraps for r in self.records)

    @property
    def boots_per_sec(self) -> float:
        return self.total_bootstraps / self.total_s if self.total_s > 0 else 0.0

    def summary(self) -> dict:
        return {
            "circuit": self.circuit,
            "mode": self.mode,
            "levels": len(self.records),
            "total_s": round(self.total_s, 4),
            "total_bootstraps": self.total_bootstraps,
            "bootstraps_per_sec": round(self.boots_per_sec, 1),
            "max_level_wall_s": round(
                max((r.wall_s for r in self.records), default=0.0), 4
            ),
        }

    def dump_json(self, path: Optional[str] = None) -> str:
        doc = {
            "summary": self.summary(),
            "levels": [dataclasses.asdict(r) for r in self.records],
        }
        s = json.dumps(doc, indent=1)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


class _Open:
    """A span while it is open: its start, its events, its profiler range
    (opened only while a profiler runs: an idle one records nothing)."""

    __slots__ = ("trace", "span", "device", "events", "range")

    def __init__(self, trace: Trace, span: Span, device: bool):
        self.trace, self.span, self.device, self.events, self.range = trace, span, device, None, None

    def __enter__(self) -> Span:
        tr, s = self.trace, self.span
        tr._open.append(len(tr.spans))
        tr.spans.append(s)
        if self.device and tr.cuda:
            self.events = (tr._event(), tr._event())
            self.events[0].record()
        if torch.autograd._profiler_enabled():
            # a device span is a user range, of which the profiler also makes a
            # device copy over the kernels it launches; the others take the
            # cheaper range, one host record each
            rf = torch.profiler.record_function if self.device else torch._C._profiler._RecordFunctionFast
            self.range = rf("oece." + s.name)
            self.range.__enter__()
        s.start_ns = time.perf_counter_ns()
        return s

    def __exit__(self, *exc) -> None:
        tr, s = self.trace, self.span
        s.end_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.events is not None:
            self.events[1].record()
            tr._events.append((s, *self.events))
        tr._open.pop()


def span(name: str, device: bool = False, **attrs: int):
    """``ACTIVE.span(...)``, or a no-op context when no traced Clock runs."""
    tr = ACTIVE
    return _OFF if tr is None else tr.span(name, device, **attrs)


def count(name: str, k: int = 1) -> None:
    """``ACTIVE.count(...)`` when a traced Clock runs."""
    tr = ACTIVE
    if tr is not None:
        tr.count(name, k)


def edge() -> None:
    """``ACTIVE.edge()`` when a traced Clock runs."""
    tr = ACTIVE
    if tr is not None:
        tr.edge()
