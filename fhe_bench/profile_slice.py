"""A torch.profiler window over a slice of one evaluation's levels: the
device's busy and idle time there, the kernels that took most of it, and
the longest idle gaps named by what the host was doing.

The profiler on the card's machine drops a window's first records, so a
window opens with FILLS small launches, a wait of EDGE_S, and FILLS more
(the technique of the repository's chip_smoke.py), and waits EDGE_S again
before it closes.  The slice is marked with a record_function range; busy
time is the union of device records inside it.  Each kernel's own time is
counted from the end of every record before it, so a kernel that starts
early under programmatic dependent launch and waits is not counted twice.
"""

from __future__ import annotations

import time

import torch

EDGE_S = 0.25
FILLS = 16
SLICE = "fhe_bench.slice"
TOP = 10
NAME = 160  # characters of a kernel or host record name kept in the breakdown


def _fills() -> None:
    for _ in range(FILLS):
        torch.zeros(1, device="cuda")


class SliceProfiler:
    """Opened before level ``first`` and closed after level ``last`` - 1
    of an evaluation (port.level_hook)."""

    def __init__(self, first: int, last: int):
        self.first, self.last = first, last
        self.prof = None
        self._range = None

    def before(self, lv: int) -> None:
        if lv != self.first:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        _fills()
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        _fills()
        torch.cuda.synchronize()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()

    def after(self, lv: int) -> None:
        if lv != self.last - 1 or self.prof is None:
            return
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        time.sleep(EDGE_S)
        _fills()
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def read(self):
        """{busy_s, window_s, device_ops, idle_gaps}, or None where the
        window kept no device record inside the slice."""
        from torch.autograd import DeviceType

        if self.prof is None:
            return None
        evs = self.prof.events()
        marks = [e for e in evs if e.name == SLICE and e.device_type == DeviceType.CPU]
        if not marks:
            return None
        w0, w1 = marks[0].time_range.start, marks[0].time_range.end
        dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                     if e.device_type == DeviceType.CUDA and e.name != SLICE
                     and w0 <= e.time_range.start and e.time_range.end <= w1)
        if not dev:
            return None
        own, gaps, busy, end = {}, [], 0.0, w0
        for start, stop, name in dev:
            if start > end:
                gaps.append((start - end, end, start))
            t = max(0.0, stop - max(start, end))
            own[name] = own.get(name, 0.0) + t
            busy += t
            end = max(end, stop)
        if w1 > end:
            gaps.append((w1 - end, end, w1))
        host = [(e.time_range.start, e.time_range.end, e.name) for e in evs
                if e.device_type == DeviceType.CPU and e.name != SLICE]
        top_gaps = sorted(gaps, reverse=True)[:TOP]
        return dict(
            busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6,
            device_ops=[[n[:NAME], t / 1e6] for n, t in sorted(own.items(), key=lambda kv: -kv[1])[:TOP]],
            idle_gaps=[[_host_at(host, (a + b) / 2), g / 1e6] for g, a, b in top_gaps],
        )


def _host_at(host, t: float) -> str:
    """The innermost host record that spans time t, else the last one
    that ended before it."""
    inner, last = None, None
    for start, stop, name in host:
        if start <= t <= stop and (inner is None or stop - start < inner[1] - inner[0]):
            inner = (start, stop, name)
        elif stop < t and (last is None or stop > last[1]):
            last = (start, stop, name)
    if inner:
        return inner[2][:NAME]
    return f"after {last[2]}"[:NAME] if last else "no host record"
