"""The program's own spans, for a traced run: evaluations of the cell
with the port's tracing on (``Circuit.setTrace``; oece_tpu_torch/utils/
trace.py), and the readers of five per-layer metric families of the
``.wide``/``.narrow`` kind (``READERS``): level_lead_ms,
host_waits_per_level, keyswitch_share, idle_rot_share and idle_edge_ms.
Each reader takes a run dict and gives None where the run holds no
program spans.  run.py does not call ``collect`` yet, and BENCHMARK.json
names none of the five: each waits for the change that adds the call and
the entries (a reader file under metrics/ per family then imports its
function from here).

``collect`` builds a fresh Circuit from the cell's keys with tracing on,
runs EVALUATIONS whole evaluations for the span metrics, then one more
under ``profile_slice.SliceProfiler`` over the traffic's profiled levels
(up to three tries, as the traced run's own profile) for the device-idle
split: the device interval of every rotation is the profiler's device
copy of its ``oece.boot.rotation`` range, or else the first to the last
kernel launched inside that range; device time outside every rotation
interval is the level edges' idle.  Each evaluation's words and output
ciphertexts are appended to the caller's lists, so the reference judges
them too.  The traced run's own evaluations, with tracing off, are not
touched.

Run alone on the card, it sets the cell up as run.py does, times
``--evals`` evaluations with tracing off, then ``collect``, judges every
output and prints one JSON line (the five metrics under the cell's
width, the evaluation medians with tracing off and on, ``correct``):

    python3 fhe_bench/program_trace.py --workload <cell> --seed <n> [--evals 5]
"""

from __future__ import annotations

import bisect
import statistics
import sys
import time

EVALUATIONS = 2
ROT = "boot.rotation"
PREFIX = "oece."
NOWHERE = "(no program span)"
RUNTIME = ("cuda", "cu")  # host records of CUDA API calls (cuda*, cu*)


def collect(cfg, traffic, p, sk, keys, path, enc_seed: int, device, draw, inputs, outputs) -> dict:
    """{program_spans, program_evals[, program_profile]}; ``draw()``
    gives one request's words."""
    import torch

    from fhe_bench import port
    from fhe_bench.profile_slice import SliceProfiler

    c = port.circuit(cfg, traffic, p, sk, keys, str(path), enc_seed, device)
    c.setTrace(True)

    def evaluate() -> float:
        words = draw()
        t0 = time.perf_counter()
        cts = port.evaluate(c, words, device)
        seconds = time.perf_counter() - t0
        inputs.append(words)
        outputs.append([x.cpu().numpy() for x in cts])
        return seconds

    evals, traces = [], []
    for _ in range(EVALUATIONS):
        evals.append(evaluate())
        traces.append(c.trace)
    out = {"program_spans": span_numbers(traces), "program_evals": evals}
    if torch.device(device).type != "cuda":
        return out
    first, last = traffic.get("profile_levels") or (0, len(c.plan.levels))
    prof = None
    port.level_hook(c, lambda lv: prof.before(lv), lambda lv: prof.after(lv))
    for _ in range(3):
        prof = SliceProfiler(first, last)
        evaluate()
        out["program_profile"] = profile_numbers(prof.prof.events(), last - first) if prof.prof else None
        if out["program_profile"] is not None:
            break
        print("program profile: the window kept no device record inside the slice; again",
              file=sys.stderr, flush=True)
    return out


def span_numbers(traces) -> dict:
    """Sums over the traces' level spans: levels, the host waits counted
    inside them, and for each level that runs a rotation its lead, the host
    time from the end of the previous level's ``level.sync`` (or, without
    one, of the previous level; the Clock's first level: its own start)
    to the start of its first ``boot.rotation``; the device time of the
    gate batches and of their ``boot.post``; self time per span name and
    the counters, summed."""
    levels = waits = lead_levels = lead_ns = 0
    boot_ms = post_ms = 0.0
    device = False
    self_s: dict = {}
    counters: dict = {}
    for tr in traces:
        level_of, first_rot, sync_end = {}, {}, {}
        prev_end = None
        for k, s in enumerate(tr.spans):
            lv = k if s.name == "level" else level_of.get(s.parent)
            if lv is not None:
                level_of[k] = lv
            if s.name == ROT and lv is not None:
                first_rot.setdefault(lv, s.start_ns)
            elif s.name == "level.sync" and lv is not None:
                sync_end[lv] = s.end_ns
            elif s.name in ("boot", "boot.post") and s.device_ms is not None:
                device = True
                if s.name == "boot":
                    boot_ms += s.device_ms
                else:
                    post_ms += s.device_ms
        for k, s in enumerate(tr.spans):
            if s.name != "level":
                continue
            levels += 1
            waits += s.attrs.get("host_waits", 0)
            if k in first_rot:
                lead_levels += 1
                lead_ns += first_rot[k] - (s.start_ns if prev_end is None else prev_end)
            prev_end = sync_end.get(k, s.end_ns)
        for name, v in tr.self_times().items():
            self_s[name] = self_s.get(name, 0.0) + v
        for name, v in tr.counters.items():
            counters[name] = counters.get(name, 0) + v
    return dict(evaluations=len(traces), levels=levels, host_waits=waits,
                lead_levels=lead_levels, lead_s=lead_ns / 1e9,
                boot_device_s=boot_ms / 1e3 if device else None,
                post_device_s=post_ms / 1e3 if device else None,
                self_s=self_s, counters=counters)


def profile_numbers(events, levels: int):
    """The device-idle split of a SliceProfiler's window (its torch.profiler
    ``events()``), or None where the window kept no device record in the
    slice.  Where kernels appear to start before the host calls that
    launched them (the two share a correlation id), the device records are
    moved later (``clock_shift``), so that the host spans that name the
    idle are on the device records' clock."""
    from torch.autograd import DeviceType

    from fhe_bench.profile_slice import SLICE

    marks = [e for e in events if e.name == SLICE and e.device_type == DeviceType.CPU]
    if not marks:
        return None
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    host = [e for e in events if e.device_type == DeviceType.CPU]
    launch = {e.id: e.time_range.start for e in host if e.id > 0 and e.name.startswith(RUNTIME)}
    dev = [(e.time_range.start, e.time_range.end, e.name, e.id) for e in events
           if e.device_type == DeviceType.CUDA and e.name != SLICE]
    leads = [launch[k] - a for a, _, name, k in dev if k in launch and not name.startswith(PREFIX)]
    shift = clock_shift(leads)
    dev = [(a + shift, b + shift, name, k) for a, b, name, k in dev]
    busy = [(a, b) for a, b, name, _ in dev if not name.startswith(PREFIX)]
    if not any(w0 <= a and b <= w1 for a, b in busy):
        return None
    rot = [(a, b) for a, b, name, _ in dev if name == PREFIX + ROT]
    source = "device copy of oece.boot.rotation"
    if not rot:
        source = "kernels launched inside oece.boot.rotation"
        order = sorted((t, k) for k, t in launch.items())
        kernel = {k: (a, b) for a, b, name, k in dev if not name.startswith(PREFIX)}
        rot = [launched(order, kernel, e.time_range.start, e.time_range.end)
               for e in host if e.name == PREFIX + ROT]
        rot = [r for r in rot if r is not None]
    spans = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):]) for e in host
             if e.name.startswith(PREFIX)]
    out = split_idle(w0, w1, busy, rot, spans)
    out.update(levels=levels, rotations_source=source, clock_shift_us=shift, launch_pairs=len(leads))
    return out


def clock_shift(leads) -> float:
    """How far to move the device records later, given each kernel's lead
    over its launch (launch time less start time): a kernel launched onto
    an idle device starts a launch latency after its call, so the leads of
    those, the largest, tell how far the device's clock runs early.  The
    99th percentile, not the maximum: a stray record must not move them."""
    if not leads:
        return 0.0
    ranked = sorted(leads)
    return max(0.0, ranked[int(0.99 * (len(ranked) - 1))])


def launched(launch, kernel, h0: float, h1: float):
    """(first start, last end) of the device records whose launch, a host
    runtime record sharing their correlation id, lies in [h0, h1]."""
    i = bisect.bisect_left(launch, (h0, -1))
    got = [kernel[k] for t, k in launch[i:bisect.bisect_right(launch, (h1, float("inf")))]
           if k in kernel]
    return (min(a for a, _ in got), max(b for _, b in got)) if got else None


def _union(intervals, w0: float, w1: float) -> list:
    out: list = []
    for a, b in sorted((max(a, w0), min(b, w1)) for a, b in intervals):
        if a >= b:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def split_idle(w0: float, w1: float, busy, rot, host) -> dict:
    """Window [w0, w1] in microseconds on the profiler's clock; ``busy``
    the device records that count as work, ``rot`` the rotations' device
    intervals, ``host`` the program's (start, end, span name).  Seconds of
    the window, busy, idle, rotation intervals, idle inside them and idle
    outside them, and the idle seconds by the innermost program span the
    host was in."""
    work = _union(busy, w0, w1)
    gaps, end = [], w0
    for a, b in work:
        if a > end:
            gaps.append([end, a])
        end = b
    if w1 > end:
        gaps.append([end, w1])
    rots = _union(rot, w0, w1)
    idle = sum(b - a for a, b in gaps)
    rot_idle = _overlap(gaps, rots)
    cuts = sorted({w0, w1} | {t for a, b, _ in host for t in (a, b) if w0 < t < w1})
    segments = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        inner = min(((e - s, name) for s, e, name in host if s <= mid <= e), default=(0, NOWHERE))
        segments.append([a, b, inner[1]])
    by_span: dict = {}
    i = 0
    for a, b, name in segments:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        t, j = 0.0, i
        while j < len(gaps) and gaps[j][0] < b:
            t += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
        if t > 0:
            by_span[name] = by_span.get(name, 0.0) + t / 1e6
    return dict(window_s=(w1 - w0) / 1e6, busy_s=sum(b - a for a, b in work) / 1e6,
                idle_s=idle / 1e6, rot_s=sum(b - a for a, b in rots) / 1e6,
                rot_idle_s=rot_idle / 1e6, edge_idle_s=(idle - rot_idle) / 1e6,
                idle_by_span=by_span)


def level_lead_ms(run):
    """The evaluator's host time before a level's rotation: the mean over
    the traced evaluations' levels that run one of the time from the end
    of the previous level's ``level.sync`` span to the start of the
    level's first ``boot.rotation`` span (gate counts, gather, gate prep,
    the accumulator's set-up and their launches)."""
    spans = run.get("program_spans")
    if not spans or not spans["lead_levels"]:
        return None
    return 1e3 * spans["lead_s"] / spans["lead_levels"]


def host_waits_per_level(run):
    """The points where the host waits for the device (the level's
    synchronize, AP's live-count copy, the checks' copies), counted inside
    each ``level`` span, the mean over the traced evaluations' levels; the
    output collection's copies fall outside the levels."""
    spans = run.get("program_spans")
    if not spans or not spans["levels"]:
        return None
    return spans["host_waits"] / spans["levels"]


def keyswitch_share(run):
    """Share of the gate batches' device time (CUDA events of the ``boot``
    spans) spent in ``boot.post``: sample extract, the switch from Q to
    Q_ks, the key switch and the switch to q."""
    spans = run.get("program_spans")
    if not spans or not spans["boot_device_s"]:
        return None
    return 100.0 * spans["post_device_s"] / spans["boot_device_s"]


def idle_rot_share(run):
    """Share of the rotations' device intervals in the profiled slice in
    which the device ran nothing: the step loops' launch gaps and AP's
    live-count round trip."""
    prof = run.get("program_profile")
    if not prof or prof["rot_s"] <= 0:
        return None
    return 100.0 * prof["rot_idle_s"] / prof["rot_s"]


def idle_edge_ms(run):
    """Device-idle milliseconds per level outside every rotation's device
    interval in the profiled slice: the evaluator's level edges.  Prints
    the slice's idle time by the innermost program span the host was in
    to standard error."""
    prof = run.get("program_profile")
    if not prof or not prof["levels"]:
        return None
    idle = prof["idle_s"]
    print(f"program profile: idle {1e3 * idle:.3f} ms of {1e3 * prof['window_s']:.3f} ms over "
          f"{prof['levels']} levels, by innermost program span:", file=sys.stderr)
    for name, s in sorted(prof["idle_by_span"].items(), key=lambda kv: -kv[1]):
        print(f"  {name:<20} {1e3 * s:10.3f} ms {100 * s / idle if idle else 0:6.1f}%", file=sys.stderr)
    return 1e3 * prof["edge_idle_s"] / prof["levels"]


READERS = {f.__name__: f for f in (level_lead_ms, host_waits_per_level, keyswitch_share,
                                   idle_rot_share, idle_edge_ms)}


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The cell's circuit parse, keys and request draws from ``seed``, with
    run.py's seed streams (stream 6 seeds the traced Circuit's encryptions)."""
    import numpy as np

    from fhe_bench import keydraw, port, reference
    from fhe_bench import run as bench_run

    path = bench_run.ROOT / traffic["circuit"]
    circ = reference.parse(str(path))

    def stream(k: int):
        return np.random.default_rng([seed % 2**64, k])

    key_seed, enc_seed, host_seed, traced_seed = (int(stream(k).integers(0, 2**62)) for k in (0, 1, 2, 6))
    rng = stream(4)
    p = port.params(cfg)
    draws = keydraw.draw(cfg, key_seed, device)
    s_ref = draws["s"].cpu().numpy().astype(np.int64)
    sk, keys = port.build_keys(cfg, p, draws, host_seed, device)

    def draw():
        return [rng.integers(0, 2, (traffic["T"], b)) for b in circ.input_bits]

    return dict(circ=circ, path=path, p=p, sk=sk, keys=keys, s_ref=s_ref, draw=draw,
                enc_seed=enc_seed, traced_seed=traced_seed)


def measure(bench: dict, cfg: dict, traffic: dict, workload: str, seed: int, evals: int,
            device) -> dict:
    """The cell's set-up and warm-up, ``evals`` evaluations with tracing
    off, then ``collect``; every output judged."""
    import torch

    from fhe_bench import port
    from fhe_bench import run as bench_run

    s = setup(cfg, traffic, seed, device)
    p, sk, keys, path, draw = s["p"], s["sk"], s["keys"], s["path"], s["draw"]
    c = port.circuit(cfg, traffic, p, sk, keys, str(path), s["enc_seed"], device)
    for _ in range(traffic["warmup"]["evaluations"]):
        port.evaluate(c, draw(), device)
    inputs, outputs, untraced = [], [], []
    for _ in range(evals):
        words = draw()
        t0 = time.perf_counter()
        cts = port.evaluate(c, words, device)
        untraced.append(time.perf_counter() - t0)
        inputs.append(words)
        outputs.append([x.cpu().numpy() for x in cts])
    del c
    run = collect(cfg, traffic, p, sk, keys, path, s["traced_seed"], device, draw, inputs, outputs)
    run.update(bench_run.judge(s["circ"], inputs, outputs, s["s_ref"], p.q))
    width = "wide" if any(m["name"] == "bootstraps_per_s" for m in
                          bench_run.cell_metrics(bench, workload, False)) else "narrow"
    metrics = {f"{family}.{width}": read(run) for family, read in READERS.items()}
    prof = run.get("program_profile")
    if prof:
        rebuilt = prof["rot_idle_s"] + prof["edge_idle_s"]
        print(f"idle {prof['idle_s']:.6f} s of a {prof['window_s']:.6f} s window; in rotations "
              f"{prof['rot_idle_s']:.6f} s + at the edges {prof['edge_idle_s']:.6f} s = {rebuilt:.6f} s "
              f"({prof['rotations_source']}; device records moved {prof['clock_shift_us']:.1f} us, "
              f"{prof['launch_pairs']} launches matched)", file=sys.stderr)
    on_card = torch.device(device).type == "cuda"
    return {
        "workload": workload, "seed": seed,
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "metrics": metrics, "untraced_s": untraced, "traced_s": run["program_evals"],
        "untraced_median_s": statistics.median(untraced),
        "traced_median_s": statistics.median(run["program_evals"]),
        "program_spans": run["program_spans"], "program_profile": prof,
        "correct": all(v <= lim for v, lim in bench_run.compared(run, cfg).values()),
        "wrong_bits": run["wrong_bits"], "max_error": run["max_error"], "attempted": len(outputs),
    }


def main(argv=None) -> int:
    import argparse
    import json
    import os
    from pathlib import Path

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--evals", type=int, default=5, help="evaluations with tracing off")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "fhe_bench" / "triton")
    sys.path.insert(0, str(root))
    import torch

    from fhe_bench import run as bench_run

    bench, cfg, traffic = bench_run.load_cell(args.workload)
    torch.cuda.set_device(0)
    print(json.dumps(measure(bench, cfg, traffic, args.workload, args.seed, args.evals, "cuda")),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
