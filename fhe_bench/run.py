"""The benchmark of the PyTorch and CUDA port: one cell, one run.

    python3 fhe_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (fhe_bench/configs/<config>.json:
the parameter set, the blind-rotation method and the key layout) and a
traffic mix (fhe_bench/traffic/<traffic>.json: the Bristol circuit, test cases
per request T, the check mode, the warm-up, the profiled levels); each
metric is read by fhe_bench/metrics/<metric>.py, or where there is none by
the file of its family, the name before its last dot.  All are found by name.

Set-up makes the keys on the card from the seed, builds the program's
Circuit (pure-encrypted, recovery off; it holds the client's secret too,
see port.py), and warms up with whole evaluations of the cell's traffic.
The window is one closed-loop client: each request draws its plaintext
cases from the seed, and is Reset, SetInput, Clock and the output
ciphertexts, timed on the host clock to a synchronize.  Whole evaluations
run until the window's seconds have passed; the one in flight at the
deadline is finished and counted.  With --trace 1 the window runs with
CUDA-event spans around the gate batches and blind rotations, and one more
evaluation runs with torch.profiler over a slice of its levels.

Afterwards the plain reference (fhe_bench/reference.py) decrypts every
output ciphertext with the secret the benchmark drew, and compares each
bit with its own plaintext evaluation of the circuit: ``correct`` holds
when no bit differs and, where the configuration states a limit, no
output's phase error passes it.  Standard error gets the set-up's parts
and, last, each number compared beside its limit; the last line of
standard output is the result.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "oece_tpu")


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(benchmark, configuration, traffic) of the cell ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cfg, traffic


def cell_metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    if not trace:
        return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e = {m["name"] for m in cell_metrics(bench, name, False)}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e else [])]


def reader(metric: str):
    """The ``read`` of metrics/<metric>.py, else of the family's file,
    metrics/<name before the last dot>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"fhe_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def bootstraps_per_request(circ, traffic: dict) -> int:
    """Bootstrapped gates x T, from the reference's parse; a compound XOR
    is three bootstraps."""
    per_xor = 3 if traffic.get("xor_mode", "native") == "compound" else 1
    n = sum(per_xor if g[0] in ("XOR", "XNOR") else 1 for g in circ.gates
            if g[0] in ("AND", "OR", "XOR", "NAND", "NOR", "XNOR"))
    return n * traffic["T"]


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None, root: Path = ROOT,
             parts: dict | None = None) -> dict:
    """One run of a cell; returns the numbers the result line is made of.
    The CLI runs it on the card; tests run it on the CPU at small sizes.
    ``parts`` holds the seconds of set-up spent before the call."""
    mark = [time.time()]
    import numpy as np
    import torch

    from fhe_bench import keydraw, port, reference
    from fhe_bench.profile_slice import SliceProfiler
    from fhe_bench.spans import Spans

    t_start = PROCESS_START if t_start is None else t_start
    parts = dict(parts or {})

    def part(name: str) -> None:
        if cuda:
            torch.cuda.synchronize()
        now = time.time()
        parts[name] = now - mark[0]
        mark[0] = now

    cuda = torch.device(device).type == "cuda"
    part("program_import")
    if trace and not cuda:
        raise ValueError("--trace 1 reads CUDA events and the device profiler")
    path = root / traffic["circuit"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != traffic["sha256"]:
        raise SystemExit(f"{traffic['circuit']}: sha256 {digest}, the traffic fixes {traffic['sha256']}")
    circ = reference.parse(str(path))
    per_request = bootstraps_per_request(circ, traffic)
    T = traffic["T"]
    word = seed % 2**64

    def stream(k: int):
        return np.random.default_rng([word, k])

    key_seed, enc_seed, host_seed = (int(stream(k).integers(0, 2**62)) for k in range(3))
    inputs_rng = stream(4)
    part("parse")

    p = port.params(cfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    draws = keydraw.draw(cfg, key_seed, device)
    s_ref = draws["s"].cpu().numpy().astype(np.int64)
    part("key_draw")
    sk, keys = port.build_keys(cfg, p, draws, host_seed, device)
    del draws
    part("key_assembly")
    c = port.circuit(cfg, traffic, p, sk, keys, str(path), enc_seed, device)
    part("circuit")

    def draw_inputs(rng):
        return [rng.integers(0, 2, (T, b)) for b in circ.input_bits]

    warm_rng = stream(5)
    for _ in range(traffic["warmup"]["evaluations"]):
        port.evaluate(c, draw_inputs(warm_rng), device)
    part("warmup")
    setup_s = time.time() - t_start

    spans = Spans(cfg["method"]) if trace else None
    if spans:
        spans.install()
    inputs, outputs, times = [], [], []
    level_walls, levels = 0.0, 0
    w0 = time.time()
    while True:
        words = draw_inputs(inputs_rng)
        t0 = time.time()
        cts = port.evaluate(c, words, device)
        t1 = time.time()
        times.append(t1 - t0)
        inputs.append(words)
        outputs.append([x.cpu().numpy() for x in cts])
        if trace:
            level_walls += sum(r.wall_s for r in c.trace.records)
            levels += len(c.trace.records)
        if t1 - w0 >= seconds:
            break
    window_s = time.time() - w0
    if spans:
        spans.uninstall()

    run = dict(setup_s=setup_s, setup_parts=parts, window_s=window_s, evals=times,
               bootstraps=per_request * len(times), level_walls_s=level_walls, levels=levels)
    if cuda:
        run["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    if trace:
        run["spans"] = spans.read(cfg["params"], keydraw.gadget_digits(cfg["params"]))
        first, last = traffic.get("profile_levels") or (0, len(c.plan.levels))
        profiled = None
        port.level_hook(c, lambda lv: prof.before(lv), lambda lv: prof.after(lv))
        for _ in range(3):
            prof = SliceProfiler(first, last)
            words = draw_inputs(inputs_rng)
            cts = port.evaluate(c, words, device)
            inputs.append(words)
            outputs.append([x.cpu().numpy() for x in cts])
            profiled = prof.read()
            if profiled is not None:
                break
            print("profile: the window kept no device record inside the slice; again",
                  file=sys.stderr, flush=True)
        run["profile"] = profiled
        run["client_s"] = port.client_costs(c, words, 5)
    run["attempted"] = len(outputs)
    run["loaded"] = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))

    del c, keys, sk
    if cuda:
        torch.cuda.empty_cache()
    run.update(judge(circ, inputs, outputs, s_ref, p.q))
    return run


def judge(circ, inputs, outputs, s, q: int) -> dict:
    """The reference's verdict on every output bit of every evaluation."""
    import numpy as np

    from fhe_bench import reference

    cases = [np.concatenate([w[k] for w in inputs]) for k in range(len(circ.input_bits))]
    want = reference.evaluate(circ, cases)
    wrong, worst, failed = 0, 0, 0
    T = inputs[0][0].shape[0]
    for e, outs in enumerate(outputs):
        bad = 0
        for k, cts in enumerate(outs):  # [bits, T, n+1]
            ref = want[k][e * T:(e + 1) * T].T  # [bits, T]
            bad += int((reference.decrypt(cts, s, q) != ref).sum())
            worst = max(worst, int(np.abs(reference.phase_errors(cts, s, ref, q)).max()))
        wrong += bad
        failed += bad > 0
    bits = sum(want[k].size for k in range(len(want)))
    return dict(wrong_bits=wrong, output_bits=bits, max_error=worst, failed=failed)


def compared(run: dict, cfg: dict) -> dict:
    """The numbers that decide ``correct``, each (value, limit): the output
    bits that decrypt wrong, exactly 0, and where the configuration states a
    limit for it, the widest phase error of an output in q units."""
    out = {"wrong_bits": (run["wrong_bits"], 0)}
    limit = cfg.get("limits", {}).get("max_output_error")
    if limit is not None:
        out["max_error"] = (run["max_error"], limit)
    return out


def result(run: dict, bench: dict, cfg: dict, name: str, trace: bool, chips: int, kind: str) -> dict:
    """The result line: the cell's metrics as its readers give them, the
    device, the verdict, and last the numbers compared with their limits."""
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": run.get("memory_peak_bytes", 0)}
    checks = compared(run, cfg)
    out = {"correct": all(v <= lim for v, lim in checks.values()) and not run["loaded"],
           "attempted": run["attempted"], "failed": run["failed"],
           "metrics": metrics, "device": device}
    if trace and run.get("profile"):
        prof = run["profile"]
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build" / "fhe_bench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    bench, cfg, traffic = load_cell(args.workload)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)

    import torch

    parts = {"torch_import": time.time() - PROCESS_START}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fhe_bench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    t0 = time.time()
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    parts["cuda_init"] = time.time() - t0
    run = run_cell(cfg, traffic, args.seed, args.seconds, bool(args.trace), parts=parts)
    if run["loaded"]:
        print(f"fhe_bench: the process loaded {run['loaded']}", file=sys.stderr)
        return 4
    out = result(run, bench, cfg, args.workload, bool(args.trace), chips, torch.cuda.get_device_name(0))
    print("setup_s " + f"{run['setup_s']:.3f}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run["setup_parts"].items()), file=sys.stderr)
    if "client_s" in run:
        print("client side of a request, median s: SetInput (host encryption, upload) "
              f"{run['client_s'][0]:.6f}, output decryption in Clock {run['client_s'][1]:.6f}",
              file=sys.stderr)
    print(f"fhe_bench: {len(run['evals'])} evaluations in {run['window_s']:.3f} s; "
          f"{run['output_bits']} output bits (q/8 = {cfg['params']['q'] // 8})", file=sys.stderr)
    for k, (v, lim) in compared(run, cfg).items():
        print(f"compared {k} {v} limit {lim}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
