#!/usr/bin/env python3
"""Profile the port's standard-form GINX path on one NVIDIA GPU.

    python3 chip_profile.py [OUT]    # from the root of a checkout

Three measurements, all at STD128_OPT with seed-0 golden host keys:
  1. sweep    one standard-form rotation step (csrc/std_step.cu) by batch
              size, CUDA events: µs per step and int8 TOPS, and at B = 4
              and 2048 each kernel's device time inside the step (build
              #1, digits, matmul #4, epilogue; torch.profiler);
  2. context  one chained EvalBinGateBatch of 2048 random gates under
              torch.profiler: wall time, device kernel time by kernel name,
              device busy share;
  3. circuit  adder_32bit verify at T=4 (Circuit under OECE_HOST_KEYGEN=1)
              under torch.profiler, the same breakdown.

Prints one line per result and writes them all as JSON to OUT
(default build/chip_profile.json).  Needs CUDA; JAX and the JAX package
are blocked from being imported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs

OUT = os.path.join(cs.REPO, "build", "chip_profile.json")


def profile(fn, label: str) -> dict:
    """Run fn once under torch.profiler: wall, device time by kernel, busy."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append({"name": ev.key[:90], "calls": ev.count, "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    dev_ms = sum(r["device_ms"] for r in rows)
    res = {"label": label, "wall_ms": 1e3 * wall, "device_ms": dev_ms,
           "busy_share": dev_ms / (1e3 * wall) if wall else 0.0, "kernels": rows[:12]}
    print(f"[{label}] wall {res['wall_ms']:.1f} ms, device kernels {dev_ms:.1f} ms, "
          f"busy {100 * res['busy_share']:.1f}%", flush=True)
    for r in rows[:8]:
        print(f"    {r['device_ms']:10.2f} ms  {r['calls']:7d}x  {r['name']}", flush=True)
    return res


def sweep() -> dict:
    from oece_tpu_torch.fhe import std
    from oece_tpu_torch.fhe.params import STD128_OPT

    p = dataclasses.replace(STD128_OPT, n=1)
    nt, RT = p.N // 128, 2 * p.d_g_used * 128
    macs = nt * (nt * RT) * 16 * 128  # per gate per step
    res = {"step_us": {}, "parts_us": {}}
    for B in (1, 4, 16, 64, 256, 1024, 2048, 4096):
        acc, ext, a2N = cs._std_inputs(p, B, 1, seed=B)
        ms = cs.cuda_time_ms(lambda: std.blind_rotate_std(acc, ext, a2N, p), reps=50)
        res["step_us"][B] = 1e3 * ms
        print(f"[sweep] B={B}: {1e3 * ms:.1f} us/step, "
              f"{2 * B * macs / (ms * 1e-3) / 1e12:.1f} TOPS", flush=True)
        if B in (4, 2048):
            names = {"build": "rev_build_kernel", "digits": "decompose_kernel",
                     "matmul": "int8_mm_kernel", "cmux": "std_cmux_kernel"}
            ms_each = cs.device_ms(lambda: std.blind_rotate_std(acc, ext, a2N, p), 50,
                                   *names.values())
            parts = dict(zip(names, ms_each))
            res["parts_us"][B] = {k: 1e3 * v for k, v in parts.items()}
            print(f"[sweep] B={B} parts (us): "
                  + ", ".join(f"{k} {1e3 * v:.1f}" for k, v in parts.items()), flush=True)
    return res


def main() -> None:
    sys.modules["jax"] = None
    sys.modules["oece_tpu"] = None
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    from oece_tpu_torch.fhe import _build
    from oece_tpu_torch.fhe.context import BinFHEContext
    from oece_tpu_torch.runtime.evaluator import Circuit

    _build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = {"card": smi, "sweep": sweep()}

    cc = BinFHEContext(device="cuda").GenerateBinFHEContext("STD128_OPT", "GINX", seed=0)
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)
    rng = np.random.default_rng(1)
    B = 2048
    x1, x2 = cc.EncryptBatch(sk, rng.integers(0, 2, B)), cc.EncryptBatch(sk, rng.integers(0, 2, B))
    gates = [list(cs.TRUTH)[g] for g in rng.integers(0, 6, B)]
    cc.EvalBinGateBatch(gates, x1, x2)  # warm-up
    out["context"] = profile(lambda: cc.EvalBinGateBatch(gates, x1, x2), "context B=2048")

    os.environ["OECE_HOST_KEYGEN"] = "1"
    c = Circuit(set="STD128_OPT", method="GINX", seed=0, device="cuda")
    os.environ.pop("OECE_HOST_KEYGEN")
    c.ReadFile(cs.ADDER)
    c.setVerify(True)
    a = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    bits = lambda v: ((v[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)
    c.SetInput([bits(a), bits(b)])
    out["circuit"] = profile(c.Clock, "std-circuit adder_32bit T=4")
    out["circuit"]["levels"] = [
        {"boot_gates": r.boot_gates, "wall_ms": 1e3 * r.wall_s} for r in c.trace.records
    ]
    path = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else OUT)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
