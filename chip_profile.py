#!/usr/bin/env python3
"""Profile the port's standard-form GINX paths on one NVIDIA GPU.

    python3 chip_profile.py [OUT]    # from the root of a checkout

Six measurements, all at STD128_OPT:
  1. sweep      the standard-form rotation step on ginx_ext (csrc/rev_step.cu's
                step loop, the block built per step into a ring of two)
                by batch size over 8 distinct step keys, CUDA events: µs
                per step and int8 TOPS, and at B = 4 and 2048 each
                kernel's time per step (the K-major build #1, the digits
                with the previous CMUX, the GEMM #4) and the gap, from the
                profiler's timeline;
  2. rev-sweep  the same for the step on prebuilt "rev" blocks (fhe/rev.py
                -> csrc/rev_step.cu on the K-major key: the digits kernel
                with the previous step's CMUX, the GEMM of #9/#8), timed
                over 8 distinct blocks (126 MB, more than the 50 MB L2, as
                a rotation reads them from HBM); at B = 4 and 2048 also on
                one block that stays in L2 (hbm/l2 time per kernel and step
                from the profiler's timeline, and the launch gap);
  3. context    one chained EvalBinGateBatch of 2048 random gates on
                seed-0 golden host keys under torch.profiler: wall time,
                device kernel time by kernel name, device busy share;
  4. circuit    adder_32bit verify at T=4 (Circuit under OECE_HOST_KEYGEN=1)
                under torch.profiler, the same breakdown;
  5. rev-circuit  the same under OECE_LAYOUT=rev (seed-0 device keys);
  6. rot-circuit  the same on the default rev2 keys (the main path).

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


NAMES = {"build": "std_build_kernel", "digits": "rev_digits_kernel", "gemm": "rev_gemm"}
REV_NAMES = {"digits": "rev_digits_kernel", "gemm": "rev_gemm"}


def _parts_us(fn, steps: int, table: dict) -> dict:
    """Device µs per step of each kernel of ``table`` inside fn, and the
    gap in which none ran: the kernels of the std (NAMES) and rev step
    loops start under programmatic dependent launch while their
    predecessor runs, so each gets the time the profiler's timeline
    attributes to it; both loops launch each kernel once per step and the
    digits kernel once more for the last CMUX."""
    per, _, gap = cs.kernel_timeline(fn, tuple(table.values()), steps, want=len(table) * steps + 1)
    return {**{k: 1e3 * per[name] for k, name in table.items()}, "gap": 1e3 * gap}


def sweep(label: str = "sweep") -> dict:
    """Step µs by batch of the std rotation ("sweep"; 8 distinct step keys,
    each block built into the ring) or the rev rotation ("rev-sweep"; 8
    distinct blocks, and one L2-resident block)."""
    from oece_tpu_torch.fhe import rev, std
    from oece_tpu_torch.fhe.params import STD128_OPT

    steps = 8
    p = dataclasses.replace(STD128_OPT, n=steps)
    nt, RT = p.N // 128, 2 * p.d_g_used * 128
    macs = nt * (nt * RT) * 16 * 128  # per gate per step
    res = {"step_us": {}, "parts_us": {}}
    for B in (1, 4, 16, 64, 256, 1024, 2048, 4096):
        if label == "sweep":
            acc, key, a2N = cs.rotation_inputs(p, B, steps, "ginx_ext", seed=B)
            rotate, table = std.blind_rotate_std, NAMES
        else:
            acc, key, a2N = cs.rotation_inputs(p, B, steps, "rev", seed=B)
            key = cs.card_rev(key)
            rotate, table = rev.blind_rotate_rev, REV_NAMES
        fn = lambda: rotate(acc, key, a2N, p)  # noqa: E731
        ms = cs.cuda_time_ms(fn, reps=50 // steps) / steps
        res["step_us"][B] = 1e3 * ms
        print(f"[{label}] B={B}: {1e3 * ms:.1f} us/step, "
              f"{2 * B * macs / (ms * 1e-3) / 1e12:.1f} TOPS", flush=True)
        if B in (4, 2048):
            split = {"hbm" if table is REV_NAMES else "ring": _parts_us(fn, steps, table)}
            if table is REV_NAMES:  # the first block alone, warm in L2 after its first launch
                one = dataclasses.replace(p, n=1)
                split["l2"] = _parts_us(lambda: rotate(acc, key[:1], a2N[:, :1].contiguous(), one), 1, table)
            res["parts_us"][B] = split
            for where, us in split.items():
                print(f"[{label}] B={B} parts, block in {where} (us): "
                      + ", ".join(f"{k} {v:.1f}" for k, v in us.items()), flush=True)
    return res


def circuit(rng, layout: str) -> dict:
    """adder_32bit verify at T=4 under torch.profiler: golden host keys
    (the std rotation) or device keys in ``layout``."""
    from oece_tpu_torch.runtime.evaluator import Circuit

    env = {"OECE_HOST_KEYGEN": "1"} if layout == "ginx_ext" else {"OECE_LAYOUT": layout}
    os.environ.update(env)
    try:
        c = Circuit(set="STD128_OPT", method="GINX", seed=0, device="cuda")
    finally:
        for k in env:
            os.environ.pop(k)
    c.ReadFile(cs.ADDER)
    c.setVerify(True)
    a = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    bits = lambda v: ((v[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)  # noqa: E731
    c.SetInput([bits(a), bits(b)])
    res = profile(c.Clock, f"{layout} adder_32bit T=4")
    res["levels"] = [{"boot_gates": r.boot_gates, "wall_ms": 1e3 * r.wall_s} for r in c.trace.records]
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

    _build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = {"card": smi, "sweep": sweep(), "rev-sweep": sweep("rev-sweep")}

    cc = BinFHEContext(device="cuda").GenerateBinFHEContext("STD128_OPT", "GINX", seed=0)
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)
    rng = np.random.default_rng(1)
    B = 2048
    x1, x2 = cc.EncryptBatch(sk, rng.integers(0, 2, B)), cc.EncryptBatch(sk, rng.integers(0, 2, B))
    gates = [list(cs.TRUTH)[g] for g in rng.integers(0, 6, B)]
    cc.EvalBinGateBatch(gates, x1, x2)  # warm-up
    out["context"] = profile(lambda: cc.EvalBinGateBatch(gates, x1, x2), "context B=2048")

    del cc, x1, x2
    out["circuit"] = circuit(rng, "ginx_ext")
    out["rev-circuit"] = circuit(rng, "rev")
    out["rot-circuit"] = circuit(rng, "rev2")
    path = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else OUT)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
