#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (each prints one line with its time; any failure exits non-zero
before the result lines):
  1. build   nvcc builds oece_tpu_torch/csrc into build/oece_tpu_torch/;
             prints the card's name and power limit (nvidia-smi).
  2. kernel  the CUDA blind-rotation kernel against its plain torch version
             on the card, bit-exact: STD128_OPT shape (n=8) at B = 1, 37,
             256; MICRO_A; a TOY shape (exact gadget, N=512); lanes with
             a=0.  Times one STD128_OPT step at B=2048 for both versions.
  3. gates   device keygen at full STD128_OPT (seed 0), then chained
             batches of 2048 random gates over all six types; every output
             is decrypted and checked against the plaintext chain.
  4. circuit Circuit(set="STD128_OPT", method="GINX", seed=0,
             device="cuda") runs examples/old_bristol_ckts/arith/
             adder_32bit.txt in verify mode on 4 random cases; the sums
             must equal a+b, and the rotation must have gone through the
             kernel (launch counter) and never through the plain version.
  5. ap-kernel   the CUDA AP rotation kernel against its plain torch
             version on the card, bit-exact: STD128_OPT (n=2) at B = 1,
             37, 256; MICRO_A and TOY (n=2) with B_r = 2 at B=37; random
             int8 key bytes, lane 0 with a=0.  Times one STD128_OPT AP step
             at B=2048 for both versions.
  6. ap-gates    AP device keygen at full STD128_OPT (seed 0), then 2
             chained batches of 1024 random gates over all six types, every
             output decrypted and checked.
  7. ap-circuit  phase 4 with method="AP": adder_32bit verify, T=4, sums
             == a+b, the AP rotation through its kernel only.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  JAX is blocked from being imported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ADDER = os.path.join(REPO, "examples", "old_bristol_ckts", "arith", "adder_32bit.txt")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(phase: str, t0: float, msg: str) -> None:
    print(f"[{phase}] {time.time() - t0:.2f}s {msg}", flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    import torch
    from oece_tpu_torch.fhe import _build

    t0 = time.time()
    _build.load()
    regs = [ln.strip() for ln in _build.BUILD_LOG.splitlines() if "registers" in ln]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    log("build", t0, f"nvcc {_build.BUILD_SECONDS:.1f}s; ptxas: {regs}")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    print(smi.stdout.strip(), flush=True)  # name, power limit


def _rot_inputs(p, B, n, seed):
    """Random accumulator, random int8 rev2 (the kernel must agree with the
    plain version on any key bytes) and valid rotation amounts with a=0
    lanes: lane 0 all steps, and one step in five everywhere."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    nt = p.N // 128
    rows = (2 * nt - 1) * 2 * 2 * p.d_g_used * 128
    acc = torch.randint(0, p.Q, (B, 2, p.N), generator=g, device="cuda", dtype=torch.int32)
    rev2 = torch.randint(-128, 128, (n, rows, 1024), generator=g, device="cuda", dtype=torch.int8)
    scale = 2 * p.N // p.q
    a2N = scale * torch.randint(0, p.q, (B, n), generator=g, device="cuda", dtype=torch.int32)
    a2N[0] = 0
    a2N[:, ::5] = 0
    return acc, rev2, a2N.contiguous()


def phase_kernel():
    import torch
    from oece_tpu.fhe.params import MICRO_A, STD128_OPT, TOY
    from oece_tpu_torch.fhe import rot

    t0 = time.time()
    cases = [
        (dataclasses.replace(STD128_OPT, n=8), 1),
        (dataclasses.replace(STD128_OPT, n=8), 37),
        (dataclasses.replace(STD128_OPT, n=8), 256),
        (MICRO_A, 37),
        (dataclasses.replace(TOY, n=4), 37),
    ]
    max_err = 0
    for i, (p, B) in enumerate(cases):
        acc, rev2, a2N = _rot_inputs(p, B, p.n, seed=100 + i)
        got = rot.blind_rotate_rot(acc, rev2, a2N, p)
        want = rot.blind_rotate_rot_plain(acc, rev2, a2N, p)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        bad = int((got != want).sum())
        log("kernel", t0, f"{p.name} N={p.N} n={p.n} B={B}: mismatches {bad}, max |err| {err}")
        if bad:
            fail(f"kernel != plain at {p.name} B={B}: {bad} mismatches")
        max_err = max(max_err, err)
    p = STD128_OPT
    acc, rev2, a2N = _rot_inputs(p, 2048, 1, seed=7)
    kernel_ms = cuda_time_ms(lambda: rot.blind_rotate_rot(acc, rev2, a2N, p), reps=20)
    plain_ms = cuda_time_ms(lambda: rot.blind_rotate_rot_plain(acc, rev2, a2N, p), reps=5)
    log("kernel", t0, f"one STD128_OPT step at B=2048: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms")
    return max_err, kernel_ms, plain_ms


def _ap_inputs(p, B, seed, any_a=False):
    """Random accumulator, random int8 ap_ext bytes and rotation amounts:
    multiples of 2N/q (what the mod switch gives) or, with any_a, any value
    in [0, 2N) so that every step selects for about half the gates.  Lane 0
    has a=0, so it selects nothing."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    R = 2 * p.d_g_used
    acc = torch.randint(0, p.Q, (B, 2, p.N), generator=g, device="cuda", dtype=torch.int32)
    ext = torch.randint(-128, 128, (p.n * p.d_r, R, 8, 2 * p.N), generator=g, device="cuda", dtype=torch.int8)
    if any_a:
        a2N = torch.randint(0, 2 * p.N, (B, p.n), generator=g, device="cuda", dtype=torch.int32)
    else:
        scale = 2 * p.N // p.q
        a2N = scale * torch.randint(0, p.q, (B, p.n), generator=g, device="cuda", dtype=torch.int32)
    a2N[0] = 0
    return acc, ext, a2N.contiguous()


def phase_ap_kernel():
    import torch
    from oece_tpu.fhe.params import MICRO_A, STD128_OPT, TOY
    from oece_tpu_torch.fhe import ap

    t0 = time.time()
    std2 = dataclasses.replace(STD128_OPT, n=2)
    cases = [
        (std2, 1), (std2, 37), (std2, 256),
        (dataclasses.replace(MICRO_A, name="MICRO_AP2", B_r=2), 37),
        (dataclasses.replace(TOY, name="TOY_AP2", n=2, B_r=2), 37),
    ]
    max_err = 0
    for i, (p, B) in enumerate(cases):
        acc, ext, a2N = _ap_inputs(p, B, seed=200 + i)
        got = ap.blind_rotate_ap(acc, ext, a2N, p)
        want = ap.blind_rotate_ap_plain(acc, ext, a2N, p)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        bad = int((got != want).sum())
        log("ap-kernel", t0, f"{p.name} N={p.N} n={p.n} steps={p.n * p.d_r} B={B}: "
            f"mismatches {bad}, max |err| {err}")
        if bad:
            fail(f"AP kernel != plain at {p.name} B={B}: {bad} mismatches")
        if not torch.equal(got[0], acc[0]):
            fail(f"AP kernel changed the a=0 lane at {p.name} B={B}")
        max_err = max(max_err, err)
    # one STD128_OPT rotation digit i (d_r = 11 steps), per step
    p = dataclasses.replace(STD128_OPT, n=1)
    acc, ext, a2N = _ap_inputs(p, 2048, seed=8, any_a=True)
    kernel_ms = cuda_time_ms(lambda: ap.blind_rotate_ap(acc, ext, a2N, p), reps=10) / p.d_r
    plain_ms = cuda_time_ms(lambda: ap.blind_rotate_ap_plain(acc, ext, a2N, p), reps=3) / p.d_r
    log("ap-kernel", t0, f"one STD128_OPT AP step at B=2048: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms")
    return max_err, kernel_ms, plain_ms


def phase_gates(phase="gates", method="GINX", B=2048, K=3):
    """Keygen at full STD128_OPT, then K chained batches of B gates."""
    import torch
    from oece_tpu.fhe.params import STD128_OPT
    from oece_tpu_torch.fhe import boot, devkeygen, lwe

    p = STD128_OPT
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    keygen = devkeygen.device_keygen_ap if method == "AP" else devkeygen.device_keygen
    sk, keys = keygen(p, np.zeros(8, np.uint32), "cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    key = keys.ap_ext if method == "AP" else keys.rev2
    log(phase, t0, f"{method} keygen n={p.n}: {time.time() - t0:.2f}s, key "
        f"{tuple(key.shape)}, peak device memory {peak / 2**30:.2f} GiB")
    rng = np.random.default_rng(1)
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    x1 = torch.from_numpy(lwe.encrypt_bits(sk, m1, rng)).cuda()
    x2 = torch.from_numpy(lwe.encrypt_bits(sk, m2, rng)).cuda()
    truth = [
        lambda a, b: a & b, lambda a, b: a | b, lambda a, b: 1 - (a & b),
        lambda a, b: 1 - (a | b), lambda a, b: a ^ b, lambda a, b: 1 - (a ^ b),
    ]
    times = []
    for it in range(K):
        gids = rng.integers(0, 6, B).astype(np.int32)
        ts = time.time()
        out = boot.eval_bin_gate_batch(keys, torch.from_numpy(gids).cuda(), x1, x2)
        torch.cuda.synchronize()
        times.append(time.time() - ts)
        want = np.array([truth[g](int(a), int(b)) for g, a, b in zip(gids, m1, m2)])
        got = lwe.decrypt_bits(sk, out.cpu().numpy())
        nbad = int((got != want).sum())
        if nbad:
            fail(f"{method} gate batch {it}: {nbad} of {B} outputs decrypt wrong")
        # chain: next batch's inputs are this batch's outputs
        x1, x2 = out, torch.roll(x1, 1, dims=0)
        m1, m2 = want, np.roll(m1, 1)
    ms = 1e3 * float(np.mean(times[1:]))
    log(phase, t0, f"{K} chained batches of {B}, all decrypt correctly; "
        f"first {1e3 * times[0]:.1f} ms, then {ms:.1f} ms/batch = {B / ms * 1e3:.1f} bootstraps/s")
    del keys
    torch.cuda.empty_cache()


def phase_circuit(phase="circuit", method="GINX"):
    """adder_32bit in verify mode; returns the launches of the method's
    rotation kernel in the Clock."""
    import torch
    from oece_tpu_torch.fhe import ap, rot
    from oece_tpu_torch.runtime.evaluator import Circuit

    kernel = ap if method == "AP" else rot
    t0 = time.time()
    c = Circuit(set="STD128_OPT", method=method, seed=0, device="cuda")
    log(phase, t0, f"Circuit keygen {c.keygen_s:.1f}s")
    c.ReadFile(ADDER)
    c.setVerify(True)
    rng = np.random.default_rng(1234)
    a = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    bits = lambda v, w: ((v[:, None] >> np.arange(w, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)
    c.SetInput([bits(a, 32), bits(b, 32)])
    for m in (ap, rot):
        m.LAUNCHES = 0
        m.PLAIN_LAUNCHES = 0
    ts = time.time()
    c.Clock()
    torch.cuda.synchronize()
    wall = time.time() - ts
    launches, plain = kernel.LAUNCHES, kernel.PLAIN_LAUNCHES
    other = (rot if method == "AP" else ap).LAUNCHES
    (out,) = c.GetOutput()
    sums = (out.astype(np.uint64) << np.arange(out.shape[1], dtype=np.uint64)).sum(1)
    if not np.array_equal(sums, a + b):
        fail(f"{method} adder_32bit sums {sums} != {a + b}")
    if launches == 0 or plain != 0 or other != 0:
        fail(f"{method} rotation launches: kernel {launches}, plain {plain}, other method's kernel {other}")
    log(phase, t0, f"{method} adder_32bit verify T=4: sums == a+b; wall {wall:.2f}s; "
        f"bad_gate_counts {c.bad_gate_counts}; trace {c.trace.summary()}; "
        f"kernel launches {launches}, plain {plain}")
    return launches


def main() -> None:
    if not os.path.isdir(os.path.join(REPO, "oece_tpu_torch")):
        fail("run from the root of a checkout: oece_tpu_torch/ is missing")
    sys.path.insert(0, REPO)
    sys.modules["jax"] = None  # the port must never import JAX
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.time()
    phase_build()
    max_err, kernel_ms, plain_ms = phase_kernel()
    phase_gates()
    launches = phase_circuit()
    ap_err, ap_ms, ap_plain_ms = phase_ap_kernel()
    phase_gates("ap-gates", "AP", B=1024, K=2)
    ap_launches = phase_circuit("ap-circuit", "AP")
    print(f"total {time.time() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "rot_step",
        "route": "cuda",
        "source": "oece_tpu_torch/csrc/rot_step.cu",
        "replaces": "oece_tpu/fhe/pallas_kernels.py:1262",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "ap_step",
        "route": "cuda",
        "source": "oece_tpu_torch/csrc/ap_step.cu",
        "replaces": "oece_tpu/fhe/pallas_kernels.py:1457",
        "launches": ap_launches,
        "max_abs_err": ap_err,
        "ms": ap_ms,
        "plain_ms": ap_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
