#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (each prints one line with its time; any failure exits non-zero
before the result lines):
  1. build   nvcc builds oece_tpu_torch/csrc into build/oece_tpu_torch/;
             prints each kernel's registers (ptxas), failing if an
             instance of #2's or #7's kernels (transpose_kernel,
             rev_gemm*, rev_build_kernel) spills or an int8_mm_kernel is
             built, and the card's name and power limit (nvidia-smi).
  2. kernel  the rotated-form rotation #12 (csrc/rot_step.cu: the digits,
             then a TMA + wgmma step GEMM on the K-major rev2 key, the
             split one up to 16 gates, the tiled one above)
             against its plain torch version on the row-major key, on the
             card, bit-exact: STD128_OPT (n=8), MICRO_A and TOY (exact
             gadget, N=512; n=4) at B = 1, 4, 8, 13, 37, 64, 65, 256,
             2048; lanes with a=0; a row-major key on the card must be
             refused.  Times one STD128_OPT step at B=2048 for both
             versions.
  3. gates   device keygen at full STD128_OPT (seed 0), then chained
             batches of 2048 random gates over all six types; every output
             is decrypted and checked against the plaintext chain.
  4. circuit Circuit(set="STD128_OPT", method="GINX", seed=0,
             device="cuda") runs examples/old_bristol_ckts/arith/
             adder_32bit.txt in verify mode on 4 random cases, its checks
             on the device branch (the card's default); the sums must
             equal a+b with no repair, and the rotation must have gone
             through the kernel (launch counter) and never through the
             plain version.  Prints the per-level wall (c.trace).
  5. ap-kernel   the AP rotation #13 (csrc/ap_step.cu: the live-gate
             table, then per live step the digits and a wgmma GEMM over
             the live gates, key tiles made on chip) against its plain
             torch version on the card, bit-exact: STD128_OPT (n=2) at
             B = 1, 4, 8, 13, 16, 17, 37, 64, 256, 2048, MICRO_AP2 and
             TOY_AP2 (B_r = 2) at B=37, each with mod-switch amounts and
             with any amounts; random int8 key bytes, lane 0 with a=0.
             The table kernel == its plain twin and the steps launched ==
             the live ones; an all-zero batch comes back unchanged with no
             step launched; a non-contiguous ap_ext is refused.  Times one
             STD128_OPT AP step at B=2048 for both versions, and at B=4.
  6. ap-gates    AP device keygen at full STD128_OPT (seed 0), then 2
             chained batches of 1024 random gates over all six types, every
             output decrypted and checked.
  7. ap-circuit  phase 4 with method="AP": adder_32bit verify, T=4, sums
             == a+b, the AP rotation through its kernel only.
  8. std-kernel  the standard-form GINX rotation on ginx_ext (fhe/std.py
             -> csrc/rev_step.cu: rev's step loop with a ring of two
             K-major blocks as its key source; per step the build of
             Pallas kernel #1 into slot i & 1, the digits kernel with the
             previous step's CMUX, and the split or tiled wgmma GEMM of #4)
             against its plain torch version on the card, bit-exact:
             STD128_OPT (n=8) at B = 1, 4, 8, 13, 16, 17, 37, 64, 256,
             2048 (B = 4 and 2048 three times: a build that overwrote a
             slot too early would show only some of the time), STD128
             (exact gadget, R=8) n=2, MICRO and TOY with n cut at B = 4,
             13, 37; random int8 ginx_ext bytes, a=0 lanes.  The K-major
             build alone against its twin (R = 4 and 8, N = 128 ...
             1024).  The rotation at B = 4 and 2048 launches only
             std_build_kernel, rev_digits_kernel and rev_gemm* (profiler
             names).  Times a B=2048 rotation over 8 distinct step keys
             (CUDA events) and each kernel per step (the profiler's
             timeline) beside their plain versions, their bounds, and for
             #1 its library form (one torch.take).
  9. context BinFHEContext(device="cuda") at STD128_OPT GINX, seed 0:
             KeyGen and BTKeyGen (golden's host keys, ginx_ext), then 24
             single EvalBinGate calls (6 gates x 4 input pairs) and EvalNOT,
             and 3 chained EvalBinGateBatch calls of 2048 random gates;
             every output decrypted and checked; only the std kernel ran.
 10. std-circuit Circuit(set="STD128_OPT", seed=0, device="cuda") under
             OECE_HOST_KEYGEN=1 runs adder_32bit verify at T=4: sums == a+b,
             the rotation through the std kernel only.
 11. rev-kernel  the standard form on prebuilt "rev" blocks
             (fhe/rev.py -> csrc/rev_step.cu on the K-major rev key: per
             step the digits kernel, which also applies the previous
             step's CMUX (#10's function), and a wgmma GEMM, the split one
             up to 16 gates, the tiled one above: #9 and #8) against its
             plain version on the row-major key, bit-exact:
             blind_rotate_rev at STD128_OPT (n=8) B = 1, 4, 8, 13, 16, 17,
             37, 64, 256, 2048, STD128 (R=8, n=2), MICRO (n=4) and TOY
             (n=3) at B = 4, 13, 37, random int8 blocks, a=0 lanes
             unchanged; #8 and #9 alone on K-major blocks of 16 and 8
             planes and #10 (any amount pairs) at B = 4, 13, 37, 2048; a
             row-major key or block on the card is refused, and the
             rotation at B = 4 and 2048 launches no kernel of
             csrc/std_step.cu (profiler names).  Times a STD128_OPT step
             at B=2048 over 8 distinct blocks (126 MB, more than the L2),
             whole (CUDA events) and per kernel (device time), with
             bounds.
     ap-sweep   one STD128_OPT step of #13 by batch size (B = 1, 4, 8, 16,
             64, 256, 1024, 2048; a rotation of n=8, 88 steps with
             mod-switch amounts, dead steps included; CUDA events) against
             its bound, and at B = 4 and 2048 each kernel's device time and
             the launch gaps per step (torch.profiler's kernel timeline).
             It also runs on a package whose AP kernel builds a block per
             step (rev_build, decompose, int8_mm), to compare trees in one
             call; it runs after the AP phases, as rot-sweep does.
     rot-sweep  one STD128_OPT step of #12 by batch size (B = 1, 4, 8, 16,
             64, 256, 1024, 2048; a rotation over 16 distinct random
             blocks, 251 MB, so each step reads its block from HBM; CUDA
             events) against its bound, and at B = 4 and 2048 the step
             split into the digits, the GEMM and the launch gaps
             (torch.profiler's kernel timeline).  It also runs on a
             package whose kernel reads the row-major key, to compare
             trees in one call.  It runs after the long phases: in runs
             where its profiler windows came before the AP phases'
             million launches, later windows lost records.
     rev-sweep  the same for the rev step (#9/#8, csrc/rev_step.cu): 16
             distinct random blocks, B = 1 ... 2048, against the bound; at
             B = 4 and 2048 its digits kernel, GEMM and gaps per step.
             Both rev phases also run on a package whose rev kernels read
             the row-major key, to compare trees in one call.
     std-sweep  the same for the standard-form step on ginx_ext: 16
             distinct random step keys, B = 1 ... 2048, against the
             function's bound (and the bound with the block written and
             read once); at B = 4 and 2048 its build, digits kernel, GEMM
             and gaps per step.  It also runs on a package whose std step
             loop is the mma.sync one (build, digits, matmul, CMUX).
 12. rot-step    #11 (fhe/rot.py rot_step_true -> csrc/rot_step.cu
             oece_rot_step: the same two kernels) against its plain
             version for any amount pairs (STD128_OPT, MICRO_A and TOY at
             B = 1, 4, 8, 13, 37, 64, 65, 256, 2048), and
             blind_rotate_rot_steps == blind_rotate_rot at STD128_OPT n=8
             B=37; times the B=2048 step and back-to-back calls at B=4.
 13. rev-gates   device keygen in the "rev" layout at full STD128_OPT
             (seed 0), then 3 chained batches of 1024 random gates, every
             output decrypted and checked; only the rev kernels ran.
 14. rev-circuit adder_32bit verify T=4 under OECE_LAYOUT=rev: sums == a+b,
             the rotation through the rev kernels only.
 15. rot-steps-circuit  adder_32bit verify T=4 with boot.ROT_MEGA off
             (OECE_ROT_MEGA=0): one rot_step_true launch per step only.
 16. neg-kernel  the kernel-level API of fhe/negacyclic.py at STD128_OPT
             widths (N=1024, R=4, M=16; M=8 too at B=13), B = 4, 13, 2048,
             random int8 digits and keys: #1 alone, #2 (#3's transpose,
             then #8's GEMMs), #3, #5, #6 (#10's kernel), #7 and the split
             and window pipelines against their plain twins, bit-exact,
             through the CUDA route only; #5 == #3 on #1's block; #3 and
             #5 (the wgmma GEMM of csrc/wgmma_mm.cuh) also at B = 1, 4,
             13, 63, 64, 65, 127, 129, 2048 for M = 16 and 8, and at N=512
             B=129; #2 at B = 1, 4, 13, 16, 17, 63, 64, 65, 127, 129, 2048
             (the edges of its split and tiled GEMMs' gate tiles) for M =
             16 and 8, and at N=512; #1 and #7 (the staged-span build) at
             M = 16 and 8, N = 1024 and 512; #2 launches transpose_kernel
             and rev_gemm* and no int8_mm_kernel.  Device time per call of
             each kernel, all its launches summed (#2: the transpose, the
             GEMM and at B=4 its mod-Q pass, attributed on the profiler's
             timeline, as the GEMM starts early under programmatic
             dependent launch; #3: the transpose and the GEMM; #5: the
             phase copies and the GEMM), at B = 4 and 2048 (#3 at B = 4
             also over 8 blocks from HBM), TOPS and share of the bound,
             plain times, bounds, and the library calls: torch._int_mm
             against the materialized negacyclic matrix for #3/#5 (at
             B=2048: it needs more than 16 rows), one torch.take for #7
             and for #1 alone.
 17. profile-boot  the step profiler oece_tpu_torch/tools/profile_boot.py
             at full width (golden host keys, seed 0; B=1024, all 502
             steps), scans A-I through its own entry points; scan A ==
             std.blind_rotate_std on the same inputs, one step of scan G
             combined == #4's P4.
 18. tb      the reference's test benches through the port's TB command
             line in this process (oece_tpu_torch.harness.tb.main),
             STD128_OPT, seed 0, verify mode on the card: adders -n 4
             (adder_32bit, adder_64bit), multipliers -n 4 (mult_32x32),
             adders -c 1 -n 4 -m AP; main must return 0 and every bench
             line be PASS with no repair; prints each line with its
             seconds and the launches of #12's and #13's kernels.
 19. recover-circuit  adder_32bit T=4 pure-encrypted, automatic recovery
             on the device branch: right sums, no HARD failure; again with
             one input's b shifted by q/12: right sums and input-side
             repairs (IN_*); prints recover_counts and max_phase_err.
 20. compound-circuit  adder_32bit verify T=4, xor_mode="compound": right
             sums, no repair, XOR_BOOTSTRAPS = 3 x T x the XOR/XNOR gates;
             its wall beside circuit's.
 21. dff     a generated 4-bit DFF counter, encrypted in verify mode for 6
             cycles: it must read 0, 1, ..., 5 with no repair.

Each main-path run (phases 4, 7, 9, 10, 14, 15 and 17-21) sets every launch
count to 0 just before it and reads the counts just after: the rotation
calls that reached each version, and each CUDA kernel's launches (one per
step; in phase 17 one per call of a kernel of fhe/negacyclic.py).
The last two lines are the kernels' JSON record and {"ok": true,
"device": {...}}.  JAX and the JAX package are blocked from being
imported.  ``python3 chip_smoke.py PHASE ...`` runs the build and the
named phases only, and prints neither of the last two lines.
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

# One NVIDIA H100 SXM (data sheet, dense): int8 tensor-core peak and HBM rate.
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12

# device_ms: the host's wait on each edge of a profile window, and how many
# windows in a row may miss a timed launch's record before it fails.
EDGE_S = 0.25
WINDOWS = 3


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(phase: str, t0: float, msg: str) -> None:
    print(f"[{phase}] {time.time() - t0:.2f}s {msg}", flush=True)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: int8
    operations at the tensor-core peak or bytes at the HBM rate."""
    t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def new_window() -> bool:
    """Whether #2 runs as #3's transpose and #8's wgmma GEMMs (a parent's
    package runs the mma.sync int8_mm_kernel)."""
    from oece_tpu_torch.fhe import _build

    return hasattr(_build.load(), "oece_window_matmul")


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from oece_tpu_torch.fhe import ap, negacyclic, rev, rot, std

    for m in (ap, rev, rot, std):
        m.LAUNCHES = 0
        m.PLAIN_LAUNCHES = 0
        m.STEP_LAUNCHES = 0
    rot.SINGLE_STEP_LAUNCHES = 0
    if hasattr(ap, "KERNEL_LAUNCHES"):  # a package before the live-gate table has none
        ap.KERNEL_LAUNCHES = 0
    for k in negacyclic.KERNELS:
        negacyclic.LAUNCHES[k] = negacyclic.PLAIN_LAUNCHES[k] = 0


def read_counts() -> dict:
    """Rotation calls that launched each CUDA path (rot_steps: single
    rotated-form steps), calls of fhe/negacyclic.py's wrappers that
    launched, and plain calls."""
    from oece_tpu_torch.fhe import ap, negacyclic, rev, rot, std

    return {
        "rot": rot.LAUNCHES, "rot_steps": rot.SINGLE_STEP_LAUNCHES, "ap": ap.LAUNCHES,
        "std": std.LAUNCHES, "rev": rev.LAUNCHES, "neg": sum(negacyclic.LAUNCHES.values()),
        "plain": sum(m.PLAIN_LAUNCHES for m in (ap, rev, rot, std))
        + sum(negacyclic.PLAIN_LAUNCHES.values()),
    }


def read_step_launches(kernel: str) -> int:
    """Launches of each CUDA kernel of one path's steps; for AP, every
    launch of its kernels (the table, the step loop's digits and GEMMs,
    the last finalize)."""
    from oece_tpu_torch.fhe import ap, rev, rot, std

    if kernel == "rot_steps":
        return rot.SINGLE_STEP_LAUNCHES
    if kernel == "ap" and hasattr(ap, "KERNEL_LAUNCHES"):
        return ap.KERNEL_LAUNCHES
    return {"rot": rot, "ap": ap, "std": std, "rev": rev}[kernel].STEP_LAUNCHES


def check_only(phase: str, counts: dict, kernel: str) -> int:
    """Fail unless ``kernel`` launched and nothing else did; returns the
    launches of each of its CUDA kernels."""
    others = {k: v for k, v in counts.items() if k != kernel and v}
    if counts[kernel] == 0 or others:
        fail(f"{phase}: launches {counts}: want {kernel} only")
    return read_step_launches(kernel)


def device_ms(fn, reps: int, *kernels: str, per_call: int = 1) -> list[float]:
    """Device time per call of fn spent in the CUDA kernels whose name
    contains each of ``kernels`` (torch.profiler), each launched
    ``per_call`` times per call: for kernels shorter than the host's launch
    overhead, where back-to-back CUDA events time the host instead.

    The profiler keeps only the kernels whose device timestamps fall
    inside its capture window, which opens and closes on the host's clock;
    on the card's machine the device timestamps can read earlier than the
    host's, so the window's first launch is often lost (PERF.md §6).  A
    fill kernel goes first and the host then waits ``EDGE_S`` on each edge
    of the window, so the timed launches lie well inside it.  A window
    that still misses a timed record is said and taken again, and
    ``WINDOWS`` such windows in a row fail: a time comes only from a
    window that recorded every launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    want = [reps * per_call] * len(kernels)
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")  # the window's first launch
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
        totals, counts, fills = [0.0] * len(kernels), [0] * len(kernels), 0
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            us = us if us is not None else ev.self_cuda_time_total
            fills += ev.count if "FillFunctor" in ev.key else 0
            for k, name in enumerate(kernels):
                if name in ev.key:
                    totals[k] += us
                    counts[k] += ev.count
        if not fills:
            print(f"device_ms: the profiler dropped the fill's record, timing {kernels}", flush=True)
        if counts == want:
            return [us / 1e3 / reps for us in totals]
        print(f"device_ms: the profiler recorded {counts} launches of {kernels}, want {want}; "
              "taking the window again", flush=True)
    fail(f"the profiler missed launches of {kernels} in {WINDOWS} windows in a row")


def timeline_ms(fn, reps: int, *kernels: str) -> list[float]:
    """Device time per call of fn in each of ``kernels`` (one launch each
    per call) by the profiler's timeline (kernel_timeline): each launch
    counts from the end of the launches before it, so a kernel that starts
    early under programmatic dependent launch and waits is not counted
    twice, as device_ms would count it."""
    per, _, _ = kernel_timeline(lambda: [fn() for _ in range(reps)], kernels, reps,
                                want=reps * len(kernels))
    return [per[k] for k in kernels]


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
    regs = kernel_registers(_build.BUILD_LOG)
    if new_window():  # #2 and #7 on their Hopper kernels: the mma.sync route is gone
        spills = {k: r for k, r in regs.items() if k.endswith("spill bytes")
                  and any(n in k for n in ("transpose_kernel", "rev_gemm", "rev_build_kernel"))}
        if spills or "int8_mm_kernel" in _build.BUILD_LOG:
            fail(f"build: spills in #2's or #7's kernels {spills}, or an int8_mm_kernel was built")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    log("build", t0, f"nvcc {_build.BUILD_SECONDS:.1f}s; ptxas registers: {regs}")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    print(smi.stdout.strip(), flush=True)  # name, power limit


def kernel_registers(build_log: str) -> dict:
    """{kernel entry (mangled name, shortened): registers} from ptxas -v,
    and the bytes of spill stores of each entry that spills."""
    regs, name, spills = {}, None, 0
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            name, spills = ln.split("'")[1], 0
        elif "bytes spill stores" in ln and name is not None:
            spills = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif "registers" in ln and name is not None:
            short = next((k for k in ("int8_mm_kernel", "raw_gemm_kernel", "rot_gemm_kernel",
                                      "rot_gemm_split_kernel", "transpose_kernel",
                                      "phase_expand_kernel", "rev_build_kernel", "ap_split_kernel",
                                      "ap_gemm_kernel", "ap_digits_kernel", "ap_live_kernel",
                                      "rev_gemm_kernel", "rev_gemm_split_kernel", "rev_digits_kernel",
                                      "std_build_kernel", "std_cmux_kernel")
                          if k in name), "")
            key = f"{short}{name[name.index(short) + len(short):][:32]}" if short else name[:60]
            regs[key] = int(ln.split("Used")[1].split("registers")[0])
            if spills:
                regs[key + " spill bytes"] = spills
            name = None
    return regs


def _key_shape(p, n: int, layout: str) -> tuple:
    """The int8 rotation key of n steps in ``layout``: rev2 (fhe/rot.py),
    ginx_ext (fhe/std.py) or rev (fhe/rev.py)."""
    T, R, nt = 128, 2 * p.d_g_used, p.N // 128
    return {
        "rev2": (n, (2 * nt - 1) * 2 * R * T, 8 * T),
        "ginx_ext": (n, R, 16, 2 * p.N),
        "rev": (n, (2 * nt - 1) * R * T, 16 * T),
    }[layout]


def rotation_inputs(p, B, n, layout, seed):
    """Random accumulator, random int8 key bytes of n steps in ``layout`` (a
    kernel must agree with its plain version on any key bytes) and rotation
    amounts of the q -> 2N mod switch with a=0 lanes: lane 0 all steps,
    and one step in five everywhere."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    acc = torch.randint(0, p.Q, (B, 2, p.N), generator=g, device="cuda", dtype=torch.int32)
    key = torch.randint(-128, 128, _key_shape(p, n, layout), generator=g, device="cuda",
                        dtype=torch.int8)
    scale = 2 * p.N // p.q
    a2N = scale * torch.randint(0, p.q, (B, n), generator=g, device="cuda", dtype=torch.int32)
    a2N[0] = 0
    a2N[:, ::5] = 0
    return acc, key, a2N.contiguous()


ROT_BATCHES = (1, 4, 8, 13, 37, 64, 65, 256, 2048)


def _rot_sets():
    """The parameter sets of the #12 and #11 checks."""
    from oece_tpu_torch.fhe.params import MICRO_A, STD128_OPT, TOY

    return (dataclasses.replace(STD128_OPT, n=8), MICRO_A, dataclasses.replace(TOY, n=4))


def card_key(rev2):
    """rev2 in the layout of the card's kernel: K-major (keys.rev2_to); a
    package whose kernel reads the row-major key takes it as it is."""
    from oece_tpu_torch.fhe import keys

    return keys.rev2_to(rev2, "cuda") if hasattr(keys, "rev2_to") else rev2


def card_rev(rev):
    """A rev key [n, rows, 16T] (or one step's block [rows, M*T]) in the
    layout of the card's kernels: K-major (keys.rev_to; a block as [M, T,
    rows]); a package whose rev kernels read the row-major key takes it as
    it is."""
    from oece_tpu_torch.fhe import keys, rev as rev_mod

    if not hasattr(rev_mod, "gemm_config"):
        return rev
    if rev.ndim == 3:
        return keys.rev_to(rev, "cuda")
    return rev.t().reshape(rev.shape[1] // 128, 128, rev.shape[0]).contiguous()


def phase_kernel():
    import torch
    from oece_tpu_torch.fhe import rot
    from oece_tpu_torch.fhe.params import STD128_OPT

    t0 = time.time()
    max_err = 0
    for i, (p, B) in enumerate((p, B) for p in _rot_sets() for B in ROT_BATCHES):
        acc, rev2, a2N = rotation_inputs(p, B, p.n, "rev2", seed=100 + i)
        keyT = card_key(rev2)
        got = rot.blind_rotate_rot(acc, keyT, a2N, p)
        max_err = max(max_err, _check_same("kernel", f"#12 {p.name} N={p.N} n={p.n} B={B}", got,
                                           rot.blind_rotate_rot_plain(acc, rev2, a2N, p), t0))
        if not torch.equal(got[0], acc[0]):
            fail(f"kernel changed the a=0 lane at {p.name} B={B}")
    try:
        rot.blind_rotate_rot(acc, rev2, a2N, p)
    except ValueError as e:
        log("kernel", t0, f"a row-major key on the card is refused: {e}")
    else:
        fail("kernel: a row-major rev2 key on the card was not refused")
    p = STD128_OPT
    acc, rev2, a2N = rotation_inputs(p, 2048, 1, "rev2", seed=7)
    keyT = card_key(rev2)
    kernel_ms = cuda_time_ms(lambda: rot.blind_rotate_rot(acc, keyT, a2N, p), reps=20)
    plain_ms = cuda_time_ms(lambda: rot.blind_rotate_rot_plain(acc, rev2, a2N, p), reps=5)
    log("kernel", t0, f"one STD128_OPT step at B=2048: kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms")
    return max_err, kernel_ms, plain_ms, _rot_step_bound(p, 2048)


def _rot_step_bound(p, B):
    """One rotated-form step's bound: 67 M MACs per gate; the step's key
    block, the accumulator in and out and one amount per gate."""
    nt, R = p.N // 128, 2 * p.d_g_used
    K = nt * 2 * R * 128
    block = (2 * nt - 1) * 2 * R * 128 * 8 * 128
    return bound(2.0 * B * nt * K * 8 * 128, block + 2 * B * 2 * p.N * 4 + B * 4)


def phase_rot_sweep():
    """#12's step time by batch size against its bound; the B=4 and
    B=2048 splits."""
    from oece_tpu_torch.fhe import rot
    from oece_tpu_torch.fhe.params import STD128_OPT

    t0 = time.time()
    p = dataclasses.replace(STD128_OPT, n=16)
    res = {}
    for B in (1, 4, 8, 16, 64, 256, 1024, 2048):
        acc, rev2, a2N = rotation_inputs(p, B, p.n, "rev2", seed=900 + B)
        keyT = card_key(rev2)
        del rev2
        rotate = lambda: rot.blind_rotate_rot(acc, keyT, a2N, p)  # noqa: E731
        ms = cuda_time_ms(rotate, reps=10 if B < 1024 else 3) / p.n
        bnd = _rot_step_bound(p, B)
        res[B] = {"ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        log("rot-sweep", t0, f"STD128_OPT step B={B}: {1e3 * ms:.1f} us, bound {1e3 * bnd[0]:.1f} us "
            f"({bnd[1]}), {bnd[0] / ms:.1%} of the bound")
        if B in (4, 2048):
            gemm = "rot_gemm" if hasattr(rot, "gemm_config") else "int8_mm_kernel"
            per, _, idle = kernel_timeline(rotate, ("rot_diff_decompose_kernel", gemm), p.n, want=2 * p.n)
            digits, mm = per["rot_diff_decompose_kernel"], per[gemm]
            res[B].update(digits_ms=digits, gemm_ms=mm, gap_ms=idle)
            log("rot-sweep", t0, f"B={B} per step (profiler timeline): digits {1e3 * digits:.2f} us, "
                f"GEMM ({gemm}) {1e3 * mm:.2f} us, of which no kernel running {1e3 * idle:.2f} us; "
                f"events {1e3 * ms:.2f} us")
        del keyT
    return res


def _ap_inputs(p, B, seed, kind="modswitch", steps=None):
    """Random accumulator, random int8 ap_ext bytes (``steps`` of them, all
    n*d_r by default) and rotation amounts: multiples of 2N/q (what the mod
    switch gives: at STD128_OPT even, so every step j = 0 is dead), any
    value in [0, 2N) (every step selects for about half the gates), or all
    0 (nothing selected).  Lane 0 of a batch of more than one has a=0, so
    it selects nothing."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    R = 2 * p.d_g_used
    acc = torch.randint(0, p.Q, (B, 2, p.N), generator=g, device="cuda", dtype=torch.int32)
    ext = torch.randint(-128, 128, (steps or p.n * p.d_r, R, 8, 2 * p.N), generator=g, device="cuda",
                        dtype=torch.int8)
    if kind == "any":
        a2N = torch.randint(0, 2 * p.N, (B, p.n), generator=g, device="cuda", dtype=torch.int32)
    else:
        scale = 2 * p.N // p.q
        a2N = scale * torch.randint(0, p.q, (B, p.n), generator=g, device="cuda", dtype=torch.int32)
        if kind == "zero":
            a2N.zero_()
    if B > 1:
        a2N[0] = 0
    return acc, ext, a2N.contiguous()


AP_BATCHES = (1, 4, 8, 13, 16, 17, 37, 64, 256, 2048)


def _ap_step_bound(p, a2N, ext, acc):
    """One AP step's bound from this run's select bits: 33.6 M MACs per
    live gate at STD128_OPT; the step key and the accumulator in and out
    (a step changes only its live gates, but reads and writes are counted
    for all, as the rotation's in and out)."""
    from oece_tpu_torch.fhe import ap

    steps = p.n * p.d_r
    live = int(ap.ap_bits(a2N, p).sum())
    nt, K = p.N // 128, p.N // 128 * 2 * p.d_g_used * 128
    ops = 2.0 * live * nt * K * 8 * 128 / steps
    return bound(ops, ext[0].numel() + 2 * acc.numel() * 4 / steps + a2N.numel() * 4 / steps)


def phase_ap_kernel():
    """#13 against its plain version on the card, bit-exact, at every
    batch size and amount pattern; the live-gate table against its plain
    twin; an all-zero batch launches no step; the one-step times at B =
    2048 and 4."""
    import torch
    from oece_tpu_torch.fhe import ap
    from oece_tpu_torch.fhe.params import MICRO_A, STD128_OPT, TOY

    t0 = time.time()
    std2 = dataclasses.replace(STD128_OPT, n=2)
    cases = [(std2, B, kind) for B in AP_BATCHES for kind in ("modswitch", "any")]
    cases += [(dataclasses.replace(MICRO_A, name="MICRO_AP2", B_r=2), 37, kind) for kind in ("modswitch", "any")]
    cases += [(dataclasses.replace(TOY, name="TOY_AP2", n=2, B_r=2), 37, kind) for kind in ("modswitch", "any")]
    cases += [(std2, 4, "zero"), (std2, 37, "zero")]
    max_err = 0
    new = hasattr(ap, "live_table")
    for i, (p, B, kind) in enumerate(cases):
        acc, ext, a2N = _ap_inputs(p, B, seed=200 + i, kind=kind)
        steps0 = ap.STEP_LAUNCHES
        got = ap.blind_rotate_ap(acc, ext, a2N, p)
        steps = ap.STEP_LAUNCHES - steps0
        want = ap.blind_rotate_ap_plain(acc, ext, a2N, p)
        max_err = max(max_err, _check_same("ap-kernel", f"{p.name} N={p.N} n={p.n} steps={p.n * p.d_r} "
                                           f"B={B} {kind} amounts ({steps} steps launched)", got, want, t0))
        if B > 1 and not torch.equal(got[0], acc[0]):
            fail(f"AP kernel changed the a=0 lane at {p.name} B={B}")
        if new:
            mask, rank0, count = ap.live_table(a2N, p)
            pm, pr, pc = ap.live_table_plain(a2N, p)
            if not (torch.equal(mask.long() & 0xFFFFFFFF, pm) and torch.equal(rank0, pr) and torch.equal(count, pc)):
                fail(f"ap-kernel: the live-gate table kernel != its plain twin at {p.name} B={B} {kind}")
            if steps != int((pc > 0).sum()):
                fail(f"ap-kernel: {steps} steps launched, {int((pc > 0).sum())} live at {p.name} B={B} {kind}")
            if kind == "zero" and (steps != 0 or not torch.equal(got, acc)):
                fail(f"ap-kernel: an all-zero batch of {B} changed the accumulator or launched a step")
    if new:
        try:
            ap.blind_rotate_ap(acc, ext.transpose(1, 2).contiguous().transpose(1, 2), a2N, std2)
        except ValueError as e:
            log("ap-kernel", t0, f"a transposed ap_ext on the card is refused: {e}")
        else:
            fail("ap-kernel: a non-compact ap_ext on the card was not refused")
    # one STD128_OPT rotation digit i (d_r = 11 steps, all live), per step
    p = dataclasses.replace(STD128_OPT, n=1)
    acc, ext, a2N = _ap_inputs(p, 2048, seed=8, kind="any")
    kernel_ms = cuda_time_ms(lambda: ap.blind_rotate_ap(acc, ext, a2N, p), reps=10) / p.d_r
    plain_ms = cuda_time_ms(lambda: ap.blind_rotate_ap_plain(acc, ext, a2N, p), reps=3) / p.d_r
    bnd = _ap_step_bound(p, a2N, ext, acc)
    log("ap-kernel", t0, f"one STD128_OPT AP step at B=2048 (any amounts): kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    # and at B=4, the lanes of a narrow circuit level
    acc4, ext4, a4 = _ap_inputs(p, 4, seed=9, kind="any")
    ms4 = cuda_time_ms(lambda: ap.blind_rotate_ap(acc4, ext4, a4, p), reps=20) / p.d_r
    bnd4 = _ap_step_bound(p, a4, ext4, acc4)
    log("ap-kernel", t0, f"one STD128_OPT AP step at B=4 (any amounts): kernel {1e3 * ms4:.1f} us, bound "
        f"{1e3 * bnd4[0]:.2f} us ({bnd4[1]})")
    return max_err, kernel_ms, plain_ms, bnd


def kernel_timeline(fn, names, steps, want=0):
    """One profiler timeline of fn: the time per step attributed to each
    kernel whose name contains one of ``names`` (summed over its launches,
    over ``steps``), and the time per step in which none of them ran
    between the first one's start and the last one's end (launch gaps).
    Under programmatic dependent launch a kernel starts, and waits, while
    its predecessor runs, so each launch is attributed only the time from
    the end of everything before it to its own end; the attributed times
    and the gaps add up to the span.  ms.  A window that has no record
    is taken again, as in device_ms, and so is one that lost the fill
    kernel's record, unless ``want`` (the records of ``names`` that one
    call launches) says that it kept every timed record; with ``want``, a
    window with fewer is taken again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ev = sorted((e.time_range.start, e.time_range.end, next(n for n in names if n in e.name))
                    for e in evs if any(n in e.name for n in names))
        fill = any("FillFunctor" in e.name for e in evs)
        if ev and (len(ev) == want or (fill and not want)):
            if not fill:
                print(f"kernel_timeline: the profiler dropped the fill's record, timing {names}", flush=True)
            break
        print(f"kernel_timeline: the window lost records ({len(ev)} of {names}"
              f"{f', want {want}' if want else ''}); taking it again", flush=True)
    else:
        fail(f"the profiler missed launches of {names} in {WINDOWS} windows in a row")
    per = {n: 0.0 for n in names}
    counts = {n: 0 for n in names}
    busy, end = 0.0, ev[0][0]
    for start, stop, name in ev:
        own = max(0.0, stop - max(start, end))
        per[name] += own
        counts[name] += 1
        busy += own
        end = max(end, stop)
    idle = (end - ev[0][0]) - busy
    return {n: per[n] / 1e3 / steps for n in names}, counts, idle / 1e3 / steps


def phase_ap_sweep():
    """#13's step by batch size against its bound (mod-switch amounts, the
    traffic circuits and gate batches send; per step of the n*d_r, dead
    ones included), and at B = 4 and 2048 its kernels' device times and
    launch gaps per step from the profiler's timeline.  Also runs on a
    package whose AP kernel builds a block per step (the parent's)."""
    from oece_tpu_torch.fhe import ap
    from oece_tpu_torch.fhe.params import STD128_OPT

    t0 = time.time()
    p = dataclasses.replace(STD128_OPT, n=8)
    steps = p.n * p.d_r
    new = hasattr(ap, "live_table")
    names = (("ap_live_kernel", "ap_digits_kernel", "ap_split_kernel", "ap_gemm_kernel") if new else
             ("rev_build_kernel", "decompose_kernel", "int8_mm_kernel"))
    res = {}
    for B in (1, 4, 8, 16, 64, 256, 1024, 2048):
        acc, ext, a2N = _ap_inputs(p, B, seed=950 + B)
        rotate = lambda: ap.blind_rotate_ap(acc, ext, a2N, p)  # noqa: E731
        ms = cuda_time_ms(rotate, reps=10 if B < 1024 else 3) / steps
        live_steps = int((ap.ap_bits(a2N, p).sum(0) > 0).sum())
        bnd = _ap_step_bound(p, a2N, ext, acc)
        res[B] = {"ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1], "live_steps": live_steps}
        log("ap-sweep", t0, f"STD128_OPT AP step B={B}: {1e3 * ms:.2f} us per step ({live_steps} of {steps} "
            f"steps live), bound {1e3 * bnd[0]:.3f} us ({bnd[1]})")
        if B in (4, 2048):
            per, counts, gap = kernel_timeline(rotate, names, steps)
            res[B].update(kernels_ms=per, launches=counts, gap_ms=gap)
            log("ap-sweep", t0, f"B={B} per step (profiler timeline): "
                + ", ".join(f"{n} {1e3 * v:.2f} us ({counts[n]} launches)" for n, v in per.items())
                + f"; no kernel running {1e3 * gap:.2f} us")
    return res


def phase_gates(phase="gates", method="GINX", B=2048, K=3, layout="rev2"):
    """Keygen at full STD128_OPT (GINX keys in ``layout``), then K chained
    batches of B gates through that layout's kernels only."""
    import torch
    from oece_tpu_torch.fhe import boot, devkeygen, lwe
    from oece_tpu_torch.fhe.params import STD128_OPT

    p = STD128_OPT
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    if method == "AP":
        sk, keys = devkeygen.device_keygen_ap(p, np.zeros(8, np.uint32), "cuda")
        key, kernel = keys.ap_ext, "ap"
    else:
        sk, keys = devkeygen.device_keygen(p, np.zeros(8, np.uint32), "cuda", layout=layout)
        key, kernel = getattr(keys, layout), {"rev": "rev", "rev2": "rot"}[layout]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(phase, t0, f"{method} {kernel} keygen n={p.n}: {time.time() - t0:.2f}s, key "
        f"{tuple(key.shape)}, peak device memory {peak / 2**30:.3f} GiB")
    reset_counts()
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
    check_only(phase, read_counts(), kernel)
    ms = 1e3 * float(np.mean(times[1:]))
    log(phase, t0, f"{K} chained batches of {B}, all decrypt correctly; "
        f"first {1e3 * times[0]:.1f} ms, then {ms:.1f} ms/batch = {B / ms * 1e3:.1f} bootstraps/s; "
        f"peak device memory over keygen and batches {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del keys, key, x1, x2, out
    torch.cuda.empty_cache()


def adder_inputs(T=4):
    """adder_32bit's operands, T random cases, and their bits (LSB first)."""
    rng = np.random.default_rng(1234)
    a = rng.integers(0, 1 << 32, T, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, T, dtype=np.uint64)
    bits = lambda v: ((v[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)  # noqa: E731
    return a, b, [bits(a), bits(b)]


def adder_sums(c):
    (out,) = c.GetOutput()
    return (out.astype(np.uint64) << np.arange(out.shape[1], dtype=np.uint64)).sum(1)


def phase_circuit(phase="circuit", method="GINX", host_keys=False, layout="rev2", rot_mega=True):
    """adder_32bit in verify mode on device keys (GINX in ``layout``, under
    OECE_LAYOUT; rev2 in one call per step with ``rot_mega`` False), or on
    golden's host keys (OECE_HOST_KEYGEN=1); returns the launches of each
    kernel of the rotation's steps in the Clock."""
    import torch
    from oece_tpu_torch.fhe import boot
    from oece_tpu_torch.runtime.evaluator import Circuit

    if method == "AP":
        kernel = "ap"
    elif host_keys:
        kernel = "std"
    else:
        kernel = "rev" if layout == "rev" else "rot" if rot_mega else "rot_steps"
    t0 = time.time()
    env = {"OECE_HOST_KEYGEN": "1"} if host_keys else {"OECE_LAYOUT": layout}
    os.environ.update(env)
    try:
        c = Circuit(set="STD128_OPT", method=method, seed=0, device="cuda")
    finally:
        for k in env:
            os.environ.pop(k)
    log(phase, t0, f"Circuit keygen {c.keygen_s:.1f}s")
    c.ReadFile(ADDER)
    c.setVerify(True)
    a, b, ins = adder_inputs()
    c.SetInput(ins)
    reset_counts()
    mega0, boot.ROT_MEGA = boot.ROT_MEGA, rot_mega
    try:
        ts = time.time()
        c.Clock()
        torch.cuda.synchronize()
        wall = time.time() - ts
    finally:
        boot.ROT_MEGA = mega0
    counts = read_counts()
    sums = adder_sums(c)
    if not np.array_equal(sums, a + b):
        fail(f"{phase} adder_32bit sums {sums} != {a + b}")
    launches = check_only(phase, counts, kernel)
    if sum(c.bad_gate_counts.values()):
        fail(f"{phase}: verify repaired {c.bad_gate_counts}, want none")
    WALLS[phase] = wall
    log(phase, t0, f"{method} adder_32bit verify T=4: sums == a+b; wall {wall:.2f}s; "
        f"bad_gate_counts {c.bad_gate_counts}; trace {c.trace.summary()}; "
        f"{level_walls(c)}; rotation calls {counts}, {launches} launches of each {kernel} kernel")
    del c
    torch.cuda.empty_cache()
    return launches


WALLS: dict = {}  # each circuit phase's Clock() wall (s)


def level_walls(c) -> str:
    """The check branch and the per-level wall of the last Clock's trace."""
    w = np.array([r.wall_s for r in c.trace.records])
    return (f"{'device' if c._dev_branch else 'host'} branch, {len(w)} levels, per-level wall "
            f"median {1e3 * np.median(w):.3f} ms, mean {1e3 * w.mean():.3f} ms")


def _max_err(got, want) -> tuple[int, int]:
    """(mismatches, max |got - want|) of two integer tensors."""
    return int((got != want).sum()), int((got.long() - want.long()).abs().max())


def take_index(N: int, R: int, device):
    """The flat index that makes #1 one torch.take of a step's ginx_ext
    [R, 16, 2N]: entry [d'*RT + r*T + u, m*T + t] is
    (r*16 + m)*2N + keys.rev_index(N)[d', u, t]."""
    import torch
    from oece_tpu_torch.fhe import keys

    idx = keys.rev_index(N, device)  # [2nt-1, u, t]
    plane = torch.arange(R * 16, device=device).view(R, 16) * (2 * N)
    flat = plane[None, :, None, :, None] + idx[:, None, :, None, :]  # [d', r, u, m, t]
    return flat.reshape(idx.shape[0] * R * 128, 16 * 128)


STD_NAMES = ("std_build_kernel", "rev_digits_kernel", "rev_gemm")  # the std step loop's kernels
OLD_STD_NAMES = ("rev_build_kernel", "decompose_kernel", "int8_mm_kernel", "std_cmux_kernel")


def kmajor_take_index(N: int, R: int, device):
    """take_index for the K-major block [16, T, (2nt-1)*RT]: #1 on the
    card as one torch.take."""
    flat = take_index(N, R, device)
    return flat.t().contiguous().view(16, 128, flat.shape[0])


def _std_step_bound(p, B):
    """One standard-form step's bound as a function of its inputs: 67.1 M
    MACs per gate at STD128_OPT; the step's 131 KB ginx_ext, the
    accumulator in and out and one amount per gate (the 15.7 MB block is
    the design's own intermediate: written and read once more, it is
    rev's bound, _rev_step_bound)."""
    nt, R = p.N // 128, 2 * p.d_g_used
    K = nt * R * 128
    return bound(2.0 * B * nt * K * 16 * 128, R * 16 * 2 * p.N + 2 * B * 2 * p.N * 4 + B * 4)


def phase_std_kernel():
    """The standard-form rotation on ginx_ext (rev_step.cu's step loop with
    a ring of two K-major blocks built per step) against its plain
    version, bit-exact, at every batch size and gadget, the n=8 rotations
    at B = 4 and 2048 three times each (a build that overwrote a slot too
    early would show as wrong bits only some of the time); the K-major
    build alone against its twin; no kernel of csrc/std_step.cu or the
    old step in the rotation.  Then a STD128_OPT rotation at B=2048 over 8
    distinct step keys, timed whole (CUDA events) and per kernel (the
    profiler's timeline), with bounds and #1's library form (one
    torch.take)."""
    import torch
    from oece_tpu_torch.fhe import keys, rot, std
    from oece_tpu_torch.fhe.params import MICRO, STD128, STD128_OPT, TOY

    t0 = time.time()
    std8 = dataclasses.replace(STD128_OPT, n=8)
    cases = [(std8, B) for B in REV_BATCHES]
    cases += [(dataclasses.replace(q, n=n), B) for q, n in ((STD128, 2), (MICRO, 4), (TOY, 3))
              for B in (4, 13, 37)]
    err = 0
    for i, (p, B) in enumerate(cases):
        acc, ext, a2N = rotation_inputs(p, B, p.n, "ginx_ext", seed=300 + i)
        want = std.blind_rotate_std_plain(acc, ext, a2N, p)
        for rep in range(3 if p is std8 and B in (4, 2048) else 1):
            got = std.blind_rotate_std(acc, ext, a2N, p)
            err = max(err, _check_same("std-kernel", f"rotation {p.name} N={p.N} R={2 * p.d_g_used} n={p.n} "
                                       f"B={B} (run {rep + 1})", got, want, t0))
        if not torch.equal(got[0], acc[0]):
            fail(f"std kernel changed the a=0 lane at {p.name} B={B}")

    # #1 alone: the K-major build against its twin
    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    for N, R in ((1024, 4), (1024, 8), (512, 8), (128, 8)):
        ext1 = torch.randint(-128, 128, (R, 16, 2 * N), generator=g, device="cuda", dtype=torch.int8)
        err = max(err, _check_same("std-kernel", f"#1 K-major build alone N={N} R={R}", std.build_diagonals_kmajor(ext1),
                                   std.build_diagonals_kmajor_plain(ext1, keys.rev_index(N, "cuda")), t0))

    # the B=2048 rotation: 8 steps, each on its own step key
    p, B, n = std8, 2048, 8
    nt, R = p.N // 128, 2 * p.d_g_used
    acc, ext, a2N = rotation_inputs(p, B, n, "ginx_ext", seed=300 + len(cases))
    rotate = lambda: std.blind_rotate_std(acc, ext, a2N, p)  # noqa: E731
    for Bn in (4, B):
        acc_n, a_n = acc[:Bn].contiguous(), a2N[:Bn].contiguous()
        names = kernel_names(lambda: std.blind_rotate_std(acc_n, ext, a_n, p))
        old = [k for k in names if any(o in k for o in OLD_STD_NAMES)]
        if old or not all(any(s in k for k in names) for s in STD_NAMES):
            fail(f"std-kernel: the rotation at B={Bn} launched {sorted(names)}: want {STD_NAMES} only")
        log("std-kernel", t0, f"kernels of the B={Bn} rotation: {sorted(k[:48] for k in names)}")
    res = {"step": {"max_abs_err": err, "ms": cuda_time_ms(rotate, reps=5) / n,
                    "plain_ms": cuda_time_ms(lambda: std.blind_rotate_std_plain(acc, ext, a2N, p), reps=1) / n}}
    # per step from the profiler's timeline: under programmatic dependent
    # launch a kernel's own duration includes its wait for its predecessor
    per, _, gap = kernel_timeline(rotate, STD_NAMES, n, want=3 * n + 1)
    log("std-kernel", t0, f"B={B} per step (profiler timeline): "
        + ", ".join(f"{k} {1e3 * v:.2f} us" for k, v in per.items()) + f"; no kernel running {1e3 * gap:.2f} us")
    idx = keys.rev_index(p.N, "cuda")
    block = std.build_diagonals_plain(ext[0], idx)
    flat = kmajor_take_index(p.N, R, "cuda")
    blockT = std.build_diagonals_kmajor_plain(ext[0], idx)
    if not torch.equal(torch.take(ext[0], flat), blockT):
        fail("torch.take through kmajor_take_index != the plain K-major build")
    dig = rot.tile_digits(acc, p)
    P4 = std.diag_matmul_combine_plain(dig, block, p.Q)
    # #1's own time: 8 builds alone, back to back (in the loop the build of
    # step i overlaps the GEMM of step i-1, and the timeline gives it only
    # the time that no other kernel covers)
    alone, _, _ = kernel_timeline(lambda: [std.build_diagonals_kmajor(ext[i]) for i in range(n)],
                                  ("std_build_kernel",), n, want=n)
    log("std-kernel", t0, f"#1 alone: {1e3 * alone['std_build_kernel']:.2f} us per build")
    res["build"] = {"max_abs_err": err, "ms": alone["std_build_kernel"],
                    "plain_ms": cuda_time_ms(lambda: std.build_diagonals_kmajor_plain(ext[0], idx), reps=3),
                    "library_ms": cuda_time_ms(lambda: torch.take(ext[0], flat), reps=20)}
    res["matmul"] = {"max_abs_err": err, "ms": per["rev_gemm"],
                     "plain_ms": cuda_time_ms(lambda: std.diag_matmul_combine_plain(dig, block, p.Q), reps=3)}
    ops_mm = 2.0 * B * nt * (nt * R * 128) * 16 * 128
    bounds = {  # (int8 operations, bytes) the function needs
        "build": (0.0, ext[0].numel() + block.numel()),
        "matmul": (ops_mm, dig.numel() + block.numel() + P4.numel() * 4),
    }
    for name, r in res.items():
        r["bound_ms"], r["bound_by"] = bound(*bounds[name]) if name in bounds else _std_step_bound(p, B)
        lib = f", torch.take {r['library_ms']:.4f} ms" if "library_ms" in r else ""
        log("std-kernel", t0, f"STD128_OPT B={B} {name}: kernel {r['ms']:.4f} ms"
            f"{' on the device' if name in bounds else ''}, plain {r['plain_ms']:.4f} ms{lib}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return res


def phase_std_sweep():
    """The standard-form step on ginx_ext by batch size (a rotation over 16
    distinct random step keys; CUDA events) against its bound, and at B =
    4 and 2048 the step split into its kernels and the launch gaps
    (torch.profiler's kernel timeline).  On a package whose std step loop
    is the old one (build, digits, mma.sync matmul, CMUX) it times that
    route, to compare trees in one call."""
    from oece_tpu_torch.fhe import std
    from oece_tpu_torch.fhe.params import STD128_OPT

    t0 = time.time()
    p = dataclasses.replace(STD128_OPT, n=16)
    new = hasattr(std, "build_diagonals_kmajor")
    names = STD_NAMES if new else OLD_STD_NAMES
    res = {}
    for B in (1, 4, 8, 16, 64, 256, 1024, 2048):
        acc, ext, a2N = rotation_inputs(p, B, p.n, "ginx_ext", seed=850 + B)
        rotate = lambda: std.blind_rotate_std(acc, ext, a2N, p)  # noqa: E731
        ms = cuda_time_ms(rotate, reps=10 if B < 1024 else 3) / p.n
        bnd, blk = _std_step_bound(p, B), _rev_step_bound(p, B)
        res[B] = {"ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1], "block_bound_ms": blk[0]}
        log("std-sweep", t0, f"STD128_OPT step B={B}: {1e3 * ms:.1f} us, bound {1e3 * bnd[0]:.2f} us "
            f"({bnd[1]}), {bnd[0] / ms:.1%} of the bound; with the block written and read once "
            f"{1e3 * blk[0]:.1f} us ({blk[1]})")
        if B in (4, 2048):
            per, counts, idle = kernel_timeline(rotate, names, p.n, want=(3 * p.n + 1) if new else 4 * p.n)
            res[B].update(kernels_ms=per, launches=counts, gap_ms=idle)
            log("std-sweep", t0, f"B={B} per step (profiler timeline): "
                + ", ".join(f"{k} {1e3 * v:.2f} us ({counts[k]} launches)" for k, v in per.items())
                + f"; no kernel running {1e3 * idle:.2f} us; events {1e3 * ms:.2f} us")
    return res


def _check_same(phase: str, what: str, got, want, t0: float) -> int:
    """Fail unless got == want bit for bit; returns max |got - want| (0)."""
    import torch

    torch.cuda.synchronize()
    bad, err = _max_err(got, want)
    log(phase, t0, f"{what}: mismatches {bad}, max |err| {err}")
    if bad:
        fail(f"{phase}: {what}: {bad} mismatches against the plain version")
    return err


REV_BATCHES = (1, 4, 8, 13, 16, 17, 37, 64, 256, 2048)


def kernel_names(fn) -> set:
    """The names of the CUDA kernels that one call of fn launched
    (torch.profiler, with device_ms's fill kernel and waits)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
    return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


def _rev_step_bound(p, B):
    """One rev step's bound: 67.1 M MACs per gate at STD128_OPT; the step's
    block, the accumulator in and out and one amount per gate."""
    nt, R = p.N // 128, 2 * p.d_g_used
    K = nt * R * 128
    block = (2 * nt - 1) * R * 128 * 16 * 128
    return bound(2.0 * B * nt * K * 16 * 128, block + 2 * B * 2 * p.N * 4 + B * 4)


def phase_rev_kernel():
    """The rev rotation (#9 and #8 with the CMUX of #10 in its step loop,
    csrc/rev_step.cu on the K-major key) against its plain version on the
    row-major key, bit-exact, at every batch size and gadget; #8 (M = 16
    and 8) and #9 alone on K-major blocks; #10 alone; a row-major key or
    block on the card refused; no kernel of csrc/std_step.cu in the
    rotation.  Then a STD128_OPT rotation at B=2048 over 8 distinct
    blocks: timed whole (CUDA events) and per kernel (device time), with
    bounds.  On a package whose rev kernels read the row-major key (the
    parent's), the same checks run on that key."""
    import torch
    from oece_tpu_torch.fhe import rev
    from oece_tpu_torch.fhe.params import MICRO, STD128, STD128_OPT, TOY

    t0 = time.time()
    new = hasattr(rev, "gemm_config")
    std8 = dataclasses.replace(STD128_OPT, n=8)
    cases = [(std8, B) for B in REV_BATCHES]
    cases += [(dataclasses.replace(q, n=n), B) for q, n in ((STD128, 2), (MICRO, 4), (TOY, 3))
              for B in (4, 13, 37)]
    err = 0
    for i, (p, B) in enumerate(cases):
        acc, rev_all, a2N = rotation_inputs(p, B, p.n, "rev", seed=400 + i)
        got = rev.blind_rotate_rev(acc, card_rev(rev_all), a2N, p)
        what = (f"rotation {p.name} N={p.N} R={2 * p.d_g_used} n={p.n} B={B}"
                + (f" {rev.gemm_config(B, p.N, p.d_g_used)}" if new else ""))
        err = max(err, _check_same("rev-kernel", what, got, rev.blind_rotate_rev_plain(acc, rev_all, a2N, p), t0))
        if not torch.equal(got[0], acc[0]):
            fail(f"rev kernel changed the a=0 lane at {p.name} B={B}")

    # #8 (16 and 8 planes) and #9 alone, #10 alone with any amount pairs
    p, R, nt = std8, 2 * std8.d_g_used, std8.N // 128
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    for B in (4, 13, 37, 2048):
        acc, rev_all, _ = rotation_inputs(p, B, 1, "rev", seed=B)
        dig = torch.randint(-128, 128, (B, nt * R * 128), generator=g, device="cuda", dtype=torch.int8)
        half = rev_all[0, :, : 8 * 128].contiguous()
        for blk, M in ((rev_all[0], 16), (half, 8)):
            err = max(err, _check_same("rev-kernel", f"#8 M={M} B={B}",
                                       rev.window_matmul_true(dig, card_rev(blk), R, p.Q),
                                       rev.window_matmul_true_plain(dig, blk, p.Q), t0))
            err = max(err, _check_same("rev-kernel", f"#9 M={M} B={B}",
                                       rev.window_matmul_dec_true(acc, card_rev(blk), p),
                                       rev.window_matmul_dec_true_plain(acc, blk, p), t0))
        P = torch.randint(0, p.Q, (B, 2, 2, p.N), generator=g, device="cuda", dtype=torch.int32)
        amt = torch.randint(0, 2 * p.N, (B, 2), generator=g, device="cuda", dtype=torch.int32)
        err = max(err, _check_same("rev-kernel", f"#10 any amounts B={B}", rev.cmux_epilogue_true(P, acc, amt, p.Q),
                                   rev.cmux_epilogue_true_plain(P, acc, amt, p.Q), t0))

    # the B=2048 rotation: 8 steps, each on its own block
    B, n = 2048, 8
    acc, rev_all, a2N = rotation_inputs(std8, B, n, "rev", seed=400 + len(cases))
    key = card_rev(rev_all)
    rotate = lambda: rev.blind_rotate_rev(acc, key, a2N, p)  # noqa: E731
    if new:
        for bad in ((lambda: rev.blind_rotate_rev(acc, rev_all, a2N, p)),
                    (lambda: rev.window_matmul_true(dig, rev_all[0], R, p.Q)),
                    (lambda: rev.window_matmul_dec_true(acc, rev_all[0], p))):
            try:
                bad()
            except ValueError as e:
                log("rev-kernel", t0, f"a row-major key or block on the card is refused: {e}")
            else:
                fail("rev-kernel: a row-major rev key or block on the card was not refused")
        for Bn in (4, B):
            acc_n, a_n = acc[:Bn].contiguous(), a2N[:Bn].contiguous()
            names = kernel_names(lambda: rev.blind_rotate_rev(acc_n, key, a_n, p))
            old = [k for k in names if any(o in k for o in ("int8_mm_kernel", "std_cmux_kernel", "decompose_kernel"))]
            if old or not any("rev_gemm" in k for k in names):
                fail(f"rev-kernel: the rotation at B={Bn} launched {sorted(names)}: want rev_step.cu's only")
            log("rev-kernel", t0, f"kernels of the B={Bn} rotation: {sorted(k[:48] for k in names)}")
    res = {"step": {"max_abs_err": err, "ms": cuda_time_ms(rotate, reps=5) / n,
                    "plain_ms": cuda_time_ms(lambda: rev.blind_rotate_rev_plain(acc, rev_all, a2N, p), reps=1) / n}}
    # per step from the profiler's timeline: under programmatic dependent
    # launch a kernel's own duration includes its wait for its predecessor
    if new:  # the digits kernel runs once more per rotation, for the last CMUX
        per, _, _ = kernel_timeline(rotate, ("rev_digits_kernel", "rev_gemm"), n, want=2 * n + 1)
        dev = {"digits": per["rev_digits_kernel"], "matmul": per["rev_gemm"], "cmux": per["rev_digits_kernel"]}
    else:
        names = {"digits": "decompose_kernel", "matmul": "int8_mm_kernel", "cmux": "std_cmux_kernel"}
        per, _, _ = kernel_timeline(rotate, tuple(names.values()), n, want=3 * n)
        dev = {k: per[v] for k, v in names.items()}
    dig = torch.randint(-128, 128, (B, nt * R * 128), generator=g, device="cuda", dtype=torch.int8)
    P4 = rev.window_matmul_true_plain(dig, rev_all[0], p.Q)
    amt = torch.stack([(2 * p.N - a2N[:, 0]) & (2 * p.N - 1), a2N[:, 0]], dim=1).contiguous()
    P = P4.reshape(B, 2, 2, p.N)
    plain = {
        "window_matmul": lambda: rev.window_matmul_true_plain(dig, rev_all[0], p.Q),
        "matmul_dec": lambda: rev.window_matmul_dec_true_plain(acc, rev_all[0], p),
        "cmux": lambda: rev.cmux_epilogue_true_plain(P, acc, amt, p.Q),
    }
    # #8 is the GEMM, #9 the digits kernel and the GEMM; on the new route the
    # CMUX of #10 runs inside the digits kernel, which is timed whole
    res["window_matmul"] = {"ms": dev["matmul"]}
    res["matmul_dec"] = {"ms": dev["digits"] + dev["matmul"]}
    res["cmux"] = {"ms": dev["cmux"]}
    ops_mm = 2.0 * B * nt * (nt * R * 128) * 16 * 128
    blk, acc_b, P4_b = rev_all[0].numel(), acc.numel() * 4, P4.numel() * 4
    cmux_bytes = P4_b + 2 * acc_b + amt.numel() * 4 + (dig.numel() if new else 0)
    bounds = {  # (int8 operations, bytes) the function needs
        "window_matmul": (ops_mm, dig.numel() + blk + P4_b),
        "matmul_dec": (ops_mm, acc_b + blk + P4_b),
        "cmux": (0.0, cmux_bytes),
        "step": _rev_step_bound(p, B),
    }
    for name, r in res.items():
        if name in plain:
            r.update(max_abs_err=err, plain_ms=cuda_time_ms(plain[name], reps=3))
        r["bound_ms"], r["bound_by"] = bound(*bounds[name]) if name != "step" else bounds[name]
        log("rev-kernel", t0, f"STD128_OPT B={B} {name}: kernel {r['ms']:.4f} ms"
            f"{' on the device' if name in plain else ''}, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return res


def phase_rev_sweep():
    """The rev step by batch size against its bound (a rotation over 16
    distinct random blocks, 251 MB, so each step reads its block from HBM;
    CUDA events), and at B = 4 and 2048 the step split into its kernels and
    the launch gaps (torch.profiler's kernel timeline).  On a package whose
    rev kernels read the row-major key (the parent's) it times that route."""
    from oece_tpu_torch.fhe import rev
    from oece_tpu_torch.fhe.params import STD128_OPT

    t0 = time.time()
    p = dataclasses.replace(STD128_OPT, n=16)
    new = hasattr(rev, "gemm_config")
    names = ("rev_digits_kernel", "rev_gemm") if new else ("decompose_kernel", "int8_mm_kernel", "std_cmux_kernel")
    res = {}
    for B in (1, 4, 8, 16, 64, 256, 1024, 2048):
        acc, rev_all, a2N = rotation_inputs(p, B, p.n, "rev", seed=800 + B)
        key = card_rev(rev_all)
        del rev_all
        rotate = lambda: rev.blind_rotate_rev(acc, key, a2N, p)  # noqa: E731
        ms = cuda_time_ms(rotate, reps=10 if B < 1024 else 3) / p.n
        bnd = _rev_step_bound(p, B)
        res[B] = {"ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        log("rev-sweep", t0, f"STD128_OPT step B={B}: {1e3 * ms:.1f} us, bound {1e3 * bnd[0]:.1f} us "
            f"({bnd[1]}), {bnd[0] / ms:.1%} of the bound")
        if B in (4, 2048):
            per, counts, idle = kernel_timeline(rotate, names, p.n, want=(2 if new else 3) * p.n + new)
            res[B].update(kernels_ms=per, launches=counts, gap_ms=idle)
            log("rev-sweep", t0, f"B={B} per step (profiler timeline): "
                + ", ".join(f"{k} {1e3 * v:.2f} us ({counts[k]} launches)" for k, v in per.items())
                + f"; no kernel running {1e3 * idle:.2f} us; events {1e3 * ms:.2f} us")
        del key
    return res


def phase_rot_step():
    """#11 against its plain version for any amount pairs; the per-step
    rotation against the step loop; the B=2048 step time and bound."""
    import torch
    from oece_tpu_torch.fhe import rot
    from oece_tpu_torch.fhe.params import STD128_OPT

    t0 = time.time()
    err = 0
    for i, (p, B) in enumerate((p, B) for p in _rot_sets() for B in ROT_BATCHES):
        acc, rev2, _ = rotation_inputs(p, B, 1, "rev2", seed=500 + i)
        keyT = card_key(rev2)
        g = torch.Generator(device="cuda")
        g.manual_seed(i)
        amt = torch.randint(0, 2 * p.N, (B, 2), generator=g, device="cuda", dtype=torch.int32)
        got = rot.rot_step_true(acc, keyT[0], amt, p)
        err = max(err, _check_same("rot-step", f"#11 {p.name} B={B}, any amounts", got,
                                   rot.rot_step_plain(acc, rev2[0], amt, p), t0))
    # the B=2048 step of the last STD128_OPT case
    p, B = STD128_OPT, 2048
    acc, rev2, _ = rotation_inputs(p, B, 1, "rev2", seed=500 + len(ROT_BATCHES) - 1)
    keyT = card_key(rev2)
    amt = torch.randint(0, 2 * p.N, (B, 2), generator=g, device="cuda", dtype=torch.int32)
    step = lambda: rot.rot_step_true(acc, keyT[0], amt, p)  # noqa: E731
    ms = cuda_time_ms(step, reps=20)
    plain_ms = cuda_time_ms(lambda: rot.rot_step_plain(acc, rev2[0], amt, p), reps=3)
    bnd = _rot_step_bound(p, B)
    log("rot-step", t0, f"one STD128_OPT step at B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    # one call at B=4, as OECE_ROT_MEGA=0 makes it on a narrow level
    acc, rev2, _ = rotation_inputs(p, 4, 1, "rev2", seed=511)
    keyT = card_key(rev2)
    amt4 = amt[:4].contiguous()
    call_ms = cuda_time_ms(lambda: rot.rot_step_true(acc, keyT[0], amt4, p), reps=200)
    log("rot-step", t0, f"one rot_step_true call at B=4, back to back: {1e3 * call_ms:.1f} us")
    pn = dataclasses.replace(STD128_OPT, n=8)
    acc, rev2, a2N = rotation_inputs(pn, 37, pn.n, "rev2", seed=510)
    keyT = card_key(rev2)
    got = rot.blind_rotate_rot_steps(acc, keyT, a2N, pn)
    err = max(err, _check_same("rot-step", "blind_rotate_rot_steps vs blind_rotate_rot, n=8 B=37", got,
                               rot.blind_rotate_rot(acc, keyT, a2N, pn), t0))
    if not torch.equal(got[0], acc[0]):
        fail("rot-step: the per-step rotation changed the a=0 lane")
    return err, ms, plain_ms, bnd


def negacyclic_matrix(ext):
    """The product matrix of one step's ext int8 [R, M, 2N] for digits in
    tile_digits order, materialized: int8 [nt*R*T, M*N], entry
    [j*RT + r*T + u, m*N + k] = ext[r, m, (k - j*T - u) mod 2N]; digits
    times it, one torch._int_mm, is #3's (and #5's) raw product.  Stored
    column-major, the layout cuBLAS's int8 product takes as it is."""
    import torch

    R, M, two_n = ext.shape
    N = two_n // 2
    i = torch.arange(N, device=ext.device)
    dense = ext[:, :, (i[None, :] - i[:, None]) % two_n]  # [R, M, N(i), N(k)]
    cols = dense.view(R, M, N // 128, 128, N).permute(1, 4, 2, 0, 3)  # [m, k, j, r, u]
    return cols.reshape(M * N, N * R).t()


def conj_take_index(N: int, R: int, device):
    """take_index in #7's conjugated basis: the rows and columns of every
    128 x 128 tile through trueidx(c) = 4*(c % 32) + c // 32."""
    import torch

    lane = torch.arange(128, device=device)
    ti = 4 * (lane % 32) + lane // 32
    flat = take_index(N, R, device)
    return flat.view(-1, 128, 16, 128)[:, ti][..., ti].reshape(flat.shape)


def phase_neg_kernel():
    """fhe/negacyclic.py's kernels against their plain twins at STD128_OPT
    widths, #3 and #5 also at the ragged edges of the GEMM's 128-gate tile
    and at N=512, #2 at the edges of its GEMMs' gate tiles, #1 and #7 at
    both plane counts and N=512; then their device times, plain times,
    bounds and library calls.  On a parent's package #2 is its mma.sync
    int8_mm_kernel."""
    import itertools

    import torch
    from oece_tpu_torch.fhe import negacyclic as ng
    from oece_tpu_torch.fhe.params import STD128_OPT

    t0 = time.time()
    p = STD128_OPT
    N, R, Q, nt = p.N, 2 * p.d_g_used, p.Q, p.N // 128
    K = nt * R * 128
    g = torch.Generator(device="cuda")
    g.manual_seed(600)
    rand8 = lambda *shape: torch.randint(-128, 128, shape, generator=g, device="cuda", dtype=torch.int8)  # noqa: E731
    rand32 = lambda hi, *shape: torch.randint(0, hi, shape, generator=g, device="cuda", dtype=torch.int32)  # noqa: E731
    ext16 = rand8(R, 16, 2 * N)
    launches0, plain0 = dict(ng.LAUNCHES), dict(ng.PLAIN_LAUNCHES)
    err, inputs = 0, {}
    for B in (4, 13, 2048):
        dig = rand8(B, K)
        for M in (16, 8) if B == 13 else (16,):
            ext = ext16[:, :M].contiguous()
            block = ng.build_diagonals(ext)
            what = f"B={B} M={M}"
            checks = [
                ("#1", block, ng.build_diagonals_plain(ext)),
                ("#3", ng.diag_matmul(dig, block, R), ng.diag_matmul_plain(dig, block)),
                ("#3 split", ng.negacyclic_matmul_split(dig, ext), ng.diag_matmul_plain(dig, block)),
                ("#5", ng.negacyclic_matmul(dig, ext), ng.negacyclic_matmul_plain(dig, ext)),
                ("#5 == #3", ng.negacyclic_matmul(dig, ext), ng.diag_matmul(dig, block, R)),
                ("#2", ng.window_matmul(dig, block, R, Q), ng.window_matmul_plain(dig, block, Q)),
                ("#2 window", ng.negacyclic_matmul_window(dig, ext, Q), ng.window_matmul_plain(dig, block, Q)),
                ("#7", ng.build_rev_conj(ext), ng.build_rev_conj_plain(ext)),
            ]
            for name, got, want in checks:
                err = max(err, _check_same("neg-kernel", f"{name} {what}", got, want, t0))
        P, acc, amt = rand32(Q, B, 2, 2, N), rand32(Q, B, 2, N), rand32(2 * N, B, 2)
        err = max(err, _check_same("neg-kernel", f"#6 B={B}", ng.cmux_epilogue(P, acc, amt, Q),
                                   ng.cmux_epilogue_plain(P, acc, amt, Q), t0))
        inputs[B] = (dig, P, acc, amt)
    # #3 and #5 at the edges of the GEMM's 128-gate tiles, both plane counts,
    # and at N=512 (another K and ring size)
    shapes = [(N, R, M, B) for B in (1, 4, 13, 63, 64, 65, 127, 129, 2048) for M in (16, 8)]
    for n_, r_, M, B in shapes + [(512, R, 16, 129)]:
        ext = ext16[:, :M].contiguous() if n_ == N else rand8(r_, M, 2 * n_)
        dig = inputs[B][0] if n_ == N and B in inputs else rand8(B, n_ * r_)
        block = ng.build_diagonals_plain(ext)
        what = f"N={n_} M={M} B={B}"
        err = max(err, _check_same("neg-kernel", f"#3 {what}", ng.diag_matmul(dig, block, r_),
                                   ng.diag_matmul_plain(dig, block), t0))
        err = max(err, _check_same("neg-kernel", f"#5 {what}", ng.negacyclic_matmul(dig, ext),
                                   ng.negacyclic_matmul_plain(dig, ext), t0))
    # #2 at the edges of its split (<= 16) and tiled (32 .. 256, 2 x 256)
    # GEMMs' gate tiles, both plane counts, and at N=512; #1 and #7 there
    window_shapes = [(N, M, B) for B in (1, 4, 13, 16, 17, 63, 64, 65, 127, 129, 2048) for M in (16, 8)]
    for n_, M, B in window_shapes + [(512, M, B) for B in (4, 17, 129) for M in (16, 8)]:
        ext = ext16[:, :M].contiguous() if n_ == N else rand8(R, M, 2 * n_)
        dig = inputs[B][0] if n_ == N and B in inputs else rand8(B, n_ * R)
        block = ng.build_diagonals_plain(ext)
        err = max(err, _check_same("neg-kernel", f"#2 N={n_} M={M} B={B}", ng.window_matmul(dig, block, R, Q),
                                   ng.window_matmul_plain(dig, block, Q), t0))
        if B == 4:
            err = max(err, _check_same("neg-kernel", f"#1 N={n_} M={M}", ng.build_diagonals(ext), block, t0))
            err = max(err, _check_same("neg-kernel", f"#7 N={n_} M={M}", ng.build_rev_conj(ext),
                                       ng.build_rev_conj_plain(ext), t0))
    if ng.PLAIN_LAUNCHES != plain0 or any(ng.LAUNCHES[k] == launches0[k] for k in ng.KERNELS):
        fail(f"neg-kernel: launches {ng.LAUNCHES} (before {launches0}), plain "
             f"{ng.PLAIN_LAUNCHES} (before {plain0}): want every kernel on the card, no plain twin")

    # device time per call of each kernel (all its launches), at B = 4 and 2048
    ext, block = ext16, ng.build_diagonals(ext16)
    conj = ng.build_rev_conj(ext)
    blocks = [ng.build_diagonals(rand8(R, 16, 2 * N)) for _ in range(8)]  # 126 MB, > L2
    new = new_window()
    res = {}
    for B in (4, 2048):
        dig, P, acc, amt = inputs[B]
        mm_ops = 2.0 * B * nt * K * 16 * 128
        raw, comb = B * 16 * N * 4, B * 4 * N * 4
        cyc = itertools.cycle(blocks)
        # #2: the transpose, then #8's GEMM; the split GEMM (B <= 16) adds
        # partial sums that rev_reduce_kernel takes mod Q (its zeroing
        # memset, 64 KB at B=4, is not timed)
        window_names = (("transpose_kernel", "rev_gemm") + (("rev_reduce_kernel",) if B <= 16 else ())) \
            if new else ("int8_mm_kernel",)
        if new:
            names = kernel_names(lambda: ng.window_matmul(dig, block, R, Q))
            if any("int8_mm_kernel" in k for k in names) or not all(any(n in k for k in names) for n in window_names):
                fail(f"neg-kernel: #2 at B={B} launched {sorted(names)}: want {window_names}, no int8_mm_kernel")
            log("neg-kernel", t0, f"kernels of #2 at B={B}: {sorted(k[:48] for k in names)}")
        kernels = {  # name: (call, its plain twin, its device kernels, (int8 ops, bytes))
            "window": (lambda: ng.window_matmul(dig, block, R, Q), lambda: ng.window_matmul_plain(dig, block, Q),
                       window_names, (mm_ops, dig.numel() + block.numel() + comb)),
            "diag": (lambda: ng.diag_matmul(dig, block, R), lambda: ng.diag_matmul_plain(dig, block),
                     ("transpose_kernel", "raw_gemm_kernel"), (mm_ops, dig.numel() + block.numel() + raw)),
            "onthefly": (lambda: ng.negacyclic_matmul(dig, ext), lambda: ng.negacyclic_matmul_plain(dig, ext),
                         ("phase_expand_kernel", "raw_gemm_kernel"), (mm_ops, dig.numel() + ext.numel() + raw)),
            "cmux": (lambda: ng.cmux_epilogue(P, acc, amt, Q), lambda: ng.cmux_epilogue_plain(P, acc, amt, Q),
                     ("std_cmux_kernel",), (0.0, P.numel() * 4 + 2 * acc.numel() * 4 + amt.numel() * 4)),
            "build_conj": (lambda: ng.build_rev_conj(ext), lambda: ng.build_rev_conj_plain(ext),
                           ("rev_build_kernel",), (0.0, ext.numel() + conj.numel())),
            "build": (lambda: ng.build_diagonals(ext), lambda: ng.build_diagonals_plain(ext),
                      ("rev_build_kernel",), (0.0, ext.numel() + block.numel())),
        }
        for name, (call, plain, knames, work) in kernels.items():
            parts = (timeline_ms if name == "window" else device_ms)(call, 20, *knames)
            r = {"max_abs_err": err, "ms": sum(parts), "parts": parts,
                 "plain_ms": cuda_time_ms(plain, reps=3), "library_ms": None}
            r["bound_ms"], r["bound_by"] = bound(*work)
            if work[0]:
                r["tops"] = work[0] / r["ms"] / 1e9
            res[(name, B)] = r
        hbm = lambda: ng.diag_matmul(dig, next(cyc), R)  # noqa: E731
        parts = device_ms(hbm, 24, "transpose_kernel", "raw_gemm_kernel")
        res[("diag_hbm", B)] = {"ms": sum(parts), "parts": parts, "events_ms": cuda_time_ms(hbm, reps=24)}

    # the library calls: one torch._int_mm for #3/#5 (B=2048), one torch.take for #7 and #1
    dig = inputs[2048][0]
    full = negacyclic_matrix(ext)
    err = max(err, _check_same("neg-kernel", "torch._int_mm(dig, negacyclic matrix) == #3, B=2048",
                               torch._int_mm(dig, full).view(2048, 16, N), ng.diag_matmul(dig, block, R), t0))
    mm_ms = cuda_time_ms(lambda: torch._int_mm(dig, full), reps=20)
    flat = conj_take_index(N, R, "cuda")
    err = max(err, _check_same("neg-kernel", "torch.take through the conjugated index == #7",
                               torch.take(ext, flat), conj, t0))
    for name in ("diag", "onthefly"):
        res[(name, 2048)]["library_ms"] = mm_ms
    res[("build_conj", 2048)]["library_ms"] = cuda_time_ms(lambda: torch.take(ext, flat), reps=20)
    flat1 = take_index(N, R, "cuda")
    err = max(err, _check_same("neg-kernel", "torch.take through the true index == #1", torch.take(ext, flat1),
                               block, t0))
    res[("build", 2048)]["library_ms"] = cuda_time_ms(lambda: torch.take(ext, flat1), reps=20)
    for (name, B), r in res.items():
        extra = "".join(f", {k} {r[k]:.4f} ms" for k in ("events_ms", "plain_ms", "bound_ms", "library_ms")
                        if r.get(k))
        if len(r["parts"]) > 1:
            extra += f", launches {' + '.join(f'{x:.4f}' for x in r['parts'])} ms"
        if r.get("tops"):
            extra += f", {r['tops']:.1f} TOPS, {r['bound_ms'] / r['ms']:.1%} of the bound"
        log("neg-kernel", t0, f"STD128_OPT B={B} {name}: kernel {r['ms']:.4f} ms on the device{extra}"
            f"{' (' + r['bound_by'] + ')' if 'bound_by' in r else ''}")
    return {name: r for (name, B), r in res.items() if B == 2048 and name != "diag_hbm"}


def phase_profile_boot():
    """The step profiler at full width through its own entry points;
    returns each fhe/negacyclic.py kernel's launches in that run."""
    import torch
    from oece_tpu_torch.fhe import negacyclic as ng
    from oece_tpu_torch.fhe import rev, rot, std
    from oece_tpu_torch.fhe.params import STD128_OPT
    from oece_tpu_torch.tools import profile_boot as pb

    t0 = time.time()
    p = STD128_OPT
    inp = pb.make_inputs(p, 1024, p.n, "cuda")
    torch.cuda.synchronize()
    log("profile-boot", t0, f"golden host keys, ginx_ext {tuple(inp.ext.shape)}, B=1024")
    reset_counts()
    res = pb.run(inp, log=lambda line: log("profile-boot", t0, line))
    torch.cuda.synchronize()
    counts, launches = read_counts(), dict(ng.LAUNCHES)
    if counts["plain"] or not all(launches.values()):
        fail(f"profile-boot: launches {launches}, counts {counts}: want every negacyclic kernel, no plain twin")
    log("profile-boot", t0, f"launches {launches}")
    want = std.blind_rotate_std(inp.acc0, inp.ext, inp.a2N, p)
    _check_same("profile-boot", "scan A == std.blind_rotate_std, 502 steps", res["A"][1], want, t0)
    d, ext0, R = inp.digs0, inp.ext[0], inp.ext.shape[1]
    got = rot.combine_planes(ng.negacyclic_matmul_split(d, ext0), p.Q)
    block = ng.build_diagonals_plain(ext0)
    _check_same("profile-boot", "scan G's step, combined == #8 on its K-major block (kernel)", got,
                rev.window_matmul_true(d, card_rev(block), R, p.Q), t0)
    _check_same("profile-boot", "scan G's step, combined == #4's P4 (plain)", got,
                std.diag_matmul_combine_plain(d, block, p.Q), t0)
    return launches


TRUTH = {
    "AND": lambda a, b: a & b, "OR": lambda a, b: a | b, "NAND": lambda a, b: 1 - (a & b),
    "NOR": lambda a, b: 1 - (a | b), "XOR": lambda a, b: a ^ b, "XNOR": lambda a, b: 1 - (a ^ b),
}


def phase_context(B=2048, K=3):
    """BinFHEContext at full STD128_OPT GINX: keygen, single gates, chained
    batches; returns the launches of each std kernel."""
    import torch
    from oece_tpu_torch.fhe.context import BinFHEContext

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    cc = BinFHEContext(device="cuda").GenerateBinFHEContext("STD128_OPT", "GINX", seed=0)
    sk = cc.KeyGen()
    tk = time.time()
    cc.BTKeyGen(sk)
    torch.cuda.synchronize()
    log("context", t0, f"BTKeyGen {time.time() - tk:.2f}s, ginx_ext "
        f"{tuple(cc.keys.ginx_ext.shape)}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    reset_counts()
    ts = time.time()
    for gate, fn in TRUTH.items():
        for a in (0, 1):
            for b in (0, 1):
                out = cc.EvalBinGate(gate, cc.Encrypt(sk, a), cc.Encrypt(sk, b))
                if cc.Decrypt(sk, out) != fn(a, b):
                    fail(f"context EvalBinGate {gate}({a}, {b}) decrypts wrong")
    if cc.Decrypt(sk, cc.EvalNOT(out)) != 1 - fn(1, 1):
        fail("context EvalNOT decrypts wrong")
    log("context", t0, f"24 single EvalBinGate + EvalNOT decrypt correctly, "
        f"{1e3 * (time.time() - ts) / 24:.1f} ms per gate")
    rng = np.random.default_rng(1)
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    x1, x2 = cc.EncryptBatch(sk, m1), cc.EncryptBatch(sk, m2)
    names = list(TRUTH)
    times = []
    for it in range(K):
        gates = [names[g] for g in rng.integers(0, 6, B)]
        ts = time.time()
        out = cc.EvalBinGateBatch(gates, x1, x2)
        torch.cuda.synchronize()
        times.append(time.time() - ts)
        want = np.array([TRUTH[g](int(a), int(b)) for g, a, b in zip(gates, m1, m2)])
        nbad = int((cc.DecryptBatch(sk, out) != want).sum())
        if nbad:
            fail(f"context batch {it}: {nbad} of {B} outputs decrypt wrong")
        x1, x2 = out, torch.roll(torch.as_tensor(x1, device="cuda"), 1, dims=0)
        m1, m2 = want, np.roll(m1, 1)
    launches = check_only("context", read_counts(), "std")
    ms = 1e3 * float(np.mean(times[1:]))
    log("context", t0, f"{K} chained EvalBinGateBatch of {B}, all decrypt correctly; first "
        f"{1e3 * times[0]:.1f} ms, then {ms:.1f} ms/batch = {B / ms * 1e3:.1f} bootstraps/s; "
        f"{launches} launches of each std kernel; peak device memory over keygen and batches "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches


def phase_tb():
    """The reference's test benches through the port's TB command line
    (oece_tpu_torch.harness.tb.main, in this process), STD128_OPT, seed 0,
    verify mode on the card: every bench line PASS with no repair; returns
    the launches of #12's and #13's kernels."""
    import contextlib
    import gc
    import io

    import torch
    from oece_tpu_torch.harness import tb

    launches = {}
    for argv, want, kernel in ((["adders", "-n", "4"], 2, "rot"),
                               (["multipliers", "-n", "4"], 1, "rot"),
                               (["adders", "-c", "1", "-n", "4", "-m", "AP"], 1, "ap")):
        t0 = time.time()
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = tb.main(argv + ["-s", "STD128_OPT", "--seed", "0", "--device", "cuda"])
        torch.cuda.synchronize()
        counts = read_counts()
        lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith(("PASS", "FAIL"))]
        name = " ".join(argv)
        if rc != 0 or len(lines) != want or not all(ln.startswith("PASS") for ln in lines):
            print(buf.getvalue(), flush=True)
            fail(f"tb {name}: main returned {rc}, bench lines {lines}, want {want} PASS lines")
        if any("bad gates fixed" in ln for ln in lines):
            fail(f"tb {name}: verify repaired gates: {lines}")
        launches[kernel] = launches.get(kernel, 0) + check_only(f"tb {name}", counts, kernel)
        for ln in lines:
            log("tb", t0, f"{name}: {ln}")
        log("tb", t0, f"{name}: rotation calls {counts}, {read_step_launches(kernel)} launches "
            f"of each {kernel} kernel")
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_recover_circuit():
    """adder_32bit, T=4, pure-encrypted (automatic recovery, the device
    branch): right sums and no HARD failure; then with one input's b
    shifted by q/12 (a drift past the prep check's threshold): right sums
    and input-side repairs (IN_*) in recover_counts."""
    import torch
    from oece_tpu_torch.runtime.evaluator import Circuit

    t0 = time.time()
    c = Circuit(set="STD128_OPT", seed=0, device="cuda")
    c.ReadFile(ADDER)
    a, b, ins = adder_inputs()
    launches = 0
    for drift in (0, c.params.q // 12):
        c.Reset()
        c.setPlaintext(False)
        c.setEncrypted(True)
        c.SetInput(ins)
        if drift:
            slot = int(c._slot[int(c.netlist.inputs[0][0])])
            c._ct_arena[slot, 0, -1] += drift
        reset_counts()
        ts = time.time()
        c.Clock()
        torch.cuda.synchronize()
        wall = time.time() - ts
        launches += check_only("recover-circuit", read_counts(), "rot")
        if not c.recover_flag or not c._dev_branch:
            fail(f"recover-circuit: recovery {c.recover_flag}, device branch {c._dev_branch}")
        if not np.array_equal(adder_sums(c), a + b):
            fail(f"recover-circuit (drift {drift}): sums {adder_sums(c)} != {a + b}")
        if c.recover_counts.get("HARD", 0):
            fail(f"recover-circuit (drift {drift}): HARD failures {c.recover_counts}")
        if drift and not any(k.startswith("IN_") for k in c.recover_counts):
            fail(f"recover-circuit: the drift of q/12 was not repaired on the input side: {c.recover_counts}")
        log("recover-circuit", t0, f"adder_32bit T=4 pure-encrypted, input drift {drift}: sums == a+b; "
            f"wall {wall:.2f}s; recover_counts {c.recover_counts}; max_phase_err {c.max_phase_err}; "
            f"{level_walls(c)}")
    del c
    torch.cuda.empty_cache()
    return launches


def phase_compound_circuit():
    """adder_32bit verify T=4 with xor_mode="compound": right sums, no
    repair, and 3 bootstraps per XOR/XNOR lane."""
    import torch
    from oece_tpu_torch.circuits.netlist import Op
    from oece_tpu_torch.runtime.evaluator import Circuit

    t0 = time.time()
    c = Circuit(set="STD128_OPT", seed=0, device="cuda", xor_mode="compound")
    c.ReadFile(ADDER)
    c.setVerify(True)
    a, b, ins = adder_inputs()
    c.SetInput(ins)
    reset_counts()
    ts = time.time()
    c.Clock()
    torch.cuda.synchronize()
    wall = time.time() - ts
    launches = check_only("compound-circuit", read_counts(), "rot")
    n_xor = int(np.isin(c.netlist.op, (int(Op.XOR), int(Op.XNOR))).sum())
    if not np.array_equal(adder_sums(c), a + b):
        fail(f"compound-circuit: sums {adder_sums(c)} != {a + b}")
    if sum(c.bad_gate_counts.values()):
        fail(f"compound-circuit: verify repaired {c.bad_gate_counts}")
    if c.gate_counts.get("XOR_BOOTSTRAPS") != 3 * 4 * n_xor:
        fail(f"compound-circuit: XOR_BOOTSTRAPS {c.gate_counts.get('XOR_BOOTSTRAPS')} != 3*4*{n_xor}")
    log("compound-circuit", t0, f"adder_32bit verify T=4 compound XOR: sums == a+b, no repair, "
        f"XOR_BOOTSTRAPS {3 * 4 * n_xor} for {n_xor} XOR/XNOR gates; wall {wall:.2f}s "
        f"(native: circuit {WALLS.get('circuit', float('nan')):.2f}s); {level_walls(c)}")
    del c
    torch.cuda.empty_cache()
    return launches


def phase_dff():
    """A generated 4-bit DFF counter (q += en each cycle), encrypted in
    verify mode on the card for 6 cycles: it must read 0, 1, ..., 5 with no
    repair."""
    import torch
    from oece_tpu_torch.circuits.gen import Builder
    from oece_tpu_torch.runtime.evaluator import Circuit

    t0 = time.time()
    bld = Builder("counter4")
    (en,) = bld.input_word(1)
    qs = [bld.DFF() for _ in range(4)]
    carry = en
    for q in qs:
        d = bld.XOR(q, carry)
        carry = bld.AND(q, carry)
        bld.dff_bind(q, d)
    bld.output_word(qs)
    c = Circuit(set="STD128_OPT", seed=0, device="cuda")
    c.LoadNetlist(bld.build())
    c.setVerify(True)
    seen = []
    reset_counts()
    for _ in range(6):
        c.SetInput([np.array([[1]])])
        c.Clock()
        seen.append(int(sum(int(v) << i for i, v in enumerate(c.GetOutput()[0][0]))))
    torch.cuda.synchronize()
    launches = check_only("dff", read_counts(), "rot")
    if seen != list(range(6)) or sum(c.bad_gate_counts.values()):
        fail(f"dff: the counter read {seen}, repairs {c.bad_gate_counts}; want 0..5 and none")
    log("dff", t0, f"4-bit DFF counter, 6 encrypted verify cycles: {seen}, no repair; "
        f"gate counts {c.gate_counts}")
    del c
    torch.cuda.empty_cache()
    return launches


def entry(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms=None) -> dict:
    """One kernel's record in the kernels JSON line."""
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": f"oece_tpu/fhe/pallas_kernels.py:{replaces}", "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
        "bound_by": bnd[1], "library_ms": library_ms,
    }


PHASES = {
    "kernel": phase_kernel,
    "gates": phase_gates,
    "circuit": phase_circuit,
    "ap-kernel": phase_ap_kernel,
    "ap-gates": lambda: phase_gates("ap-gates", "AP", B=1024, K=2),
    "ap-circuit": lambda: phase_circuit("ap-circuit", "AP"),
    "std-kernel": phase_std_kernel,
    "context": phase_context,
    "std-circuit": lambda: phase_circuit("std-circuit", "GINX", host_keys=True),
    "rev-kernel": phase_rev_kernel,
    "ap-sweep": phase_ap_sweep,
    "rot-sweep": phase_rot_sweep,
    "rev-sweep": phase_rev_sweep,
    "std-sweep": phase_std_sweep,
    "rot-step": phase_rot_step,
    "rev-gates": lambda: phase_gates("rev-gates", B=1024, K=3, layout="rev"),
    "rev-circuit": lambda: phase_circuit("rev-circuit", layout="rev"),
    "rot-steps-circuit": lambda: phase_circuit("rot-steps-circuit", rot_mega=False),
    "neg-kernel": phase_neg_kernel,
    "profile-boot": phase_profile_boot,
    "tb": phase_tb,
    "recover-circuit": phase_recover_circuit,
    "compound-circuit": phase_compound_circuit,
    "dff": phase_dff,
}


def main() -> None:
    if not os.path.isdir(os.path.join(REPO, "oece_tpu_torch")):
        fail("run from the root of a checkout: oece_tpu_torch/ is missing")
    sys.path.insert(0, REPO)
    sys.modules["jax"] = None  # the port must never import JAX
    sys.modules["oece_tpu"] = None  # nor anything of the JAX package
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    unknown = [a for a in sys.argv[1:] if a not in PHASES]
    if unknown:
        fail(f"unknown phases {unknown}: choose from {list(PHASES)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.time()
    phase_build()
    res = {name: PHASES[name]() for name in (sys.argv[1:] or PHASES)}
    print(f"total {time.time() - t_all:.1f}s", flush=True)
    if sys.argv[1:]:
        return

    std_res, rev_res = res["std-kernel"], res["rev-kernel"]
    neg_res, neg_launches = res["neg-kernel"], res["profile-boot"]
    std_launches = res["context"] + res["std-circuit"]
    fields = lambda r: (r["max_abs_err"], r["ms"], r["plain_ms"], (r["bound_ms"], r["bound_by"]))  # noqa: E731
    print(json.dumps({"kernels": [
        entry("rot_step", "oece_tpu_torch/csrc/rot_step.cu", 1262, res["circuit"], *res["kernel"]),
        entry("ap_step", "oece_tpu_torch/csrc/ap_step.cu", 1457, res["ap-circuit"], *res["ap-kernel"]),
        # #1 is one torch.take; no one PyTorch call computes #4, #8-#13 (each
        # fuses the limb combine or the rotations, #11-#13 their epilogues)
        *[entry(f"std_{k}", "oece_tpu_torch/csrc/rev_step.cu", line, std_launches,
                *fields(std_res[k]), std_res[k].get("library_ms"))
          for k, line in (("build", 71), ("matmul", 147))],
        # #8 is rev_step.cu's GEMM, #9 its digits kernel and the GEMM; the rev
        # path's CMUX (#10's function) runs inside the digits kernel
        *[entry(f"rev_{k}", "oece_tpu_torch/csrc/rev_step.cu", line, res["rev-circuit"], *fields(rev_res[k]))
          for k, line in (("window_matmul", 757), ("matmul_dec", 816), ("cmux", 900))],
        entry("rot_step_true", "oece_tpu_torch/csrc/rot_step.cu", 1047, res["rot-steps-circuit"],
              *res["rot-step"]),
        # #2 is #3's transpose then #8's GEMMs (negacyclic.cu: oece_window_matmul), #6
        # #10's kernel; #3 and #5 have torch._int_mm on the materialized
        # negacyclic matrix, #7 and #1 alone (row-major) one torch.take
        *[entry(f"neg_{k}", f"oece_tpu_torch/csrc/{src}", line, neg_launches[fn],
                *fields(neg_res[k]), neg_res[k]["library_ms"])
          for k, src, line, fn in (
              ("window", "negacyclic.cu", 208, "window_matmul"),
              ("diag", "wgmma_mm.cuh", 106, "diag_matmul"),
              ("onthefly", "wgmma_mm.cuh", 427, "negacyclic_matmul"),
              ("cmux", "std_step.cu", 525, "cmux_epilogue"),
              ("build_conj", "int8_mm.cuh", 687, "build_rev_conj"),
              ("build", "int8_mm.cuh", 71, "build_diagonals"))],
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
