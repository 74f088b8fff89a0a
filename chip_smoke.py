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
             2048, STD128 (exact gadget, d = 4; n=2) at B = 17, 132, 180,
             256, 257, 300, 512, 4096 (WIDE_BATCHES: the tiled GEMM's
             gate tiles fitted to B, its padded digit scratch) and (n=3)
             at B = 4, 8 (the split GEMM: digit chunks loaded only inside
             the key's range, key tiles issued before the wait); lanes with
             a=0; a row-major key on the card must be refused.  Times one
             STD128_OPT step at B=2048 for both versions.
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
             (n=3) at B = 4, 13, 37, STD128 (n=2) at WIDE_BATCHES,
             random int8 blocks, a=0 lanes unchanged, each with the
             step GEMM that rot.gemm_config chooses; #8 and #9
             alone on K-major blocks of 16 and 8 planes and #10 (any
             amount pairs) at B = 4, 13, 37, 2048; a
             row-major key or block on the card is refused, and the
             rotation at B = 4 and 2048 launches no kernel of
             csrc/std_step.cu (profiler names).  Times a STD128_OPT step
             at B=2048 over 8 distinct blocks (126 MB, more than the L2),
             whole (CUDA events) and per kernel (device time), with
             bounds.
     gemm-tiles  every template instance of the tiled step GEMM (gate
             tiles NB = 32, 48 .. 256 with one math warpgroup, 144 .. 256
             with two) against its plain twin at STD128, bit-exact:
             rot_gemm_kernel (#12, n=2), rev_gemm_kernel (the rev
             rotation, n=2) and ap_gemm_kernel (#13, n=1, every gate live
             at every step) at B = 17, 33, 132, 144, 200, 256, 257, 300,
             512, 684 (every epilogue shape) and a ragged B for each
             instance those miss; each line prints rot.gemm_config's tile.
     ap-sweep   one STD128_OPT step of #13 by batch size (B = 1, 4, 8, 16,
             64, 256, 1024, 2048; a rotation of n=8, 88 steps with
             mod-switch amounts, dead steps included; CUDA events) against
             its bound, and at B = 4 and 2048 each kernel's device time and
             the launch gaps per step (torch.profiler's kernel timeline).
             It runs after the AP phases, as rot-sweep does.
     rot-sweep  one STD128_OPT step of #12 by batch size (B = 1, 4, 8, 16,
             64, 256, 1024, 2048; a rotation over 16 distinct random
             blocks, 251 MB, so each step reads its block from HBM; CUDA
             events) against its bound, with the step GEMM that
             rot.gemm_config chooses (NB, MW, split) at each B, and at B =
             4 and 2048 the step
             split into the digits, the GEMM and the launch gaps
             (torch.profiler's kernel timeline); the same for STD128 (d =
             4) at B = 4, 8 (the split GEMM: each step beside the 31.5 MB
             block's HBM floor, 9.4 us, and the compact-key roofline;
             the rotation == its plain version bit for bit; and the GEMM
             of one step by #11 calls on one block, L2-warm, against
             calls on 16 blocks) and at WIDE_BATCHES, each split.  It
             runs after the long phases: in runs where its profiler
             windows came before the AP phases' million launches, later
             windows lost records.
     rev-sweep  the same for the rev step (#9/#8, csrc/rev_step.cu): 16
             distinct random blocks, B = 1 ... 2048 and STD128's, against
             the bound, with rot.gemm_config's step GEMM; split into its
             digits kernel, GEMM and gaps per step where rot-sweep splits.
     std-sweep  the same for the standard-form step on ginx_ext: 16
             distinct random step keys, B = 1 ... 2048, against the
             function's bound (and the bound with the block written and
             read once); at B = 4 and 2048 its build, digits kernel, GEMM
             and gaps per step.
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
 22. ap-generic  the generic-base AP method (TOY, B_r = 32: golden's host
             keys with every digit value, ap.blind_rotate_ap_generic,
             torch ops and no kernel): adder_32bit verify T=4 on the card,
             sums == a+b with no repair, only the generic rotation run;
             seconds and bootstraps/s; one rotation at B=8 against one
             digit value's matrix build and torch._int_mm; then tb adders
             -c 1 -n 4 -s TOY -m AP through tb.main, PASS.
 23. checkpoint  adder_32bit verify T=4 at STD128_OPT on the device branch,
             one input of case 1 shifted by q/2 (level 1 repairs): whole,
             then from the same generator state with Clock(checkpoint_path=
             build/chip_smoke_checkpoint.npz, checkpoint_every=10)
             interrupted before level 20 and resumed there: outputs,
             ciphertext arena, bad_gate_counts, bad_gate_levels and
             recover_counts == the whole run's, no file left; save and
             resume times, and each save's split: the host copy, then
             np.savez against np.savez_compressed of the same state.
 24. bad-trace   OECE_BAD_TRACE=1, tests/test_evaluator.py's corruption at
             STD128_OPT (adder_2bit, T=2, input bit 0 of case 1 shifted
             by q/2), on the device branch and the host branch: sums
             right, one lane per repair, each in case 1, reading the
             corrupted wire, naming its gate's op and output wire.
 25. ntt     fhe/ntt_dev.py on the card == fhe/ntt.py at N=1024 (forward,
             inverse, product) at B = 4 and 2048; one STD128_OPT step's
             product in NTT form == torch._int_mm on the materialized
             negacyclic matrix plus the limb combine (B = 32, 2048);
             times of the transforms and of that product beside
             torch._int_mm's and #3's (when neg-kernel ran).
 26. native  the port's native parser and levelizer (g++ from
             oece_tpu_torch/csrc/host/oece_native.cpp into
             build/oece_tpu_torch/, failing if it does not build) ==
             the Python versions on examples/new_bristol_ckts/crypto/
             sha256.txt; both timed.
 27. mesh    a one-rank NCCL process group and its (1, 1) parallel.mesh:
             Circuit(mesh=...) adder_32bit verify T=4 at STD128_OPT, the
             batches through bootstrap_sharded (no padding and no gather
             at dp = 1, #12's kernels): sums right, no repair, outputs ==
             phase circuit's, #12 only; then, warm, without the mesh on
             the host branch and with it again, timed.
 28. tp      tensor parallelism on the card (std.blind_rotate_std_tp,
             STD128_OPT golden host keys of seed 0 from fhe/keycache.py):
             #1, #3 and #5 against their plain twins at R = 1, 2 and 4 key
             rows and #6 at B = 4 and 64; for tp = 2 and 4 at B = 4 and
             64, each rank's raw limb sums of one step through #5 and
             through #1 then #3, summed over the ranks, == the unsharded
             step's, and after the combine and #6 == std.std_step_plain;
             the device times of both products per rank at R = 2 and 1
             (B = 8, 64) and of #6, with bounds; then two gloo processes
             on cuda:0 (torch.multiprocessing, each loading the cached
             keys): adder_2bit verify T=4 through Circuit(mesh=...) on a
             (1, 2) mesh and unsharded: right sums, no repair, the same
             ciphertexts, walls; a batch of 64 gates through
             eval_bin_gate_sharded == the unsharded batch bit for bit (a
             (2, 1) mesh's too, its gather staged through the host), its
             step split into device time by kernel (16 steps under the
             profiler), the all-reduce alone (at 64 and 4 gates, card and
             host tensors) and the rest; the sharded runs launch the tp
             route's kernels only (#5 and #6; not #1, #3, the std step
             loop or a plain version).
 29. noise   the port's noise tools at STD128_OPT through their functions
             (oece_tpu_torch/tools/measure_noise.py run: 20 chained batches
             of 1024 mixed gates each on rev2 and rev device keys and on
             host keys, 10 on the rev2 keys of seeds 1-4;
             measure_xor_noise.py run: 10 chained batches of 2048 per gate
             type, XOR, AND, XNOR, OR, on rev2), each chunk with the card's
             sync debug mode at "error" (no host wait between progress
             lines): no failure (|e| >= q/8) anywhere; sigma, max |e| and
             margin/sigma beside NOISE.md's TPU sigma, and each key's mean
             beside the one its key-switch key predicts.
 30. level-edges  pure-encrypted STD128 Clocks at T=4, recovery off (the
             benchmark's evaluation): GINX adder_32bit and mult_32x32 on
             device rev2 keys, and AP adder_32bit, the control.  After a
             warm Clock, one with the card's sync debug mode at "warn" from
             SetInput's end to collect: GINX must not warn, AP warns once
             a rotating level (its live count); every output bit equals
             the plaintext evaluation's; the levels' device walls (wall_s)
             sum to within 2% of the Clock's host total.  The second of
             two traced Clocks prints edge_overlap_levels over the rotating
             levels and the host waits inside levels.

The phases run in that order, except that 28 and 29 come right after 17.
Each main-path run (phases 4, 7, 9, 10, 14, 15, 17-21, 27 and 28) sets every
launch count to 0 just before it and reads the counts just after: the
rotation calls that reached each version, and each CUDA kernel's launches
(one per step; in phase 17 one per call of a kernel of fhe/negacyclic.py);
phase 22 checks that no kernel ran and the generic rotation did; in
phase 28 each process resets and reads its own counts, and rank 0's go
into the kernels line beside phase 17's.
The last two lines are the kernels' JSON record and {"ok": true,
"device": {...}}.  JAX and the JAX package are blocked from being
imported.  ``python3 chip_smoke.py PHASE ...`` runs the build and the
named phases only, and prints no kernels line; it too ends with {"ok":
true, ...}, which names the phases.
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
MULT = os.path.join(REPO, "examples", "old_bristol_ckts", "arith", "mult_32x32.txt")

# One NVIDIA H100 SXM (data sheet, dense): int8 tensor-core peak and HBM rate.
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12

# device_ms: the host's wait on each edge of a profile window, the fill
# launches on each side of its first wait, and how many windows in a row
# may miss a timed launch's record before it fails.
EDGE_S = 0.25
FILLS = 16
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


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from oece_tpu_torch.fhe import ap, negacyclic, rev, rot, std

    for m in (ap, rev, rot, std):
        m.LAUNCHES = 0
        m.PLAIN_LAUNCHES = 0
        m.STEP_LAUNCHES = 0
    rot.SINGLE_STEP_LAUNCHES = 0
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
    if kernel == "ap":
        return ap.KERNEL_LAUNCHES
    return {"rot": rot, "ap": ap, "std": std, "rev": rev}[kernel].STEP_LAUNCHES


def check_only(phase: str, counts: dict, kernel: str) -> int:
    """Fail unless ``kernel`` launched and nothing else did; returns the
    launches of each of its CUDA kernels."""
    others = {k: v for k, v in counts.items() if k != kernel and v}
    if counts[kernel] == 0 or others:
        fail(f"{phase}: launches {counts}: want {kernel} only")
    return read_step_launches(kernel)


def open_window() -> None:
    """A profile window's first launches, before the timed ones: FILLS
    fills, EDGE_S of waiting, FILLS more.  The profiler may lose the
    window's first records (window_span says which went)."""
    import torch

    for _ in range(FILLS):
        torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    time.sleep(EDGE_S)
    for _ in range(FILLS):
        torch.zeros(1, device="cuda")


def device_ms(fn, reps: int, *kernels: str, per_call: int = 1) -> list[float]:
    """Device time per call of fn spent in the CUDA kernels whose name
    contains each of ``kernels`` (torch.profiler), each launched
    ``per_call`` times per call: for kernels shorter than the host's launch
    overhead, where back-to-back CUDA events time the host instead.

    On the card's machine the profiler often loses a window's first
    records, and late in a long process it lost the first five (PERF.md
    §7), so open_window's fills go first, and the host waits ``EDGE_S`` on
    each edge of the window.  A window that still misses a timed record is
    said, with what it kept, and taken again, and ``WINDOWS`` such windows
    in a row fail: a time comes only from a window that recorded every
    launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    want = [reps * per_call] * len(kernels)
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_window()
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
            print(f"device_ms: the profiler dropped every fill record, timing {kernels}", flush=True)
        if counts == want:
            return [us / 1e3 / reps for us in totals]
        print(f"device_ms: the profiler recorded {counts} launches of {kernels}, want {want} "
              f"({window_span(prof, kernels)}); taking the window again", flush=True)
    fail(f"the profiler missed launches of {kernels} in {WINDOWS} windows in a row")


def window_span(prof, kernels) -> str:
    """What a profile window kept: the fill records from before and after
    open_window's wait (of FILLS each), and the span of the records of
    ``kernels``."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    t = sorted(e.time_range.start for e in evs if any(k in e.name for k in kernels))
    if not t:
        return f"{len(evs)} CUDA records, none of these"
    fills = [e.time_range.start for e in evs if "FillFunctor" in e.name and e.time_range.start < t[0]]
    early = sum(f < t[0] - 5e5 * EDGE_S for f in fills)  # before the wait
    return (f"{len(evs)} CUDA records; fills kept {early} of {FILLS} before the wait and "
            f"{len(fills) - early} of {FILLS} after it; these span {(t[-1] - t[0]) / 1e3:.1f} ms")


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
    # #2 and #7 on their Hopper kernels: the mma.sync route is gone
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
# STD128's tiled GEMMs: gate tiles fitted to B (144 at 132, 192 at 180, 2 x
# 144 at 257, 2 x 160 at 300), around the 256-gate tile, and 16 x 256
WIDE_BATCHES = (17, 132, 180, 256, 257, 300, 512, 4096)
NARROW_BATCHES = (4, 8)  # STD128's split GEMM: the narrow circuits' lanes, and B = NB


def _rot_sets():
    """The parameter sets of the #12 and #11 checks."""
    from oece_tpu_torch.fhe.params import MICRO_A, STD128_OPT, TOY

    return (dataclasses.replace(STD128_OPT, n=8), MICRO_A, dataclasses.replace(TOY, n=4))


def card_key(rev2):
    """rev2 in the layout of the card's kernel: K-major (keys.rev2_to)."""
    from oece_tpu_torch.fhe import keys

    return keys.rev2_to(rev2, "cuda")


def card_rev(rev):
    """A rev key [n, rows, 16T] (or one step's block [rows, M*T]) in the
    layout of the card's kernels: K-major (keys.rev_to; a block as [M, T,
    rows])."""
    from oece_tpu_torch.fhe import keys

    if rev.ndim == 3:
        return keys.rev_to(rev, "cuda")
    return rev.t().reshape(rev.shape[1] // 128, 128, rev.shape[0]).contiguous()


def phase_kernel():
    import torch
    from oece_tpu_torch.fhe import rot
    from oece_tpu_torch.fhe.params import STD128, STD128_OPT

    t0 = time.time()
    max_err = 0
    cases = [(p, B) for p in _rot_sets() for B in ROT_BATCHES]
    cases += [(dataclasses.replace(STD128, n=2), B) for B in WIDE_BATCHES]
    cases += [(dataclasses.replace(STD128, n=3), B) for B in NARROW_BATCHES]
    for i, (p, B) in enumerate(cases):
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


def sweep_cases(std_opt, std128):
    """The sweeps' (params, B, split into kernels): STD128_OPT at B = 1
    ... 2048, split at B = 4 and 2048; STD128 (exact gadget, d = 4) at
    NARROW_BATCHES and WIDE_BATCHES, each split."""
    cases = [(std_opt, B, B in (4, 2048)) for B in (1, 4, 8, 16, 64, 256, 1024, 2048)]
    return cases + [(std128, B, True) for B in NARROW_BATCHES + WIDE_BATCHES]


def compact_roofline_ms(p, B) -> float:
    """The benchmark's least time of one GINX step of B gates
    (fhe_bench/roofline.py: the work, on the compact key), ms."""
    from fhe_bench import roofline

    return 1e3 * roofline.ginx_call({"N": p.N, "n": 1}, p.d_g_used, B)[0]


def split_step_checks(p, B, acc, rev2, keyT, a2N, t0) -> dict:
    """The split GEMM's narrow STD128 step: the rotation == its plain
    version bit for bit, and the GEMM of one step by #11 calls over one
    block (L2-warm after the first) against calls over the rotation's
    distinct blocks (from HBM), each by the profiler's timeline (the host
    launches each call after the last has ended, so each kernel's time is
    its own)."""
    import torch
    from oece_tpu_torch.fhe import rot

    got = rot.blind_rotate_rot(acc, keyT, a2N, p)
    _check_same("rot-sweep", f"#12 {p.name} n={p.n} B={B}", got,
                rot.blind_rotate_rot_plain(acc, rev2, a2N, p), t0)
    amt = rot.amount_pairs(a2N[:, 0], p.N).contiguous()
    out = torch.empty_like(acc)
    res = {}
    for name, blocks in (("warm", [0] * p.n), ("cold", list(range(p.n)))):
        run = lambda: [rot.rot_step_true(acc, keyT[i], amt, p, out=out) for i in blocks]  # noqa: E731
        per, _, _ = kernel_timeline(run, ("rot_diff_decompose_kernel", "rot_gemm"), p.n, want=2 * p.n)
        res[f"gemm_{name}_ms"] = per["rot_gemm"]
    log("rot-sweep", t0, f"{p.name} B={B} one step's GEMM by #11 calls: L2-warm block "
        f"{1e3 * res['gemm_warm_ms']:.2f} us, {p.n} blocks from HBM {1e3 * res['gemm_cold_ms']:.2f} us")
    return res


def phase_rot_sweep():
    """#12's step time by batch size against its bound (sweep_cases), with
    the step GEMM that rot.gemm_config chooses; the splits into the
    digits, the GEMM and the launch gaps."""
    from oece_tpu_torch.fhe import rot
    from oece_tpu_torch.fhe.params import STD128, STD128_OPT

    t0 = time.time()
    res = {}
    for p, B, split in sweep_cases(dataclasses.replace(STD128_OPT, n=16), dataclasses.replace(STD128, n=16)):
        acc, rev2, a2N = rotation_inputs(p, B, p.n, "rev2", seed=900 + B + 10000 * (p.d_g_used == 4))
        keyT = card_key(rev2)
        rotate = lambda: rot.blind_rotate_rot(acc, keyT, a2N, p)  # noqa: E731
        ms = cuda_time_ms(rotate, reps=10 if B < 1024 else 3) / p.n
        bnd = _rot_step_bound(p, B)
        gemm = rot.gemm_config(B, p.N, 4 * p.d_g_used, 2)
        r = res[B if p.name == "STD128_OPT" else f"{p.name} B={B}"] = {
            "ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1], "gemm_config": gemm}
        log("rot-sweep", t0, f"{p.name} step B={B} (NB, MW, split) {gemm}: {1e3 * ms:.1f} us, bound "
            f"{1e3 * bnd[0]:.1f} us ({bnd[1]}), {bnd[0] / ms:.1%} of the bound")
        if split:
            per, _, idle = kernel_timeline(rotate, ("rot_diff_decompose_kernel", "rot_gemm"), p.n, want=2 * p.n)
            digits, mm = per["rot_diff_decompose_kernel"], per["rot_gemm"]
            r.update(digits_ms=digits, gemm_ms=mm, gap_ms=idle)
            log("rot-sweep", t0, f"{p.name} B={B} per step (profiler timeline): digits {1e3 * digits:.2f} us, "
                f"GEMM {1e3 * mm:.2f} us, of which no kernel running {1e3 * idle:.2f} us; "
                f"events {1e3 * ms:.2f} us")
        if p.name == "STD128" and B in NARROW_BATCHES:
            roof = compact_roofline_ms(p, B)
            r.update(compact_roofline_ms=roof, **split_step_checks(p, B, acc, rev2, keyT, a2N, t0))
            log("rot-sweep", t0, f"{p.name} B={B}: step {1e3 * ms:.2f} us, {bnd[0] / ms:.1%} of the "
                f"block's HBM floor ({1e3 * bnd[0]:.2f} us); compact-key roofline {1e3 * roof:.3f} us, "
                f"{roof / ms:.2%}")
        del keyT, rev2
    return res


def _ap_inputs(p, B, seed, kind="modswitch", steps=None):
    """Random accumulator, random int8 ap_ext bytes (``steps`` of them, all
    n*d_r by default) and rotation amounts: multiples of 2N/q (what the mod
    switch gives: at STD128_OPT even, so every step j = 0 is dead), any
    value in [0, 2N) (every step selects for about half the gates), or all
    0 (nothing selected), or all 1 (every gate live at every step).  Lane 0
    of a batch of more than one has a=0, so it selects nothing, except
    under "all"."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    R = 2 * p.d_g_used
    acc = torch.randint(0, p.Q, (B, 2, p.N), generator=g, device="cuda", dtype=torch.int32)
    ext = torch.randint(-128, 128, (steps or p.n * p.d_r, R, 8, 2 * p.N), generator=g, device="cuda",
                        dtype=torch.int8)
    if kind == "any":
        a2N = torch.randint(0, 2 * p.N, (B, p.n), generator=g, device="cuda", dtype=torch.int32)
    elif kind == "all":  # a = 1: every bit of 2N - a set, so every gate live at every step
        a2N = torch.ones((B, p.n), device="cuda", dtype=torch.int32)
    else:
        scale = 2 * p.N // p.q
        a2N = scale * torch.randint(0, p.q, (B, p.n), generator=g, device="cuda", dtype=torch.int32)
        if kind == "zero":
            a2N.zero_()
    if B > 1 and kind != "all":
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
        mask, rank0, count = ap.live_table(a2N, p)
        pm, pr, pc = ap.live_table_plain(a2N, p)
        if not (torch.equal(mask.long() & 0xFFFFFFFF, pm) and torch.equal(rank0, pr) and torch.equal(count, pc)):
            fail(f"ap-kernel: the live-gate table kernel != its plain twin at {p.name} B={B} {kind}")
        if steps != int((pc > 0).sum()):
            fail(f"ap-kernel: {steps} steps launched, {int((pc > 0).sum())} live at {p.name} B={B} {kind}")
        if kind == "zero" and (steps != 0 or not torch.equal(got, acc)):
            fail(f"ap-kernel: an all-zero batch of {B} changed the accumulator or launched a step")
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
            open_window()
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
    launch gaps per step from the profiler's timeline."""
    from oece_tpu_torch.fhe import ap
    from oece_tpu_torch.fhe.params import STD128_OPT

    t0 = time.time()
    p = dataclasses.replace(STD128_OPT, n=8)
    steps = p.n * p.d_r
    names = ("ap_live_kernel", "ap_digits_kernel", "ap_split_kernel", "ap_gemm_kernel")
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
    OUTPUTS[phase] = [o.copy() for o in c.GetOutput()]
    log(phase, t0, f"{method} adder_32bit verify T=4: sums == a+b; wall {wall:.2f}s; "
        f"bad_gate_counts {c.bad_gate_counts}; trace {c.trace.summary()}; "
        f"{level_walls(c)}; rotation calls {counts}, {launches} launches of each {kernel} kernel")
    del c
    torch.cuda.empty_cache()
    return launches


WALLS: dict = {}  # each circuit phase's Clock() wall (s)
OUTPUTS: dict = {}  # each circuit phase's GetOutput()
RESULTS: dict = {}  # each finished phase's return value, for later phases


def level_walls(c) -> str:
    """The check branch and the per-level wall of the last Clock's trace."""
    w = np.array([r.wall_s for r in c.trace.records])
    return (f"{'device' if c._dev_branch else 'host'} branch, {len(w)} levels, per-level wall "
            f"median {1e3 * np.median(w):.3f} ms, mean {1e3 * w.mean():.3f} ms, first "
            f"{1e3 * w[0]:.3f} ms, max {1e3 * w.max():.3f} ms")


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
    (torch.profiler's kernel timeline)."""
    from oece_tpu_torch.fhe import std
    from oece_tpu_torch.fhe.params import STD128_OPT

    t0 = time.time()
    p = dataclasses.replace(STD128_OPT, n=16)
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
            per, counts, idle = kernel_timeline(rotate, STD_NAMES, p.n, want=3 * p.n + 1)
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
    (torch.profiler, after open_window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_window()
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
    bounds.  Each rotation's line prints the step GEMM that rot.gemm_config
    chooses (NB, MW, split)."""
    import torch
    from oece_tpu_torch.fhe import rev, rot
    from oece_tpu_torch.fhe.params import MICRO, STD128, STD128_OPT, TOY

    t0 = time.time()
    std8 = dataclasses.replace(STD128_OPT, n=8)
    cases = [(std8, B) for B in REV_BATCHES]
    cases += [(dataclasses.replace(q, n=n), B) for q, n in ((STD128, 2), (MICRO, 4), (TOY, 3))
              for B in (4, 13, 37)]
    cases += [(dataclasses.replace(STD128, n=2), B) for B in WIDE_BATCHES]
    err = 0
    for i, (p, B) in enumerate(cases):
        acc, rev_all, a2N = rotation_inputs(p, B, p.n, "rev", seed=400 + i)
        got = rev.blind_rotate_rev(acc, card_rev(rev_all), a2N, p)
        what = (f"rotation {p.name} N={p.N} R={2 * p.d_g_used} n={p.n} B={B} "
                f"{rot.gemm_config(B, p.N, 2 * p.d_g_used, 4)}")
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
    # launch a kernel's own duration includes its wait for its predecessor;
    # the digits kernel runs once more per rotation, for the last CMUX
    per, _, _ = kernel_timeline(rotate, ("rev_digits_kernel", "rev_gemm"), n, want=2 * n + 1)
    dev = {"digits": per["rev_digits_kernel"], "matmul": per["rev_gemm"], "cmux": per["rev_digits_kernel"]}
    dig = torch.randint(-128, 128, (B, nt * R * 128), generator=g, device="cuda", dtype=torch.int8)
    P4 = rev.window_matmul_true_plain(dig, rev_all[0], p.Q)
    amt = torch.stack([(2 * p.N - a2N[:, 0]) & (2 * p.N - 1), a2N[:, 0]], dim=1).contiguous()
    P = P4.reshape(B, 2, 2, p.N)
    plain = {
        "window_matmul": lambda: rev.window_matmul_true_plain(dig, rev_all[0], p.Q),
        "matmul_dec": lambda: rev.window_matmul_dec_true_plain(acc, rev_all[0], p),
        "cmux": lambda: rev.cmux_epilogue_true_plain(P, acc, amt, p.Q),
    }
    # #8 is the GEMM, #9 the digits kernel and the GEMM; the CMUX of #10
    # runs inside the digits kernel, which is timed whole
    res["window_matmul"] = {"ms": dev["matmul"]}
    res["matmul_dec"] = {"ms": dev["digits"] + dev["matmul"]}
    res["cmux"] = {"ms": dev["cmux"]}
    ops_mm = 2.0 * B * nt * (nt * R * 128) * 16 * 128
    blk, acc_b, P4_b = rev_all[0].numel(), acc.numel() * 4, P4.numel() * 4
    cmux_bytes = P4_b + 2 * acc_b + amt.numel() * 4 + dig.numel()
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


# Every epilogue shape of the tiled GEMM: NB % 64 = 0, 16, 32 and 48, one
# and two math warpgroups, and three gate tiles (684 = 3 x 228 in 3 x 240)
TILE_BATCHES = (17, 33, 132, 144, 200, 256, 257, 300, 512, 684)


def tile_batches(p) -> list:
    """TILE_BATCHES, then a ragged B for every other (NB, MW) that
    rot.gemm_config returns above 16 gates (NB - 5 gates in one
    warpgroup's tile, 2NB - 7 in two of two warpgroups'): every template
    instance of the tiled GEMM (step_gemm.cuh: with_tile)."""
    from oece_tpu_torch.fhe import rot

    config = lambda B: rot.gemm_config(B, p.N, 4 * p.d_g_used, 2)[:2]  # noqa: E731
    want = {config(B) for B in range(17, 4097)}
    batches = list(TILE_BATCHES)
    batches += [nb - 5 if mw == 1 else 2 * nb - 7 for nb, mw in sorted(want - {config(B) for B in batches})]
    if {config(B) for B in batches} != want:
        fail(f"gemm-tiles: {batches} miss instances of {sorted(want)}")
    return batches


def phase_gemm_tiles():
    """Every instance of the tiled step GEMM against its plain twin, bit for
    bit, at STD128 (exact gadget, d = 4): rot_gemm_kernel (#12, n=2),
    rev_gemm_kernel (the rev rotation, n=2) and AP's ap_gemm_kernel (n=1,
    11 steps, every gate live at every step, so each step runs the tile
    of L = B), at tile_batches' B; random keys, a=0 lanes (GINX)."""
    import torch
    from oece_tpu_torch.fhe import ap, rev, rot
    from oece_tpu_torch.fhe.params import STD128

    t0 = time.time()
    p, pa = dataclasses.replace(STD128, n=2), dataclasses.replace(STD128, n=1)
    batches = tile_batches(p)
    err = 0
    for i, B in enumerate(batches):
        tile = rot.gemm_config(B, p.N, 4 * p.d_g_used, 2)
        acc, rev2, a2N = rotation_inputs(p, B, p.n, "rev2", seed=3000 + i)
        got = rot.blind_rotate_rot(acc, card_key(rev2), a2N, p)
        err = max(err, _check_same("gemm-tiles", f"rot_gemm_kernel B={B} (NB, MW, split) {tile}", got,
                                   rot.blind_rotate_rot_plain(acc, rev2, a2N, p), t0))
        del rev2
        acc, rev_all, a2N = rotation_inputs(p, B, p.n, "rev", seed=4000 + i)
        got = rev.blind_rotate_rev(acc, card_rev(rev_all), a2N, p)
        err = max(err, _check_same("gemm-tiles", f"rev_gemm_kernel B={B} "
                                   f"{rot.gemm_config(B, p.N, 2 * p.d_g_used, 4)}", got,
                                   rev.blind_rotate_rev_plain(acc, rev_all, a2N, p), t0))
        del rev_all
        acc, ext, a2N = _ap_inputs(pa, B, seed=5000 + i, kind="all")
        steps0 = ap.STEP_LAUNCHES
        got = ap.blind_rotate_ap(acc, ext, a2N, pa)
        steps = ap.STEP_LAUNCHES - steps0
        err = max(err, _check_same("gemm-tiles", f"ap_gemm_kernel L=B={B} ({steps} live steps) "
                                   f"{rot.gemm_config(B, pa.N, 2 * pa.d_g_used, 2, ap.split_smem)}", got,
                                   ap.blind_rotate_ap_plain(acc, ext, a2N, pa), t0))
        if steps != pa.n * pa.d_r:
            fail(f"gemm-tiles: {steps} AP steps launched at B={B}, want all {pa.n * pa.d_r} live")
    log("gemm-tiles", t0, f"{len(batches)} batches, every tiled instance == its plain twin: {batches}")
    return {"batches": batches, "max_abs_err": err}


def phase_rev_sweep():
    """The rev step by batch size against its bound (sweep_cases; a
    rotation over 16 distinct random blocks, so each step reads its block
    from HBM; CUDA events), with the step GEMM that rot.gemm_config
    chooses, and where the case says so the step split into its kernels
    and the launch gaps (torch.profiler's kernel timeline)."""
    from oece_tpu_torch.fhe import rev, rot
    from oece_tpu_torch.fhe.params import STD128, STD128_OPT

    t0 = time.time()
    res = {}
    for p, B, split in sweep_cases(dataclasses.replace(STD128_OPT, n=16), dataclasses.replace(STD128, n=16)):
        acc, rev_all, a2N = rotation_inputs(p, B, p.n, "rev", seed=800 + B + 10000 * (p.d_g_used == 4))
        key = card_rev(rev_all)
        del rev_all
        rotate = lambda: rev.blind_rotate_rev(acc, key, a2N, p)  # noqa: E731
        ms = cuda_time_ms(rotate, reps=10 if B < 1024 else 3) / p.n
        bnd = _rev_step_bound(p, B)
        gemm = rot.gemm_config(B, p.N, 2 * p.d_g_used, 4)
        r = res[B if p.name == "STD128_OPT" else f"{p.name} B={B}"] = {
            "ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1], "gemm_config": gemm}
        log("rev-sweep", t0, f"{p.name} step B={B} (NB, MW, split) {gemm}: {1e3 * ms:.1f} us, bound "
            f"{1e3 * bnd[0]:.1f} us ({bnd[1]}), {bnd[0] / ms:.1%} of the bound")
        if split:
            per, counts, idle = kernel_timeline(rotate, ("rev_digits_kernel", "rev_gemm"), p.n, want=2 * p.n + 1)
            r.update(kernels_ms=per, launches=counts, gap_ms=idle)
            log("rev-sweep", t0, f"{p.name} B={B} per step (profiler timeline): "
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
    bounds and library calls."""
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
    # #2 around its split (<= 16) and tiled GEMMs' gate tiles (fitted to B,
    # two warpgroups above 256 gates), both plane counts, and at N=512; #1
    # and #7 there
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
    res = {}
    for B in (4, 2048):
        dig, P, acc, amt = inputs[B]
        mm_ops = 2.0 * B * nt * K * 16 * 128
        raw, comb = B * 16 * N * 4, B * 4 * N * 4
        cyc = itertools.cycle(blocks)
        # #2: the transpose, then #8's GEMM; the split GEMM (B <= 16) adds
        # partial sums that rev_reduce_kernel takes mod Q (its zeroing
        # memset, 64 KB at B=4, is not timed)
        window_names = ("transpose_kernel", "rev_gemm") + (("rev_reduce_kernel",) if B <= 16 else ())
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


def phase_ap_generic():
    """The generic-base AP method (TOY, B_r = 32; ap.blind_rotate_ap_generic,
    torch ops, on golden's host keys as in the JAX package): adder_32bit
    verify T=4 on the card with no repair, then the TB adders at -s TOY
    -m AP through tb.main; only the generic rotation ran, no kernel."""
    import contextlib
    import io

    import torch
    from oece_tpu_torch.fhe import ap
    from oece_tpu_torch.harness import tb
    from oece_tpu_torch.runtime.evaluator import Circuit

    t0 = time.time()
    c = Circuit(set="TOY", method="AP", seed=0, device="cuda")
    p = c.params
    log("ap-generic", t0, f"TOY AP keygen (host draws, device products) {c.keygen_s:.1f}s, ap_ext "
        f"{tuple(c.keys.ap_ext.shape)} ({c.keys.ap_ext.numel() / 2**20:.0f} MiB)")
    c.ReadFile(ADDER)
    c.setVerify(True)
    a, b, ins = adder_inputs()
    c.SetInput(ins)
    reset_counts()
    g0 = ap.GENERIC_LAUNCHES
    ts = time.time()
    c.Clock()
    torch.cuda.synchronize()
    wall = time.time() - ts
    counts, calls = read_counts(), ap.GENERIC_LAUNCHES - g0
    if any(counts.values()) or calls == 0:
        fail(f"ap-generic: kernel launches {counts}, generic rotations {calls}: want generic only")
    if not np.array_equal(adder_sums(c), a + b):
        fail(f"ap-generic: adder_32bit sums {adder_sums(c)} != {a + b}")
    if sum(c.bad_gate_counts.values()):
        fail(f"ap-generic: verify repaired {c.bad_gate_counts}, want none")
    boots = c.trace.total_bootstraps
    log("ap-generic", t0, f"TOY AP (n={p.n}, N={p.N}, B_r={p.B_r}, d_r={p.d_r}) adder_32bit verify T=4: "
        f"sums == a+b, no repair; wall {wall:.2f}s, {boots} bootstraps = {boots / wall:.1f} bootstraps/s; "
        f"{calls} generic rotations; {level_walls(c)}")
    # where a rotation's time goes: one whole rotation at B = 8 against one
    # digit value's matrix build and product (CUDA events)
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(rng.integers(0, p.Q, (8, 2, p.N)).astype(np.int32)).cuda()
    a2N = torch.from_numpy(rng.integers(0, 2 * p.N, (8, p.n)).astype(np.int32)).cuda()
    ext = c.keys.ap_ext
    rot_ms = cuda_time_ms(lambda: ap.blind_rotate_ap_generic(acc, ext, a2N, p), reps=3)
    mat = ap.negacyclic_matrices(ext[5:6])[0]
    dig = torch.randint(-64, 64, (ap.MIN_ROWS, mat.shape[0]), dtype=torch.int8, device="cuda")
    mat_ms = cuda_time_ms(lambda: ap.negacyclic_matrices(ext[5:6]), reps=20)
    mm_ms = cuda_time_ms(lambda: torch._int_mm(dig, mat), reps=20)
    groups = sum(len(set(col.tolist()) - {0}) for col in ap.ap_digit_values(a2N, p).t().cpu())
    log("ap-generic", t0, f"one rotation at B=8: {rot_ms:.2f} ms for {groups} digit-value groups "
        f"({p.n * p.d_r} steps); one group's matrix ({mat.numel() / 2**20:.1f} MiB) {1e3 * mat_ms:.1f} us, "
        f"its torch._int_mm on {ap.MIN_ROWS} rows {1e3 * mm_ms:.1f} us")
    del c, ext, mat
    torch.cuda.empty_cache()
    buf = io.StringIO()
    ts = time.time()
    g0 = ap.GENERIC_LAUNCHES
    with contextlib.redirect_stdout(buf):
        rc = tb.main(["adders", "-c", "1", "-n", "4", "-m", "AP", "-s", "TOY", "--seed", "0",
                      "--device", "cuda"])
    torch.cuda.synchronize()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith(("PASS", "FAIL"))]
    if rc != 0 or len(lines) != 1 or not lines[0].startswith("PASS") or "bad gates fixed" in lines[0]:
        print(buf.getvalue(), flush=True)
        fail(f"ap-generic: tb adders -s TOY -m AP returned {rc}, bench lines {lines}")
    log("ap-generic", t0, f"tb adders -c 1 -n 4 -s TOY -m AP: {lines[0]} ({time.time() - ts:.2f}s, "
        f"{ap.GENERIC_LAUNCHES - g0} generic rotations)")
    torch.cuda.empty_cache()
    return {"wall_s": wall, "bootstraps_per_s": boots / wall, "rotation_ms": rot_ms}


def phase_checkpoint():
    """adder_32bit verify T=4 at STD128_OPT on the device branch, one input
    of case 1 shifted by q/2 (so its first consumers are repaired), Clock()ed
    once whole, then again from the same generator state with a checkpoint
    every 10 levels and an interruption before level 20, and resumed:
    outputs, ciphertext arena, bad_gate_counts, bad_gate_levels and
    recover_counts must equal the whole run's."""
    import copy

    import torch
    from oece_tpu_torch.runtime import checkpoint
    from oece_tpu_torch.runtime.evaluator import Circuit

    t0 = time.time()
    c = Circuit(set="STD128_OPT", seed=0, device="cuda")
    c.ReadFile(ADDER)
    c.setVerify(True)
    a, b, ins = adder_inputs()
    rng0 = copy.deepcopy(c._rng)

    def set_input():
        """The inputs, with b of input bit 0 in case 1 shifted by q/2: its
        first consumers (level 1) are repaired, before the interruption."""
        c.SetInput(ins)
        c._ct_arena[int(c._slot[int(c.netlist.inputs[0][0])]), 1, -1] += c.params.q // 2

    set_input()
    ts = time.time()
    c.Clock()
    torch.cuda.synchronize()
    whole = time.time() - ts
    want = dict(out=[o.copy() for o in c.GetOutput()], arena=c._ct_arena.clone(),
                bad=dict(c.bad_gate_counts), lv=dict(c.bad_gate_levels), rec=dict(c.recover_counts))
    if not c._dev_branch or not np.array_equal(adder_sums(c), a + b) or not want["bad"]:
        fail(f"checkpoint: device branch {c._dev_branch}, sums {adder_sums(c)} (want {a + b}), "
             f"repairs {want['bad']} (want some)")

    c.Reset()
    c._rng, c._gen = rng0, None  # the same draws as the whole run
    set_input()
    ck = os.path.join(REPO, "build", "chip_smoke_checkpoint.npz")
    os.makedirs(os.path.dirname(ck), exist_ok=True)
    if os.path.exists(ck):
        os.remove(ck)
    saves, resumes = [], []
    real_save, real_resume, real_run = checkpoint.save, checkpoint.maybe_resume, c._run_level

    def timed_save(circ, path, next_level):
        """The save, timed after the work queued on the card has ended, and
        its split: the host copy of the state, then np.savez and
        np.savez_compressed of it (side files, removed)."""
        torch.cuda.synchronize()
        ts = time.time()
        real_save(circ, path, next_level)
        total = time.time() - ts
        ts = time.time()
        meta, arrays = checkpoint.state(circ, next_level)
        split = [time.time() - ts]
        for compress in (False, True):
            side = f"{path}.{int(compress)}.npz"
            ts = time.time()
            checkpoint.write(side, meta, arrays, compress)
            split += [time.time() - ts, os.path.getsize(side)]
            os.remove(side)
        saves.append((total, os.path.getsize(path), *split))

    def timed_resume(*args):
        ts = time.time()
        lv = real_resume(*args)
        resumes.append((time.time() - ts, lv))
        return lv

    class Interrupted(RuntimeError):
        pass

    def failing(level):
        if c._cur_level == 20:
            raise Interrupted()
        real_run(level)

    checkpoint.save, checkpoint.maybe_resume = timed_save, timed_resume
    try:
        c._run_level = failing
        try:
            c.Clock(checkpoint_path=ck, checkpoint_every=10)
            fail("checkpoint: the interruption before level 20 did not happen")
        except Interrupted:
            pass
        c._run_level = real_run
        ts = time.time()
        c.Clock(checkpoint_path=ck, checkpoint_every=10)
        torch.cuda.synchronize()
        resumed = time.time() - ts
    finally:
        checkpoint.save, checkpoint.maybe_resume = real_save, real_resume
    if [lv for _, lv in resumes] != [0, 20] or os.path.exists(ck):
        fail(f"checkpoint: resumed at levels {resumes}, file left {os.path.exists(ck)}")
    got_out = c.GetOutput()
    same = (all(np.array_equal(x, y) for x, y in zip(got_out, want["out"]))
            and torch.equal(c._ct_arena, want["arena"]) and c.bad_gate_counts == want["bad"]
            and c.bad_gate_levels == want["lv"] and c.recover_counts == want["rec"])
    if not same:
        fail(f"checkpoint: the resumed run differs from the whole one: bad {c.bad_gate_counts} vs "
             f"{want['bad']}, recover {c.recover_counts} vs {want['rec']}")
    log("checkpoint", t0, f"adder_32bit verify T=4, device branch: whole Clock {whole:.2f}s; interrupted "
        f"before level 20 with a checkpoint every 10 levels and resumed at level {resumes[-1][1]}: "
        f"outputs, ciphertext arena, bad_gate_counts {c.bad_gate_counts}, recover_counts "
        f"{c.recover_counts} == the whole run's; saves (np.savez) "
        f"{', '.join(f'{1e3 * s[0]:.1f} ms ({s[1] / 2**20:.2f} MiB)' for s in saves)}, resume "
        f"{1e3 * resumes[-1][0]:.1f} ms, resumed Clock {resumed:.2f}s; split per save (host copy ms / "
        f"np.savez ms, MiB / np.savez_compressed ms, MiB): "
        + ", ".join(f"{1e3 * g:.1f} / {1e3 * u:.1f}, {nu / 2**20:.3f} / {1e3 * z:.1f}, {nz / 2**20:.3f}"
                    for _, _, g, u, nu, z, nz in saves))
    del c
    torch.cuda.empty_cache()
    return {"save_ms": [1e3 * s[0] for s in saves], "resume_ms": 1e3 * resumes[-1][0]}


def phase_bad_trace():
    """OECE_BAD_TRACE=1 on tests/test_evaluator.py's corruption at
    STD128_OPT: adder_2bit verify, T=2, b of input bit 0 in case 1 shifted
    by q/2; on the device branch and the host branch every recorded lane
    sits in case 1, reads the corrupted wire and names its gate's op and
    output wire; one record per repair; the sums are right."""
    import torch
    from oece_tpu_torch.circuits.netlist import Op
    from oece_tpu_torch.runtime.evaluator import Circuit

    t0 = time.time()
    path = os.path.join(REPO, "examples", "simple_ckts", "adder_2bit", "adder_2bit.out")
    in1, in2 = np.array([[1, 0], [0, 1]]), np.array([[1, 1], [1, 0]])
    os.environ["OECE_BAD_TRACE"] = "1"
    try:
        c = Circuit(set="STD128_OPT", seed=0, device="cuda")
        c.ReadFile(path)
        for branch in ("1", "0"):
            os.environ["OECE_LEVEL_JIT"] = branch
            c.Reset()
            c.setVerify(True)
            c.SetInput([in1, in2])
            w = int(c.netlist.inputs[0][0])
            c._ct_arena[int(c._slot[w]), 1, -1] += c.params.q // 2
            c.Clock()
            sums = (c.GetOutput()[0] << np.arange(3)).sum(1)
            lanes = c.bad_gate_lanes
            ok = list(sums) == [4, 3] and lanes and len(lanes) == sum(c.bad_gate_counts.values())
            for rec in lanes:
                lv = c.plan.levels[rec["level"]]
                k = rec["lane"]
                ok = ok and rec["case"] == 1 and rec["wire"] == int(lv["boot_out"][k]) and (
                    rec["op"] == Op(int(lv["boot_op"][k])).name
                    and w in (int(lv["boot_in0"][k]), int(lv["boot_in1"][k])))
            if not ok or c._dev_branch != (branch == "1"):
                fail(f"bad-trace (OECE_LEVEL_JIT={branch}): sums {list(sums)}, lanes {lanes}, "
                     f"counts {c.bad_gate_counts}")
            log("bad-trace", t0, f"{'device' if branch == '1' else 'host'} branch: sums [4, 3], "
                f"{len(lanes)} lanes, each in case 1 reading wire {w}: {lanes}")
    finally:
        os.environ.pop("OECE_BAD_TRACE")
        os.environ.pop("OECE_LEVEL_JIT", None)
    del c
    torch.cuda.empty_cache()


def phase_ntt():
    """fhe/ntt_dev.py on the card against fhe/ntt.py (NumPy) at
    STD128_OPT's N = 1024, bit for bit (forward, inverse, product); the
    NTT form of one step's product (4 digit polynomials x a step key of 4
    polynomials) against the same product as torch._int_mm on the
    materialized negacyclic matrix and the limb combine; times of the
    transforms at B = 4 and 2048 polynomials and of the step product at
    B = 2048 gates beside #3's and torch._int_mm's."""
    import torch
    from oece_tpu_torch.fhe import keys, ntt, ntt_dev, rot
    from oece_tpu_torch.fhe.params import STD128_OPT

    t0 = time.time()
    p = STD128_OPT
    N, Q, R, M = p.N, p.Q, 2 * p.d_g_used, 16
    rng = np.random.default_rng(11)
    times = {}
    for B in (4, 2048):
        a = rng.integers(0, Q, (B, N))
        b = rng.integers(0, Q, (B, N))
        ad, bd = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        fa = ntt_dev.ntt_forward_dev(ad)
        ok = (np.array_equal(fa.cpu().numpy(), ntt.ntt_forward(a))
              and np.array_equal(ntt_dev.ntt_inverse_dev(ad).cpu().numpy(), ntt.ntt_inverse(a))
              and np.array_equal(ntt_dev.ntt_inverse_dev(fa).cpu().numpy(), a))
        if B == 4:
            ok = ok and np.array_equal(ntt_dev.negacyclic_mul_ntt_dev(ad, bd).cpu().numpy(),
                                       ntt.negacyclic_mul_ntt(a, b))
        if not ok:
            fail(f"ntt: ntt_dev != ntt.py at B={B}, N={N}")
        times[B] = (cuda_time_ms(lambda: ntt_dev.ntt_forward_dev(ad), reps=20),
                    cuda_time_ms(lambda: ntt_dev.ntt_inverse_dev(fa), reps=20))
    # one step's product: NTT form against the int8 GEMM on the negacyclic matrix
    polys = torch.from_numpy(rng.integers(0, Q, (R, 4, N))).cuda()
    ext = keys.ext_planes(polys.to(torch.int32), Q).reshape(R, M, 2 * N)
    full = negacyclic_matrix(ext)
    key_ntt = ntt_dev.ntt_forward_dev(polys.reshape(R * 4, N)).view(R, 4, N)
    prods = {}
    for B in (32, 2048):
        dig = torch.randint(-64, 64, (B, R, N), dtype=torch.int8, device="cuda")
        tiles = dig.view(B, R, N // 128, 128).permute(0, 2, 1, 3).reshape(B, -1)
        via_ntt = ntt_dev.step_product_ntt(dig, key_ntt, Q)
        via_mm = rot.combine_planes(torch._int_mm(tiles, full).view(B, M, N), Q)
        if not torch.equal(via_ntt, via_mm.to(torch.int64)):
            fail(f"ntt: the NTT form of the step product != torch._int_mm + combine at B={B}")
        prods[B] = (dig, tiles)
    dig, tiles = prods[2048]
    ntt_ms = cuda_time_ms(lambda: ntt_dev.step_product_ntt(dig, key_ntt, Q), reps=10)
    mm_ms = cuda_time_ms(lambda: torch._int_mm(tiles, full), reps=20)
    neg = RESULTS.get("neg-kernel", {}).get("diag", {})
    d3 = f"#3 {neg['ms']:.4f} ms (neg-kernel)" if neg else "#3 not run in this call"
    log("ntt", t0, f"ntt_dev == ntt.py (N={N}) at B = 4 and 2048; forward / inverse per batch: B=4 "
        f"{1e3 * times[4][0]:.1f} / {1e3 * times[4][1]:.1f} us, B=2048 {1e3 * times[2048][0]:.1f} / "
        f"{1e3 * times[2048][1]:.1f} us; one step's product at B=2048 gates (R={R} digit and 4 key "
        f"polynomials): NTT form {ntt_ms:.4f} ms (== torch._int_mm + combine at B = 32 and 2048), "
        f"torch._int_mm raw {mm_ms:.4f} ms, {d3}")
    return {"fwd_us": {B: 1e3 * t[0] for B, t in times.items()},
            "inv_us": {B: 1e3 * t[1] for B, t in times.items()}, "step_ntt_ms": ntt_ms, "int_mm_ms": mm_ms}


def phase_native():
    """The port's native parser and levelizer (g++ from
    oece_tpu_torch/csrc/host/oece_native.cpp into build/oece_tpu_torch/)
    on examples/new_bristol_ckts/crypto/sha256.txt against the Python
    versions: the same netlist and the same levels; both timed."""
    from oece_tpu_torch.circuits import bristol, native, netlist

    t0 = time.time()
    path = os.path.join(REPO, "examples", "new_bristol_ckts", "crypto", "sha256.txt")
    if not native.available():
        fail(f"native: the library did not build: {native.BUILD_ERROR}")
    ts = time.time()
    nl_c = native.parse_bristol_native(path)
    parse_c = time.time() - ts
    os.environ["OECE_NO_NATIVE"] = "1"
    try:
        ts = time.time()
        nl_py = bristol.parse_bristol(path)
        parse_py = time.time() - ts
    finally:
        os.environ.pop("OECE_NO_NATIVE")
    same = nl_c.n_wires == nl_py.n_wires and all(
        np.array_equal(getattr(nl_c, f), getattr(nl_py, f)) for f in ("op", "in0", "in1", "out")) and [
        list(w) for w in nl_c.inputs + nl_c.outputs] == [list(w) for w in nl_py.inputs + nl_py.outputs]
    ts = time.time()
    plan_c = netlist.levelize(nl_c)
    lev_c = time.time() - ts
    real = native.levelize_native
    native.levelize_native = lambda nl: None
    try:
        ts = time.time()
        plan_py = netlist.levelize(nl_py)
        lev_py = time.time() - ts
    finally:
        native.levelize_native = real
    same = same and len(plan_c.levels) == len(plan_py.levels) and all(
        all(np.array_equal(x[k], y[k]) for k in x) for x, y in zip(plan_c.levels, plan_py.levels))
    if not same:
        fail("native: the native netlist or levels differ from the Python versions")
    s = plan_c.stats()
    log("native", t0, f"sha256 ({nl_c.n_gates} gates, depth {s['depth']}, {s['bootstrap_gates']} "
        f"bootstrap gates): native == Python; parse {1e3 * parse_c:.1f} ms native, {1e3 * parse_py:.1f} "
        f"ms Python; levelize {1e3 * lev_c:.1f} ms native, {1e3 * lev_py:.1f} ms Python; g++ "
        f"{native.BUILD_SECONDS:.1f}s")
    return {"parse_ms": (1e3 * parse_c, 1e3 * parse_py), "levelize_ms": (1e3 * lev_c, 1e3 * lev_py)}


def phase_mesh():
    """A one-rank NCCL process group (tcp://localhost, a free port) and its
    (1, 1) mesh: Circuit(mesh=...) runs adder_32bit verify T=4 at
    STD128_OPT with the level batches through parallel.mesh
    (bootstrap_sharded: no padding and no gather at dp = 1, the
    rotation's kernels); its outputs must equal phase circuit's.  The NCCL
    communicator is set up by one all_gather before the timed Clock; the
    same circuit then runs without the mesh on the host branch, which a
    mesh takes, and with the mesh again: the two warm walls compare."""
    import socket

    import torch
    import torch.distributed as dist
    from oece_tpu_torch.parallel import mesh as mesh_mod
    from oece_tpu_torch.runtime.evaluator import Circuit

    t0 = time.time()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_mesh(1, tp=1)
        c = Circuit(set="STD128_OPT", seed=0, device="cuda", mesh=mesh)
        c.ReadFile(ADDER)
        c.setVerify(True)
        a, b, ins = adder_inputs()
        c.SetInput(ins)
        ts = time.time()
        warm = [torch.empty(1, device="cuda")]
        dist.all_gather(warm, torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()
        nccl_s = time.time() - ts
        reset_counts()
        ts = time.time()
        c.Clock()
        torch.cuda.synchronize()
        wall = time.time() - ts
        launches = check_only("mesh", read_counts(), "rot")
        walls = level_walls(c)
        want = OUTPUTS.get("circuit")
        same = want is None or all(np.array_equal(x, y) for x, y in zip(c.GetOutput(), want))
        if not np.array_equal(adder_sums(c), a + b) or not same or sum(c.bad_gate_counts.values()):
            fail(f"mesh: sums {adder_sums(c)} (want {a + b}), outputs equal circuit's {same}, "
                 f"repairs {c.bad_gate_counts}")
        mesh_out = [o.copy() for o in c.GetOutput()]
        c.setMesh(None)
        c.Reset()
        c.SetInput(ins)
        old_jit = os.environ.get("OECE_LEVEL_JIT")
        os.environ["OECE_LEVEL_JIT"] = "0"
        try:
            ts = time.time()
            c.Clock()
            torch.cuda.synchronize()
            host_wall = time.time() - ts
        finally:
            if old_jit is None:
                os.environ.pop("OECE_LEVEL_JIT")
            else:
                os.environ["OECE_LEVEL_JIT"] = old_jit
        if c._dev_branch or not all(np.array_equal(x, y) for x, y in zip(c.GetOutput(), mesh_out)):
            fail(f"mesh: the unsharded host-branch run differs from the mesh's (device branch {c._dev_branch})")
        host_walls = level_walls(c)
        c.setMesh(mesh)  # once more, warm, beside the unsharded run
        c.Reset()
        c.SetInput(ins)
        ts = time.time()
        c.Clock()
        torch.cuda.synchronize()
        warm_wall = time.time() - ts
        if not all(np.array_equal(x, y) for x, y in zip(c.GetOutput(), mesh_out)):
            fail("mesh: the second mesh run differs from the first")
        log("mesh", t0, f"one-rank NCCL mesh {mesh.shape}: adder_32bit verify T=4 sums == a+b, "
            f"outputs {'==' if want is not None else '(circuit not run)'} phase circuit's, no repair; "
            f"NCCL set-up {1e3 * nccl_s:.1f} ms; first wall {wall:.2f}s ({walls}); then without the "
            f"mesh on the host branch {host_wall:.2f}s ({host_walls}); then with the mesh "
            f"{warm_wall:.2f}s ({level_walls(c)}); circuit (device branch, first run) "
            f"{WALLS.get('circuit', float('nan')):.2f}s")
        del c
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


TP_ROWS = (1, 2, 4)  # key rows per rank: tp = 4, 2 and 1 at STD128_OPT (R = 4)
TP_BATCHES = (4, 64)
TP_WORLD, TP_LOOPS, TP_GATES = 2, 4, 64  # the gloo mesh's processes, circuit cases, gate batch
ADDER_2BIT = os.path.join(REPO, "examples", "simple_ckts", "adder_2bit", "adder_2bit.out")
TP_KERNELS = ("build_diagonals", "diag_matmul", "negacyclic_matmul", "cmux_epilogue")


def tp_keys():
    """STD128_OPT golden host keys of seed 0 on the card, through the key
    cache (the first call generates and writes them, later calls and the
    tp phase's processes read them): (sk, keys)."""
    from oece_tpu_torch.fhe import keycache
    from oece_tpu_torch.fhe.params import STD128_OPT, BinFHEMethod

    return keycache.load_or_generate(STD128_OPT, BinFHEMethod.GINX, 0, "cuda")


def tp_counts() -> dict:
    """The launches of the tp route's kernels (fhe/negacyclic.py), of the
    std step loop (csrc/rev_step.cu) and of every plain version."""
    from oece_tpu_torch.fhe import negacyclic as ng
    from oece_tpu_torch.fhe import std

    return {**{k: ng.LAUNCHES[k] for k in TP_KERNELS}, "std_steps": std.STEP_LAUNCHES,
            "plain": read_counts()["plain"]}


def tp_route_only(what: str, c: dict) -> None:
    """Raise unless the tp route's kernels, #5 and #6, launched, and neither
    #1 nor #3 (the route it does not take), the std step loop nor a plain
    version did."""
    if (not (c["negacyclic_matmul"] and c["cmux_epilogue"]) or c["build_diagonals"] or c["diag_matmul"]
            or c["std_steps"] or c["plain"]):
        raise RuntimeError(f"{what}: launches {c}: want the tp route's kernels only")


def _tp_circuit_inputs(nl, T: int):
    """T random cases of each input word of nl (bits, LSB first)."""
    rng = np.random.default_rng(1234)
    return [rng.integers(0, 2, (T, len(w))) for w in nl.inputs]


def _value(bits) -> np.ndarray:
    return (np.asarray(bits, np.uint64) << np.arange(bits.shape[1], dtype=np.uint64)).sum(1)


def _tp_rank(rank: int, port: int, circuit: str, out: str) -> None:
    """One of the TP_WORLD processes of the tp check, all on cuda:0 over
    gloo: the circuit (verify, T = TP_LOOPS) on a (1, TP_WORLD) mesh and
    unsharded, then a gate batch of TP_GATES on that mesh and on a
    (TP_WORLD, 1) mesh, the tp rotation's steps under the profiler, and the
    all-reduce alone; rank 0 writes what it measured to ``out`` as JSON.
    Raises on any disagreement."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.modules["jax"] = None
    sys.modules["oece_tpu"] = None
    from torch.profiler import ProfilerActivity, profile

    from oece_tpu_torch.fhe import boot, lwe, std
    from oece_tpu_torch.parallel import mesh as mesh_mod
    from oece_tpu_torch.runtime.evaluator import Circuit

    world, gates = TP_WORLD, TP_GATES
    t_start = time.time()
    stages = {}  # seconds from this process's start to the end of each stage
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["OECE_LEVEL_JIT"] = "0"  # a mesh runs the host branch: the unsharded run too
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        sk, keys = tp_keys()
        p = keys.params
        tp_mesh = mesh_mod.make_mesh(world, tp=world)
        dp_mesh = mesh_mod.make_mesh(world, tp=1)
        if tp_mesh.device != torch.device("cuda", 0):
            raise RuntimeError(f"rank {rank}: make_mesh chose {tp_mesh.device}, want cuda:0")
        shard = mesh_mod.shard_bootstrap_keys(keys, tp_mesh)
        stages["set-up"] = time.time() - t_start
        res = {"shape": tp_mesh.shape, "rows": shard.ginx_ext.shape[1], "walls": {}, "stages": stages}
        sync = torch.cuda.synchronize
        arenas = {}
        for name, m in (("sharded", tp_mesh), ("unsharded", None)):
            c = Circuit(set=p, seed=0, device="cuda", keys=keys, sk=sk, mesh=m)
            c.ReadFile(circuit)
            c.setVerify(True)
            ins = _tp_circuit_inputs(c.netlist, TP_LOOPS)
            c.SetInput(ins)
            sync()
            reset_counts()
            ts = time.time()
            c.Clock()
            sync()
            res["walls"][name] = time.time() - ts
            if m is not None:
                res["circuit_counts"] = tp_counts()
                tp_route_only(f"rank {rank}: {name} circuit", res["circuit_counts"])
            (outw,) = c.GetOutput()
            sums = (_value(ins[0]) + _value(ins[1])) % (np.uint64(1) << np.uint64(outw.shape[1]))
            if c._dev_branch or c.bad_gate_counts or not np.array_equal(_value(outw), sums):
                raise RuntimeError(f"rank {rank}: {name} circuit: sums {_value(outw)} (want {sums}), "
                                   f"repairs {c.bad_gate_counts}, device branch {c._dev_branch}")
            arenas[name] = c._ct_arena
            res["levels"], res["bootstraps"] = len(c.trace.records), c.trace.summary()["total_bootstraps"]
            stages[f"{name} circuit"] = time.time() - t_start
        if not torch.equal(arenas["sharded"], arenas["unsharded"]):
            raise RuntimeError(f"rank {rank}: the sharded circuit's ciphertexts differ from the unsharded one's")
        rng = np.random.default_rng(7)
        c1 = torch.from_numpy(lwe.encrypt_bits(sk, rng.integers(0, 2, gates), rng)).cuda()
        c2 = torch.from_numpy(lwe.encrypt_bits(sk, rng.integers(0, 2, gates), rng)).cuda()
        gids = torch.from_numpy(rng.integers(0, 6, gates).astype(np.int32)).cuda()
        want = boot.eval_bin_gate_batch(keys, gids, c1, c2)
        sync()
        reset_counts()
        ts = time.time()
        got = mesh_mod.eval_bin_gate_sharded(shard, gids, c1, c2, tp_mesh)
        sync()
        res["gate_s"] = time.time() - ts
        res["gate_counts"] = tp_counts()
        tp_route_only(f"rank {rank}: gate batch", res["gate_counts"])
        if not torch.equal(got, want):
            raise RuntimeError(f"rank {rank}: the (1, {world}) gate batch differs from the unsharded one")
        stages["tp gate batch"] = time.time() - t_start
        if not torch.equal(mesh_mod.eval_bin_gate_sharded(keys, gids, c1, c2, dp_mesh), want):
            raise RuntimeError(f"rank {rank}: the ({world}, 1) gate batch differs from the unsharded one")
        stages["dp gate batch"] = time.time() - t_start
        # the device's share of a step: 16 steps of the tp rotation at this
        # batch under the profiler (both ranks hold the same accumulator)
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        acc = torch.randint(0, p.Q, (gates, 2, p.N), generator=g, device="cuda", dtype=torch.int32)
        a2N = 2 * torch.randint(0, p.N, (gates, 16), generator=g, device="cuda", dtype=torch.int32)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            std.blind_rotate_std_tp(acc, shard.ginx_ext[:16], a2N, p, tp_mesh)
            sync()
        stages["profiled steps"] = time.time() - t_start
        dev = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            key = next((k for k in ("phase_expand", "raw_gemm", "std_cmux", "Memcpy") if k in ev.key),
                       "other")
            dev[key] = dev.get(key, 0.0) + us / 16
        res["device_us"] = dev
        stages["profile read"] = time.time() - t_start
        # the all-reduce alone: the step's raw sums at this batch and at 4
        # gates, as the card's tensors (staged by gloo) and as host ones;
        # the median of 10 calls (the loopback's times vary 2x)
        res["all_reduce_ms"] = {}
        for B in (gates, 4):
            for where in ("cuda", "cpu"):
                raw = torch.zeros((B, 16, p.N), dtype=torch.int32, device=where)
                dist.all_reduce(raw, group=tp_mesh.tp_group)
                times = []
                for _ in range(10):
                    sync()
                    ts = time.time()
                    dist.all_reduce(raw, group=tp_mesh.tp_group)
                    sync()
                    times.append(1e3 * (time.time() - ts))
                res["all_reduce_ms"][f"B={B} {where}"] = float(np.median(times))
        stages["all-reduce alone"] = time.time() - t_start
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def tp_mesh_run(phase: str, circuit: str) -> dict:
    """Spawn TP_WORLD gloo processes on cuda:0 (tcp://localhost, a free
    port) running _tp_rank on ``circuit``; returns rank 0's record.  The
    tp phase runs it on adder_2bit; adder_32bit's walls on the (1, 2) mesh
    (PERF.md §5) come from ``python3 -c 'import json, chip_smoke as s;
    s.phase_build(); print(json.dumps(s.tp_mesh_run("tp-adder32",
    s.ADDER)))'``."""
    import socket

    import torch.multiprocessing as mp

    tp_keys()  # generated once here, read by every process
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = os.path.join(REPO, "build", f"chip_smoke_{phase}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    ts = time.time()
    try:
        mp.spawn(_tp_rank, args=(port, circuit, out), nprocs=TP_WORLD, join=True)
    except Exception as e:  # a rank's exception, re-raised by spawn with its traceback
        fail(f"{phase}: a process of the gloo mesh failed: {e}")
    with open(out) as f:
        res = json.load(f)
    log(phase, ts, f"the {TP_WORLD} processes ran {time.time() - ts:.1f}s: rank 0's stages end at "
        + ", ".join(f"{k} {v:.1f}s" for k, v in res["stages"].items()))
    return res


def phase_tp():
    """Tensor parallelism on the card (std.blind_rotate_std_tp on host GINX
    keys, STD128_OPT seed 0): #1, #3, #5 against their plain twins at R =
    1, 2 and 4 key rows (B = 4, 8, 64) and #6 at B = 4 and 64; for tp = 2
    and 4 at B = 4 and 64 each rank's raw limb sums of one step through #5
    and through #1 then #3, summed over the ranks, == the unsharded step's
    raw sums, and after the combine and #6 == std.std_step_plain; device
    times of the two products per rank at R = 2 and 1 (B = 8, 64), beside
    their bounds; then two gloo processes on cuda:0: adder_2bit verify T=4
    through Circuit(mesh=...) on a (1, 2) mesh and unsharded (right sums,
    no repair, the same ciphertexts), a gate batch of 64 on that mesh (and
    on a (2, 1) one) == the unsharded batch, its step split into device
    time by kernel, the all-reduce and the rest; the route's kernels
    only."""
    import torch
    from oece_tpu_torch.fhe import negacyclic as ng
    from oece_tpu_torch.fhe import std
    from oece_tpu_torch.fhe.keys import rev_index
    from oece_tpu_torch.fhe.rot import amount_pairs, combine_planes, tile_digits

    t0 = time.time()
    _, keys = tp_keys()
    p = keys.params
    N, R, Q, nt, T = p.N, 2 * p.d_g_used, p.Q, p.N // 128, 128
    ext_all = keys.ginx_ext
    g = torch.Generator(device="cuda")
    g.manual_seed(1400)
    rand8 = lambda *shape: torch.randint(-128, 128, shape, generator=g, device="cuda", dtype=torch.int8)  # noqa: E731
    rand32 = lambda hi, *shape: torch.randint(0, hi, shape, generator=g, device="cuda", dtype=torch.int32)  # noqa: E731
    plain0 = dict(ng.PLAIN_LAUNCHES)
    err, digs = 0, {}
    for r in TP_ROWS:
        ext = ext_all[11, :r].contiguous()
        block = ng.build_diagonals(ext)
        err = max(err, _check_same("tp", f"#1 R={r}", block, ng.build_diagonals_plain(ext), t0))
        for B in (4, 8, 64):
            dig = digs[r, B] = rand8(B, nt * r * T)
            err = max(err, _check_same("tp", f"#3 R={r} B={B}", ng.diag_matmul(dig, block, r),
                                       ng.diag_matmul_plain(dig, block), t0))
            err = max(err, _check_same("tp", f"#5 R={r} B={B}", ng.negacyclic_matmul(dig, ext),
                                       ng.negacyclic_matmul_plain(dig, ext), t0))
    for B in TP_BATCHES:
        P, acc, amt = rand32(Q, B, 2, 2, N), rand32(Q, B, 2, N), rand32(2 * N, B, 2)
        err = max(err, _check_same("tp", f"#6 B={B}", ng.cmux_epilogue(P, acc, amt, Q),
                                   ng.cmux_epilogue_plain(P, acc, amt, Q), t0))
    idx = rev_index(N, "cuda")
    scale = 2 * N // p.q
    for tp in (2, 4):
        r = R // tp
        for B in TP_BATCHES:
            i = (100 + B + tp) % p.n
            acc, a_col = rand32(Q, B, 2, N), scale * rand32(p.q, B)
            dig = tile_digits(acc, p).view(B, nt, R, T)
            whole = ng.negacyclic_matmul_plain(dig.reshape(B, -1).contiguous(), ext_all[i])
            sums = {"#5": 0, "#1 then #3": 0}
            for t in range(tp):
                ext_t = ext_all[i, t * r:(t + 1) * r].contiguous()
                dig_t = dig[:, :, t * r:(t + 1) * r].contiguous().view(B, -1)
                sums["#5"] = sums["#5"] + ng.negacyclic_matmul(dig_t, ext_t)
                sums["#1 then #3"] = sums["#1 then #3"] + ng.diag_matmul(dig_t, ng.build_diagonals(ext_t), r)
            for route, got in sums.items():
                err = max(err, _check_same("tp", f"tp={tp} B={B} step {i}: ranks' raw sums by {route} "
                                           "== the unsharded step's", got, whole, t0))
            P = combine_planes(sums["#5"], Q).reshape(B, 2, 2, N).contiguous()
            err = max(err, _check_same(
                "tp", f"tp={tp} B={B} step {i}: combined, then #6 == std.std_step_plain",
                ng.cmux_epilogue(P, acc, amount_pairs(a_col, N), Q),
                std.std_step_plain(acc, a_col, ext_all[i], idx, p), t0))
    if ng.PLAIN_LAUNCHES != plain0:
        fail(f"tp: plain twins ran on the card: {ng.PLAIN_LAUNCHES} (before {plain0})")

    # device time per rank of the two products and of #6 at R = 2 and 1
    for r in (2, 1):
        ext = ext_all[11, :r].contiguous()
        block = ng.build_diagonals(ext)
        for B in (8, 64):
            dig = digs[r, B]
            ops = 2.0 * B * nt * (nt * r * T) * 16 * T
            raw = B * 16 * N * 4
            five = device_ms(lambda: ng.negacyclic_matmul(dig, ext), 20, "phase_expand_kernel", "raw_gemm_kernel")
            build, *three = device_ms(lambda: ng.diag_matmul(dig, ng.build_diagonals(ext), r), 20,
                                      "rev_build_kernel", "transpose_kernel", "raw_gemm_kernel")
            for name, parts, bnd in (
                ("#5", five, bound(ops, dig.numel() + ext.numel() + raw)),
                ("#1", [build], bound(0.0, ext.numel() + block.numel())),
                ("#3", three, bound(ops, dig.numel() + block.numel() + raw)),
            ):
                log("tp", t0, f"R={r} B={B} {name}: {1e3 * sum(parts):.1f} us on the device "
                    f"({' + '.join(f'{1e3 * x:.1f}' for x in parts)}), bound {1e3 * bnd[0]:.2f} us ({bnd[1]})")
            split = build + sum(three)
            log("tp", t0, f"R={r} B={B}: #1 then #3 {1e3 * split:.1f} us against #5 {1e3 * sum(five):.1f} us: "
                f"{'#5' if sum(five) < split else '#1 then #3'} is faster")
    for B in TP_BATCHES:
        P, acc, amt = rand32(Q, B, 2, 2, N), rand32(Q, B, 2, N), rand32(2 * N, B, 2)
        (ms,) = device_ms(lambda: ng.cmux_epilogue(P, acc, amt, Q), 20, "std_cmux_kernel")
        bnd = bound(0.0, P.numel() * 4 + 2 * acc.numel() * 4 + amt.numel() * 4)
        log("tp", t0, f"B={B} #6: {1e3 * ms:.1f} us on the device, bound {1e3 * bnd[0]:.2f} us ({bnd[1]})")
    torch.cuda.empty_cache()

    res = tp_mesh_run("tp", ADDER_2BIT)
    steps = p.n
    wall_us = 1e6 * res["gate_s"] / steps
    dev = res["device_us"]
    busy = sum(dev.values())
    ar = res["all_reduce_ms"]
    log("tp", t0, f"two gloo processes on cuda:0, mesh {res['shape']} ({res['rows']} key rows each): a "
        f"batch of 64 gates == unsharded, bit for bit; the (2, 1) mesh's too; launches {res['gate_counts']}")
    log("tp", t0, f"B=64 step split (rank 0): wall {wall_us:.1f} us per step (the gate batch); device "
        f"{busy:.1f} us (16 steps under the profiler: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in sorted(dev.items()))}); the all-reduce of "
        f"{64 * 16 * N * 4 / 2**20:.0f} MiB alone {1e3 * ar['B=64 cuda']:.1f} us; the rest "
        f"{wall_us - busy - 1e3 * ar['B=64 cuda']:.1f} us (host ops and gaps)")
    log("tp", t0, "the all-reduce alone, ms per call: " + ", ".join(f"{k} {v:.3f}" for k, v in ar.items()))
    w = res["walls"]
    log("tp", t0, f"adder_2bit verify T=4 ({res['levels']} levels, {res['bootstraps']} bootstraps): sums "
        f"right, no repair, ciphertexts == unsharded; wall on the (1, 2) mesh {w['sharded']:.2f}s, "
        f"unsharded {w['unsharded']:.2f}s (both on the host branch); launches {res['circuit_counts']}")
    return {k: res["gate_counts"][k] + res["circuit_counts"][k] for k in TP_KERNELS}


TPU_SIGMA = {"rev2": 14.46, "rev": 16.84}  # NOISE.md §3, the JAX package on the TPU
TPU_PREP_SIGMA = {"XOR": 40.71, "AND": 20.5}
NOISE_SEEDS = (1, 2, 3, 4)  # the sweep's other rev2 key draws
NOISE_KEYS = 1024  # device keygen seeds whose key-switch errors are averaged


def without_host_wait(fn):
    """fn with CUDA's sync debug mode at "error" while it runs: an
    operation that makes the host wait for the card raises."""
    import torch

    def wrapped(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    return wrapped


def clock_sync_warnings(c) -> list:
    """Clock ``c`` with the card's sync debug mode at "warn" until its
    output collection; returns, for each operation that made the host wait
    for the card, the innermost frames of the program's stack there."""
    import traceback
    import warnings

    import torch

    collect = c._collect_outputs
    stacks = []

    def unwatched():
        torch.cuda.set_sync_debug_mode("default")
        collect()

    def seen(message, *args, **kwargs):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if os.path.basename(f.filename) != "warnings.py"]
            stacks.append(f"{str(message)[:60]}: " + " <- ".join(
                f"{os.path.basename(f.filename)}:{f.lineno} {f.name}" for f in reversed(frames[-6:])))

    c._collect_outputs = unwatched
    torch.cuda.set_sync_debug_mode("warn")  # which itself warns on some versions
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            c.Clock()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del c._collect_outputs
    return stacks


def phase_level_edges():
    """GINX adder_32bit and mult_32x32 and AP adder_32bit at STD128, T=4,
    pure-encrypted with recovery off: no host wait between SetInput and
    collect but AP's live counts, right outputs, device level walls that
    add up to the Clock; prints edge_overlap_levels (phase 30)."""
    import torch
    from oece_tpu_torch.runtime.evaluator import Circuit

    t0 = time.time()
    keys, out = {}, {}
    for method, path in (("GINX", ADDER), ("GINX", MULT), ("AP", ADDER)):
        name = f"{method} {os.path.basename(path)[:-4]}"
        if method not in keys:
            kc = Circuit(set="STD128", method=method, seed=0, device="cuda")
            keys[method] = (kc.keys, kc.sk)
            log("level-edges", t0, f"{method} STD128 keygen {kc.keygen_s:.1f}s")
            del kc
        k, sk = keys[method]
        c = Circuit(set="STD128", method=method, device="cuda", keys=k, sk=sk,
                    rng=np.random.default_rng(5), generate_keys=False)
        c.ReadFile(path)
        c.setPlaintext(False)
        c.setEncrypted(True)
        c.setRecovery(False)
        rng = np.random.default_rng(99)
        words = [rng.integers(0, 2, (4, len(w))) for w in c.netlist.inputs]
        plain = Circuit(set="STD128", device="cuda", generate_keys=False)
        plain.ReadFile(path)
        plain.SetInput(words)
        plain.Clock()
        rotating = sum(1 for level in c.plan.levels if len(level["boot_op"]))
        c.SetInput(words)
        c.Clock()  # warm: the level index's upload, the allocator's blocks
        c.Reset()
        c.SetInput(words)
        syncs = clock_sync_warnings(c)
        want = rotating if method == "AP" else 0
        if len(syncs) != want:
            fail(f"level-edges {name}: {len(syncs)} synchronizing operations before collect, "
                 f"want {want}: {sorted(set(syncs))}")
        for got, ref in zip(c.GetOutput(), plain.GetOutput()):
            if not np.array_equal(got, ref):
                fail(f"level-edges {name}: {int((got != ref).sum())} output bits differ from "
                     f"the plaintext evaluation")
        levels_s, total_s = sum(r.wall_s for r in c.trace.records), c.trace.total_s
        if abs(levels_s - total_s) > 0.02 * total_s:
            fail(f"level-edges {name}: level walls sum to {levels_s:.4f}s, the Clock took "
                 f"{total_s:.4f}s on the host")
        walls = level_walls(c)
        c.setTrace(True)
        overlaps = []
        for _ in range(2):  # the first traced Clock also creates the spans' events
            c.Reset()
            c.SetInput(words)
            c.Clock()
            overlaps.append(c.trace.counters.get("edge_overlap_levels", 0))
        tr = c.trace
        edges = overlaps[-1]
        waits = sum(s.attrs.get("host_waits", 0) for s in tr.spans if s.name == "level")
        rots = [s for s in tr.spans if s.name == "boot.rotation"]
        rot_host = 1e3 * float(np.median([s.seconds for s in rots]))
        rot_dev = float(np.median([s.device_ms for s in rots]))
        out[name] = dict(total_s=total_s, levels_s=levels_s,
                         edge_overlap_levels=edges, rotating_levels=rotating,
                         level_host_waits=waits, rotation_host_ms=rot_host,
                         rotation_device_ms=rot_dev)
        log("level-edges", t0, f"{name}: {len(syncs)} sync warnings before collect (want "
            f"{want}), outputs == plaintext; Clock {total_s:.4f}s on the host, "
            f"level walls {levels_s:.4f}s ({100 * levels_s / total_s:.2f}%), {walls}; traced: "
            f"edge_overlap_levels {edges} of {rotating} rotating levels "
            f"({edges / rotating:.3f}; {overlaps[0]} in the first traced Clock), host waits in "
            f"levels {waits}; a rotation's median "
            f"{rot_host:.3f} ms on the host, {rot_dev:.3f} ms on the card")
        del c, plain
        torch.cuda.empty_cache()
    return out


def phase_noise():
    """The port's noise tools at STD128_OPT through their functions: 20
    chained batches of 1024 mixed gates on rev2 and rev device keys and on
    golden host keys (measure_noise.run), 10 such batches on the rev2 keys
    of each of NOISE_SEEDS (the noise mean across key draws), and 10
    chained batches of 2048 per gate type on rev2 (measure_xor_noise.run);
    every chunk runs with the card's sync debug mode at "error", so a host
    wait between two progress lines fails, as does any failure (|e| >=
    q/8).  Logs sigma, max |e| and margin/sigma beside NOISE.md's TPU
    sigma, each key's mean beside key_switch_mean's prediction, and the
    mean of device keygen's key-switch errors over NOISE_KEYS seeds."""
    import torch
    from oece_tpu_torch.tools import measure_noise as mn
    from oece_tpu_torch.tools import measure_xor_noise as mx

    t0 = time.time()
    say = lambda msg: log("noise", t0, msg)  # noqa: E731
    chunks = mn.noise_chunk, mx.xor_chunk
    mn.noise_chunk, mx.xor_chunk = map(without_host_wait, chunks)
    try:
        out, x = noise_runs(mn, mx, say)
    finally:
        mn.noise_chunk, mx.xor_chunk = chunks
    bad = {k: r["failures"] for k, r in out.items() if r["failures"]}
    bad.update({k: r["failures"] for k, r in x["per_gate"].items() if r["failures"]})
    if bad:
        fail(f"noise: failures (|e| >= q/8) {bad}")
    return {"noise": out, "xor": x}


def key_switch_mean(sk, keys) -> tuple[float, float]:
    """The output-noise mean that a key's key-switch key sets, in q units,
    and the mean of its errors: -sum_k E[d_k] * sum_j e_jk * q / Q_ks,
    with e_jk = b - <a, s> - z_j B_ks^k of row (j, k) (z_j read off row k =
    d_ks - 2, where |e| << B_ks^k) and E[d_k] the mean of digit k of
    boot.signed_digits_dev over [0, Q_ks) (-1/2 below the top digit), as
    the key switch subtracts sum d_jk * ksk_jk."""
    import torch
    from oece_tpu_torch.fhe import boot

    p = keys.params
    Qks, N, n, d = p.Q_ks, p.N, p.n, p.d_ks
    limbs = keys.ksk.to(torch.int64)
    ksk = (limbs[..., 0] + 256 * limbs[..., 1]) % Qks
    s = torch.as_tensor(np.asarray(sk.s), dtype=torch.int64, device=ksk.device)
    centre = lambda x: (x + Qks // 2) % Qks - Qks // 2  # noqa: E731
    v = centre(ksk[:, n] - (ksk[:, :n] * s).sum(1)).reshape(N, d)
    g = torch.tensor([p.B_ks ** k for k in range(d)], device=ksk.device)
    z = torch.round(v[:, d - 2].double() / g[d - 2]).long()
    e = centre(v - z[:, None] * g[None, :])
    digit_means = boot.signed_digits_dev(torch.arange(Qks, device=ksk.device), p.B_ks, d).double().mean(0)
    return float(-(digit_means * e.double().sum(0)).sum() * p.q / Qks), float(e.double().mean())


def noise_runs(mn, mx, say):
    """phase_noise's runs of the two tools: ({form: summary}, the XOR
    tool's summary).  Beside each form's mean, the mean its key-switch key
    predicts (key_switch_mean, keys made again from the same seed)."""
    import torch
    from oece_tpu_torch.fhe import devkeygen
    from oece_tpu_torch.fhe.params import STD128_OPT

    def predicted(layout, seed=0):
        ks, e_mean = key_switch_mean(*mn.make_keys(STD128_OPT, layout, "cuda", seed))
        torch.cuda.empty_cache()
        return f"the key-switch key predicts {ks:.2f} (its errors' mean {e_mean:.4f})"

    out = {}
    for layout in ("rev2", "rev", "host"):
        r = out[layout] = mn.run("STD128_OPT", 20, 1024, layout, "cuda", log=say)
        torch.cuda.empty_cache()
        tpu = TPU_SIGMA.get(layout)
        say(f"{layout}: {r['bootstraps']} bootstraps, {r['failures']} failures, sigma {r['noise_std']:.2f} "
            f"(mean {r['noise_mean']:.2f}; {predicted(layout)}), max |e| {r['noise_max_abs']}, margin q/8 = "
            f"{r['margin_sigmas']:.1f} sigma, {r['boots_per_sec']:.0f} bootstraps/s"
            + (f"; the TPU's sigma (NOISE.md) {tpu}" if tpu else ""))
    for seed in NOISE_SEEDS:
        r = out[f"rev2 seed {seed}"] = mn.run("STD128_OPT", 10, 1024, "rev2", "cuda", seed=seed, log=lambda m: None)
        torch.cuda.empty_cache()
        say(f"rev2 keys of seed {seed}: {r['bootstraps']} bootstraps, {r['failures']} failures, mean "
            f"{r['noise_mean']:.2f} ({predicted('rev2', seed)}), sigma {r['noise_std']:.2f}, max |e| "
            f"{r['noise_max_abs']}")
    means = [out["rev2"]["noise_mean"]] + [out[f"rev2 seed {k}"]["noise_mean"] for k in NOISE_SEEDS]
    say(f"rev2 noise mean over key seeds 0-{NOISE_SEEDS[-1]}: {', '.join(f'{m:.2f}' for m in means)}; "
        f"their standard deviation {np.std(means, ddof=1):.2f}")
    # the key-switch errors of device keygen on the card over NOISE_KEYS
    # seeds, and one long draw of its sampler: a bias in it would shift
    # every key's noise mean alike
    e_means = []
    for seed in range(NOISE_KEYS):
        words = np.zeros(8, np.uint32)
        words[0] = seed
        eks = devkeygen.sample(STD128_OPT, devkeygen.seed_generators(words, "cuda"))[-1]
        e_means.append(float(eks.double().mean()))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1401)
    draw = torch.cat([torch.round(STD128_OPT.sigma * torch.randn(2**26, generator=gen, device="cuda"))
                      for _ in range(4)])
    say(f"device keygen's key-switch errors, seeds 0-{NOISE_KEYS - 1}: mean {np.mean(e_means):.5f} "
        f"(standard error {np.std(e_means, ddof=1) / np.sqrt(NOISE_KEYS):.5f}), "
        f"{sum(m < 0 for m in e_means)} of {NOISE_KEYS} keys' means negative; the sampler's "
        f"round(sigma * randn) over 2^28 draws: mean {float(draw.double().mean()):.6f} (standard error "
        f"{float(draw.double().std()) / 2**14:.6f})")
    x = mx.run("STD128_OPT", 10, 2048, "rev2", "cuda", log=say)
    for name, r in x["per_gate"].items():
        tpu = TPU_PREP_SIGMA.get(name)
        say(f"xor-noise {name}: {r['bootstraps']} bootstraps, {r['failures']} failures, out sigma "
            f"{r['out_noise_std']}, prep sigma {r['prep_err_std']} (max {r['prep_err_max_abs']}, margin "
            f"{r['prep_margin_q']} = {r['prep_margin_sigmas']} sigma)"
            + (f"; the TPU's prep sigma (NOISE.md) {tpu}" if tpu else ""))
    torch.cuda.empty_cache()
    return out, x


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
    "gemm-tiles": phase_gemm_tiles,
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
    "tp": phase_tp,
    "noise": phase_noise,
    "tb": phase_tb,
    "recover-circuit": phase_recover_circuit,
    "compound-circuit": phase_compound_circuit,
    "dff": phase_dff,
    "ap-generic": phase_ap_generic,
    "checkpoint": phase_checkpoint,
    "bad-trace": phase_bad_trace,
    "ntt": phase_ntt,
    "native": phase_native,
    "mesh": phase_mesh,
    "level-edges": phase_level_edges,
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
    res = RESULTS
    for name in sys.argv[1:] or PHASES:
        res[name] = PHASES[name]()
    print(f"total {time.time() - t_all:.1f}s", flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if sys.argv[1:]:
        print(json.dumps({"ok": True, "device": device, "phases": sys.argv[1:]}), flush=True)
        return

    std_res, rev_res = res["std-kernel"], res["rev-kernel"]
    neg_res = res["neg-kernel"]
    # the step profiler's launches and the tp route's (two gloo ranks, rank 0's)
    neg_launches = {k: v + res["tp"].get(k, 0) for k, v in res["profile-boot"].items()}
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
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
