"""Step profiler of the standard-form GINX rotation and its kernels.

    python -m oece_tpu_torch.tools.profile_boot [B] [--steps n] [--set NAME]
                                                [--device cuda|cpu]

The counterpart of the JAX package's tools/profile_boot.py.  It makes
golden's host keys for the set (default STD128_OPT; seed 0, as the JAX
tool's key cache does) with fhe/hostkeygen.py, packed as ginx_ext, and a
random accumulator acc0 [B, 2, N] (default B = 1024) and rotation amounts
a2N [B, n] from ``np.random.default_rng(0)``, the JAX tool's numbers.  Each
scan below runs over the first n key steps (all of them unless --steps),
each step's result feeding the next (its carry), and prints one
``name  ms  us/step`` line:

  A  the full CMUX step (boot._external_cmux_pallas): digits, #1 build,
     #2 matmul with the limb combine, #6 epilogue
  B  digits, #1 and #2, carry red31(carry + P[:, 0])
  C  the two rotations, the add and red31 alone (torch ops)
  D  #1 and #2 on fixed digits, their sign chained on a scalar carry
  E  D's work as #1 and two half-batch #2 launches
  F  #1 alone
  G  #1 and #3: the raw limb sums, no combine (negacyclic_matmul_split)
  H  #5: the raw limb sums with no block built (negacyclic_matmul)
  I  #7 alone: the block in the conjugated basis (build_rev_conj)

The JAX scans B, D and E call negacyclic_matmul_combine (#1 and #4).  In
true column order #4, #2 and #8 are one function and one CUDA kernel, so
those scans run the window pipeline (#1 and #2), and E's "no perm" has no
permutation to leave out.  H and I have no JAX scan: they run the two
kernels of fhe/negacyclic.py that no JAX scan reaches.

Times: CUDA events around REPS = 2 runs of a scan after one warm-up run,
as the JAX tool times (on the CPU, the host clock).  The tool runs on the
card unless ``--device cpu``; it does not fall back.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..fhe import golden, hostkeygen, negacyclic, rot
from ..fhe.modmath import red31
from ..fhe.params import BinFHEMethod, BinFHEParams, get_params

REPS = 2
SCANS = {
    "A": "A: full cmux step scan",
    "B": "B: digits+matmul+combine",
    "C": "C: rotations+add+red",
    "D": "D: matmul_combine only",
    "E": "E: build+2 half matmuls",
    "F": "F: diag build only",
    "G": "G: matmul plain (split, no comb)",
    "H": "H: on-the-fly matmul (no block)",
    "I": "I: conjugated build only",
}


@dataclasses.dataclass
class Inputs:
    p: BinFHEParams
    ext: torch.Tensor  # ginx_ext int8 [n, R, 16, 2N], the first n steps
    acc0: torch.Tensor  # int32 [B, 2, N] in [0, Q)
    a2N: torch.Tensor  # int32 [B, n] in [0, 2N)
    aT: torch.Tensor  # a2N.T, contiguous [n, B]
    digs0: torch.Tensor  # int8 [B, nt*R*T]: tile_digits(acc0)


def make_inputs(p: BinFHEParams, B: int, steps: int, device, seed: int = 0) -> Inputs:
    """Golden host keys for p from ``seed`` (its first ``steps`` steps) and
    the JAX tool's accumulator and amounts, on ``device``."""
    rng = np.random.default_rng(seed)
    sk = golden.lwe_keygen(p, rng)
    ext = hostkeygen.bootstrap_keygen(p, sk, rng, BinFHEMethod.GINX, device).ginx_ext[:steps]
    rng = np.random.default_rng(seed)
    acc0 = torch.from_numpy(rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)).to(device)
    a2N = rng.integers(0, 2 * p.N, (B, p.n)).astype(np.int32)[:, :steps]
    a2N = torch.from_numpy(np.ascontiguousarray(a2N)).to(device)
    return Inputs(p=p, ext=ext.contiguous(), acc0=acc0, a2N=a2N, aT=a2N.t().contiguous(),
                  digs0=rot.tile_digits(acc0, p))


def cmux_step(acc: torch.Tensor, a_col: torch.Tensor, ext_i: torch.Tensor, p: BinFHEParams) -> torch.Tensor:
    """One GINX step in the standard form (boot._external_cmux_pallas):
    digits, #1 and #2, then #6 with the amounts (2N - a, a)."""
    B, _, N = acc.shape
    P4 = negacyclic.negacyclic_matmul_window(rot.tile_digits(acc, p), ext_i, p.Q)
    return negacyclic.cmux_epilogue(P4.view(B, 2, 2, N), acc, rot.amount_pairs(a_col, N), p.Q)


def _first(x: torch.Tensor) -> torch.Tensor:
    """out[0, 0, :1].sum() as int64: the scalar that chains a scan."""
    return x[0, 0, :1].to(torch.int64).sum()


def scan(name: str, inp: Inputs) -> torch.Tensor:
    """Scan ``name`` over every step of inp; returns its final carry."""
    p, n = inp.p, inp.ext.shape[0]
    B, _, N = inp.acc0.shape
    R, Q = inp.ext.shape[1], p.Q
    if name in "AB":
        carry = inp.acc0
        for i in range(n):
            if name == "A":
                carry = cmux_step(carry, inp.aT[i], inp.ext[i], p)
            else:
                P4 = negacyclic.negacyclic_matmul_window(rot.tile_digits(carry, p), inp.ext[i], Q)
                carry = red31(carry + P4.view(B, 2, 2, N)[:, 0], Q)
        return carry
    if name == "C":
        carry, P0 = inp.acc0, inp.acc0  # the JAX scan's P = [acc0, acc0]
        for i in range(n):
            a = inp.aT[i]
            rot_pos = rot.monomial_rotate(P0, (2 * N - a) & (2 * N - 1), N, Q)
            rot_neg = rot.monomial_rotate(carry, a, N, Q)
            carry = red31(carry + rot_pos + rot_neg + (2 * Q - P0 - P0), Q)
        return carry
    carry = torch.zeros((), dtype=torch.int64, device=inp.acc0.device)
    neg0 = -inp.digs0
    h = B // 2
    for i in range(n):
        ext_i = inp.ext[i]
        if name in "FI":
            build = negacyclic.build_diagonals if name == "F" else negacyclic.build_rev_conj
            carry = carry + build(ext_i)[0, :1].to(torch.int64).sum()
            continue
        d = torch.where(carry < 0, neg0, inp.digs0)
        if name == "D":
            s = _first(negacyclic.negacyclic_matmul_window(d, ext_i, Q))
        elif name == "E":
            block = negacyclic.build_diagonals(ext_i)
            s = (_first(negacyclic.window_matmul(d[:h], block, R, Q))
                 + _first(negacyclic.window_matmul(d[h:], block, R, Q)))
        elif name == "G":
            s = _first(negacyclic.negacyclic_matmul_split(d, ext_i))
        else:  # H
            s = _first(negacyclic.negacyclic_matmul(d, ext_i))
        carry = torch.clamp_max(carry + s, 0)
    return carry


def time_scan(name: str, inp: Inputs) -> tuple[float, torch.Tensor]:
    """(ms per run of the scan after one warm-up run, the last carry)."""
    out = scan(name, inp)
    if inp.acc0.is_cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            out = scan(name, inp)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS, out
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = scan(name, inp)
    return 1e3 * (time.perf_counter() - t0) / REPS, out


def run(inp: Inputs, log=print) -> dict:
    """Time each scan; logs one line per scan and returns {name: (ms, the
    final carry of its last run)}."""
    n = inp.ext.shape[0]
    res = {}
    for name in SCANS:
        ms, out = time_scan(name, inp)
        log(f"{SCANS[name]:36s} {ms:8.1f} ms  {1e3 * ms / n:8.1f} us/step")
        res[name] = (ms, out)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m oece_tpu_torch.tools.profile_boot",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=1024, help="gates per batch (>= 2)")
    ap.add_argument("--steps", type=int, default=0, help="key steps per scan (default: all n)")
    ap.add_argument("--set", default="STD128_OPT", help="parameter set")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    p = get_params(args.set)
    steps = args.steps or p.n
    if args.B < 2 or not 1 <= steps <= p.n:
        ap.error(f"need B >= 2 and 1 <= steps <= {p.n}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_boot: no CUDA device (pass --device cpu to run on the CPU)")
    kind = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"{p.name} B={args.B} steps={steps} on {kind}", flush=True)
    inp = make_inputs(p, args.B, steps, args.device)
    return run(inp, log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
