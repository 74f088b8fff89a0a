"""Time adder_32bit in verify mode, T=4, at STD128_OPT (seed 0) on the card,
per key layout and per check branch: one warm-up Clock(), then ``--reps``
timed ones (host clock around Clock() and a synchronize), and the
per-level wall of each timed Clock's trace.  One JSON line per (layout,
branch).

    python oece_tpu_torch/tools/circuit_walls.py [--root TREE] [--reps 5]
        [--layouts rev2,rev] [--branches host,device]

``--root`` imports ``oece_tpu_torch`` from another tree (a parent commit
unpacked with ``git archive``), to compare trees in turns in one call; a
tree whose Circuit has one check branch ignores ``OECE_LEVEL_JIT`` and
reports the branch as "only"."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--layouts", default="rev2,rev")
    ap.add_argument("--branches", default="host,device")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from oece_tpu_torch.runtime import evaluator

    adder = os.path.join(HERE, "examples", "old_bristol_ckts", "arith", "adder_32bit.txt")
    rng = np.random.default_rng(1234)
    a = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    bits = [((v[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)).astype(np.int64) for v in (a, b)]
    two = hasattr(evaluator.Circuit, "_use_level_jit")
    branches = args.branches.split(",") if two else ["only"]
    for layout in args.layouts.split(","):
        os.environ["OECE_LAYOUT"] = layout
        c = evaluator.Circuit(set="STD128_OPT", seed=0, device="cuda")
        c.ReadFile(adder)
        for branch in branches:
            if two:
                os.environ["OECE_LEVEL_JIT"] = "1" if branch == "device" else "0"
            walls, levels = [], []
            for rep in range(args.reps + 1):
                c.Reset()
                c.setVerify(True)
                c.SetInput(bits)
                t0 = time.time()
                c.Clock()
                torch.cuda.synchronize()
                wall = time.time() - t0
                (out,) = c.GetOutput()
                sums = (out.astype(np.uint64) << np.arange(out.shape[1], dtype=np.uint64)).sum(1)
                if not np.array_equal(sums, a + b) or sum(c.bad_gate_counts.values()):
                    raise SystemExit(f"{layout} {branch}: sums {sums}, repairs {c.bad_gate_counts}")
                if rep:
                    walls.append(wall)
                    levels.append(statistics.median(r.wall_s for r in c.trace.records))
            print(json.dumps({
                "tree": os.path.abspath(args.root), "layout": layout, "branch": branch,
                "walls_s": walls, "median_wall_s": statistics.median(walls),
                "level_median_ms": [1e3 * v for v in levels],
                "device": torch.cuda.get_device_name(0),
            }), flush=True)
        os.environ.pop("OECE_LEVEL_JIT", None)
        del c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
