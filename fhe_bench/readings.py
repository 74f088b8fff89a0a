"""The readings that the limit of ``correct`` is set from, many seeds in
one process: the program as configured, or with --control k the program's
own lower-precision path, its approximate gadget at k digits of base B_g
(d_g_eff = k: the rotation's digits keep only the top 7k bits of each
accumulator coefficient, and its GEMMs do k/d of the exact gadget's work).
The control of the cells is k = 1.

    python3 fhe_bench/readings.py --workload <cell> --seconds <s> [--control <k>] --seeds <n> ...

Each seed is a whole run of the cell (keys, set-up, window, reference) on
the card; one JSON line per seed gives the numbers compared.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fhe_bench import keydraw  # noqa: E402
from fhe_bench import run as bench_run  # noqa: E402


CONTROL_DIGITS = 1


def lowered(cfg: dict, digits: int = CONTROL_DIGITS) -> dict:
    """The configuration with the approximate gadget at ``digits`` digits,
    fewer than it uses."""
    low = copy.deepcopy(cfg)
    if not 0 < digits < keydraw.gadget_digits(low["params"]):
        raise ValueError(f"the control keeps 1 to {keydraw.gadget_digits(low['params']) - 1} digits")
    low["params"]["d_g_eff"] = digits
    return low


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, metavar="DIGITS")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    _, cfg, traffic = bench_run.load_cell(args.workload)
    if args.control:
        cfg = lowered(cfg, args.control)
    for seed in args.seeds:
        t = time.time()
        try:
            run = bench_run.run_cell(cfg, traffic, seed, args.seconds, False, t_start=t)
            line = {k: run[k] for k in ("wrong_bits", "output_bits", "max_error", "failed", "attempted")}
        except Exception as exc:  # a control that crashes gives no reading
            line = {"error": f"{type(exc).__name__}: {exc}"}
        line.update(workload=args.workload, seed=seed, control=args.control,
                    d_g_eff=cfg["params"]["d_g_eff"], seconds=round(time.time() - t, 3))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
