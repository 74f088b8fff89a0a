"""Record an encrypted circuit run through the TB harness flow: plaintext
pass, then encrypted pass with per-level verify (or pure-encrypted with
recovery), on the port's Circuit; the counterpart of the JAX package's
tools/run_circuit_std128.py, with its cases, flags and JSON document.

Keys come from ``devkeygen.device_keygen`` with seed 0 (eight zero seed
words) in the layout of ``OECE_LAYOUT`` (default "rev2"), or
``device_keygen_ap`` for ``--method AP``, made once and reused across the
``--repeat`` runs.  The document (the encrypted pass's per-level trace,
the harness counts and the run's provenance) goes to ``--out``, by default
build/run_circuit/<circuit>_<set>[_T<loops>][_pure].json.

    python -m oece_tpu_torch.tools.run_circuit [bench] [--set STD128_OPT]
        [--method GINX] [--loops 4] [--no-verify] [--xor-mode native]
        [--repeat 1] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("bench", nargs="?", default="sha256")
    ap.add_argument("--set", default="STD128_OPT")
    ap.add_argument("--method", default="GINX")
    ap.add_argument("--loops", type=int, default=4)
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--xor-mode", default="native", choices=["native", "compound"])
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the harness N times on one Circuit and record the last run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="the JSON document's path")
    args = ap.parse_args(argv)

    from ..fhe import boot, devkeygen
    from ..fhe.params import BinFHEMethod, get_params
    from ..harness import testlib as tl
    from ..runtime.evaluator import Circuit

    R = tl.DEFAULT_CIRCUITS_DIR
    CASES = {
        "sha256": (f"{R}/new_bristol_ckts/crypto/sha256.txt", tl.test_sha256),
        "md5": (f"{R}/old_bristol_ckts/crypto/md5.txt", tl.test_md5),
        "sha1": (f"{R}/old_bristol_ckts/crypto/sha-1.txt", tl.test_sha1),
        "aes_128": (f"{R}/new_bristol_ckts/crypto/aes_128.txt", tl.test_aes_new),
        "aes": (f"{R}/old_bristol_ckts/crypto/AES-expanded.txt", tl.test_aes),
        "adder_32bit": (f"{R}/old_bristol_ckts/arith/adder_32bit.txt", tl.test_adder),
        "mult_32x32": (f"{R}/old_bristol_ckts/arith/mult_32x32.txt", tl.test_multiplier),
        "des": (f"{R}/old_bristol_ckts/crypto/DES-expanded.txt", tl.test_des),
    }

    params = get_params(args.set)
    method = BinFHEMethod[args.method.upper()]
    layout = os.environ.get("OECE_LAYOUT", "rev2")
    t0 = time.time()
    words = np.zeros(8, np.uint32)  # seed 0
    if method == BinFHEMethod.AP:
        sk, keys = devkeygen.device_keygen_ap(params, words, args.device)
    else:
        sk, keys = devkeygen.device_keygen(params, words, args.device, layout=layout)
    c = Circuit(set=args.set, method=method, seed=0, device=args.device, keys=keys, sk=sk,
                xor_mode=args.xor_mode, verbose=True)
    print(f"# keys ready in {time.time() - t0:.1f}s", file=sys.stderr)

    fname, test_fn = CASES[args.bench]
    print(f"# running {fname}", file=sys.stderr)
    t_start = time.time()
    for rep in range(args.repeat):
        r = test_fn(fname, num_loops=args.loops, circuit=c, set=args.set, method=args.method,
                    verify=not args.no_verify, verbose=True, device=args.device)
        print(f"# rep {rep + 1}/{args.repeat}: " + r.summary(), file=sys.stderr)
    print("# " + r.summary(), file=sys.stderr)
    tr = c.trace  # the encrypted pass's trace (the last Clock on this circuit)
    widths = [rec.boot_gates for rec in tr.records]
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                             capture_output=True, text=True, timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        rev = "unknown"
    doc = {
        "bench": args.bench,
        "circuit_file": fname,
        "set": args.set,
        "method": args.method,
        "xor_mode": args.xor_mode,
        "loops": args.loops,
        "verify": not args.no_verify,
        "provenance": {
            "git_rev": rev,
            "layout": layout,
            "rot_mega": boot.ROT_MEGA,
            "repeat": args.repeat,
            "compile_cache": False,  # the port compiles no programs at run time
            "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
        },
        "harness": {
            "n_cases": r.n_cases,
            "plain_passed": r.plain_passed,
            "enc_passed": r.enc_passed,
            "bad_gates_fixed": r.bad_gates_fixed,
            "bad_gate_levels": {str(lv): d for lv, d in sorted(c.bad_gate_levels.items())},
            "bad_gate_lanes": [],  # OECE_BAD_TRACE is not ported
            "recover_counts": dict(c.recover_counts),
            "max_phase_err": c.max_phase_err,
            "wall_s": round(r.seconds, 2),
        },
        "encrypted_trace": {
            "summary": tr.summary(),
            "level_width_stats": {
                "levels": len(widths),
                "mean_boot_gates": round(float(np.mean(widths)), 2) if widths else 0,
                "max_boot_gates": int(np.max(widths)) if widths else 0,
                "pct_levels_lt_32_gates": round(
                    100.0 * float(np.mean(np.array(widths) * args.loops < 32)), 1
                ) if widths else 0,
            },
            "levels": [
                {"level": rec.level, "boot_gates": rec.boot_gates, "batch": rec.batch,
                 "wall_s": round(rec.wall_s, 5), "bootstraps": rec.bootstraps}
                for rec in tr.records
            ],
        },
    }
    path = args.out
    if path is None:
        base = os.path.basename(fname).rsplit(".", 1)[0]
        suffix = ("" if args.loops == 4 else f"_T{args.loops}") + ("_pure" if args.no_verify else "")
        path = os.path.join(REPO, "build", "run_circuit", f"{base}_{args.set.lower()}{suffix}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"# total {time.time() - t_start:.1f}s; written {path}")
    print(json.dumps({
        "bench": args.bench,
        "enc_passed": f'{r.enc_passed}/{r.n_cases}',
        "encrypted_wall_s": tr.summary()["total_s"],
        "boots_per_sec": tr.summary()["bootstraps_per_sec"],
        "bad_gates_fixed": r.bad_gates_fixed,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
