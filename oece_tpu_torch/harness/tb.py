"""TB_* command-line test benches (reference src/TB_*.cpp parity).

Each entry point mirrors its reference executable: optional analyze (-z) /
assemble (-a) steps, then the golden-model harness over its circuit list
with the selected parameter set and method.  Run via::

    python -m oece_tpu_torch.harness.tb <bench> [-s TOY] [-m GINX] [-n 4] [...]
        [--device cuda|cpu]

where <bench> is one of the keys of BENCHES, or all.  The port's
counterpart of ``oece_tpu.harness.tb``, on the port's testlib: the same
flags and lines, plus ``--device`` (default "cuda"; without CUDA it raises,
as ``Circuit(device="cuda")`` does).  As in the JAX package, ``--xor-mode``
is parsed and not passed on.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

from ..circuits.analyze import analyze, assemble
from ..utils.cli import Options, parse_inputs
from . import testlib as tl

R = tl.DEFAULT_CIRCUITS_DIR


@dataclasses.dataclass
class TBOptions(Options):
    """The reference's flags (utils/cli.py) and the device the benches run on."""

    device: str = "cuda"


def _prep(fname: str, opt: Options) -> str:
    """Reference flow: -z analyze, -a assemble to *_FHE.out then use it
    (TB_comparators.cpp:126-145 pattern)."""
    if opt.analyze:
        a = analyze(fname, gen_fan=opt.fanout)
        print(a.report())
        if opt.assemble:
            out = os.path.join(
                tempfile.gettempdir(), os.path.basename(fname).rsplit(".", 1)[0] + "_FHE.out"
            )
            assemble(a, out, debug=opt.verbose)
            return out
    return fname


def _run(results, fn, fname, opt: TBOptions, n=None, **kw):
    try:
        fname = _prep(fname, opt)
        r = fn(
            fname,
            n or opt.num_test_loops,
            set=opt.set,
            method=opt.method,
            encrypted=not opt.plaintext_only,
            verify=not opt.recover,
            recover=opt.recover,
            seed=opt.seed,
            verbose=opt.verbose,
            device=opt.device,
            **kw,
        )
    except FileNotFoundError as e:
        # insureFileExists parity (utils.h:57-66): point the user at the fix
        # instead of a bare traceback.
        print(
            f"[ERROR] The file {e.filename or fname} doesn't exist, and is "
            "required!\n\t*** To correct this, regenerate the corpus "
            "(python tools/gen_corpus.py) or point $OECE_CIRCUITS at a "
            "corpus tree; Bristol sources also accept -z/-a ***"
        )
        results.append(tl.HarnessResult(
            name=f"missing[{os.path.basename(fname)}]", n_cases=1,
            plain_passed=0, enc_passed=0, enc_run=False,
            bad_gates_fixed=0, seconds=0.0))
        return
    print(("PASS " if r.passed else "FAIL ") + r.summary())
    results.append(r)


def _cases(opt: Options, files):
    """Reference ``-c`` semantics (TB_adders.cpp:76-93 etc.): when given,
    run only the first n_cases circuit files of the bench."""
    files = list(files)
    if opt.n_cases > 0:
        if len(files) == 1 and opt.n_cases != 1:
            print("Note n_cases is ignored for this Test Bench")
            return files
        return files[: opt.n_cases]
    return files


def tb_adder_2bit(opt):
    out = []
    _run(out, tl.test_adder, f"{R}/simple_ckts/adder_2bit/adder_2bit.out", opt)
    return out


def tb_parity(opt):
    out = []
    _run(out, tl.test_parity, f"{R}/simple_ckts/parity/parity.out", opt)
    return out


def tb_adders(opt):
    out = []
    for f in _cases(opt, ("adder_32bit.txt", "adder_64bit.txt")):
        _run(out, tl.test_adder, f"{R}/old_bristol_ckts/arith/{f}", opt)
    return out


def tb_comparators(opt):
    out = []
    for f in _cases(opt, (
        "comparator_32bit_signed_lt.txt",
        "comparator_32bit_signed_lteq.txt",
        "comparator_32bit_unsigned_lt.txt",
        "comparator_32bit_unsigned_lteq.txt",
    )):
        _run(out, tl.test_comparator, f"{R}/old_bristol_ckts/arith/{f}", opt)
    return out


def tb_multipliers(opt):
    out = []
    _run(out, tl.test_multiplier, f"{R}/old_bristol_ckts/arith/mult_32x32.txt", opt)
    return out


def tb_arith64(opt):
    """New-Bristol 64-bit arith suite (corpus-only in the reference —
    examples/new_bristol_ckts/arith/, SURVEY.md §2.9 — given a real TB here)."""
    out = []
    for f in _cases(opt, (
        "adder64.txt",
        "sub64.txt",
        "neg64.txt",
        "zero_equal.txt",
        "mult64.txt",
        "mult2_64.txt",
        "udivide64.txt",
        "divide64.txt",
    )):
        _run(out, tl.test_arith64, f"{R}/new_bristol_ckts/arith/{f}", opt)
    return out


def tb_md5(opt):
    out = []
    _run(out, tl.test_md5, f"{R}/old_bristol_ckts/crypto/md5.txt", opt)
    return out


def tb_sha1(opt):
    """SHA-1 compression (circuit data-only in the reference; real TB here)."""
    out = []
    _run(out, tl.test_sha1, f"{R}/old_bristol_ckts/crypto/sha-1.txt", opt)
    return out


def tb_sha256(opt):
    out = []
    _run(out, tl.test_sha256, f"{R}/new_bristol_ckts/crypto/sha256.txt", opt)
    return out


def tb_aes_sizes(opt):
    """New-Bristol AES-128/192/256 (data-only in the reference; real TB here)."""
    out = []
    for f in _cases(opt, ("aes_128.txt", "aes_192.txt", "aes_256.txt")):
        _run(out, tl.test_aes_new, f"{R}/new_bristol_ckts/crypto/{f}", opt)
    return out


def tb_fp(opt):
    """IEEE-754 binary64 suite (FP-div/FP-sqrt are missing blobs in the
    reference corpus; generated here)."""
    out = []
    for f in _cases(opt, ("FP-add.txt", "FP-mul.txt", "FP-div.txt",
                         "FP-sqrt.txt", "FP-eq.txt", "FP-f2i.txt")):
        _run(out, tl.test_fp, f"{R}/new_bristol_ckts/fp/{f}", opt)
    return out


def tb_des(opt):
    """DES expanded/non-expanded (circuit data-only in the reference)."""
    out = []
    for f in _cases(opt, ("DES-expanded.txt", "DES-non-expanded.txt")):
        _run(out, tl.test_des, f"{R}/old_bristol_ckts/crypto/{f}", opt)
    return out


def tb_sha512(opt):
    """SHA-512 compression (missing blob upstream; generated here)."""
    out = []
    _run(out, tl.test_sha512, f"{R}/new_bristol_ckts/crypto/sha512.txt", opt)
    return out


def tb_keccak(opt):
    """Keccak-f[1600] permutation (missing blob upstream; generated here)."""
    out = []
    _run(out, tl.test_keccak, f"{R}/new_bristol_ckts/crypto/Keccak_f.txt", opt)
    return out


def tb_aes(opt):
    out = []
    for f in _cases(opt, ("AES-expanded.txt", "AES-non-expanded.txt")):
        _run(out, tl.test_aes, f"{R}/old_bristol_ckts/crypto/{f}", opt)
    return out


BENCHES = {
    "adder_2bit": tb_adder_2bit,
    "parity": tb_parity,
    "adders": tb_adders,
    "comparators": tb_comparators,
    "multipliers": tb_multipliers,
    "arith64": tb_arith64,
    "md5": tb_md5,
    "sha1": tb_sha1,
    "sha256": tb_sha256,
    "sha512": tb_sha512,
    "keccak": tb_keccak,
    "aes": tb_aes,
    "des": tb_des,
    "aes_sizes": tb_aes_sizes,
    "fp": tb_fp,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in list(BENCHES) + ["all"]:
        print(f"usage: python -m oece_tpu_torch.harness.tb <{'|'.join(BENCHES)}|all> [flags]")
        return 2
    bench = argv.pop(0)
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ns, argv = dev.parse_known_args(argv)
    opt = TBOptions(**dataclasses.asdict(parse_inputs(argv, description=f"TB_{bench}")),
                    device=ns.device)
    names = list(BENCHES) if bench == "all" else [bench]
    results = []
    for nm in names:
        results += BENCHES[nm](opt)
    npass = sum(r.passed for r in results)
    print(f"=== {npass}/{len(results)} benches passed ===")
    return 0 if npass == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
