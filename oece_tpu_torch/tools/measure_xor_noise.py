"""The noise of each gate type, and of the prepared input it decides on
(counterpart of the JAX package's tools/measure_xor_noise.py; NOISE.md
§3).

  * per gate type (XOR, AND, XNOR, OR) a chained bootstrap loop, each
    batch's outputs feeding the next, as measure_noise.py's: the output
    failure rate and error histogram of that type alone;
  * the input side: the centred phase error of the prepared combination
    w1*c1 + w2*c2 (``boot.prepare_gates``) against its known value
    (w1*m1 + w2*m2)*q/4, which the blind rotation decides on,
    histogrammed on the device and set against the gate's own window
    margin ``PREP_MARGIN`` (XOR's prep noise is 2*sqrt(2) larger than
    AND's, its window twice as wide);
  * ``--scan``: the static shared-linear-root scan of the corpus
    (examples/old_bristol_ckts and new_bristol_ckts through the port's
    circuits/bristol.py): a 2-input gate whose operands follow NOT/EQW
    chains to one wire carries correlated noise.

``xor_chunk`` runs given chained batches from an ``XorCarry``; ``run``
loops the four gate types and returns the JAX tool's summary; ``main``
writes it as JSON under build/noise/ (never artifacts/).  Keys: device
keygen with seed 0 in the rev2 (default) or rev layout, or golden host
keys for ``--layout host``.

    python -m oece_tpu_torch.tools.measure_xor_noise [SET] [n_iters] [batch]
        [--layout rev2|rev|host] [--device cuda|cpu] [--out PATH]
    python -m oece_tpu_torch.tools.measure_xor_noise --scan
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..fhe import boot, lwe
from ..fhe.params import get_params
from .measure_noise import (CHUNK, LAYOUTS, REPO, card_line, centred_error, first_batch, histogram,
                            make_keys, truth_all, write, zeros)

GATES = ((4, "XOR"), (0, "AND"), (5, "XNOR"), (1, "OR"))  # (gate id, name), the JAX tool's order


def prep_margin(q: int) -> dict:
    """Each gate's decision window margin on its prep phase (golden's
    GATE_WINDOW): the nearest distance from a valid prep point to the
    window's edge, in q units."""
    return {"AND": q // 8, "OR": q // 8, "NAND": q // 8, "NOR": q // 8, "XOR": q // 4, "XNOR": q // 4}


@dataclasses.dataclass
class XorCarry:
    """The chain's state on the device: operands c1, c2 int32 [B, n+1],
    bits m1, m2 int32 [B], the output- and prep-error histograms int64
    [q], the failure count and the largest output and prep |e|."""

    c1: torch.Tensor
    c2: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    ohist: torch.Tensor
    phist: torch.Tensor
    nfail: torch.Tensor
    maxo: torch.Tensor
    maxp: torch.Tensor


def xor_chunk(keys, s: torch.Tensor, carry: XorCarry, gids: torch.Tensor) -> XorCarry:
    """Chained batches: gids int32 [k, B] (one gate type throughout, in the
    tool); per batch the prep, its phase error against (w1*m1 + w2*m2)*q/4,
    the bootstrap, the output's error against the gate's truth, and the
    chain of measure_noise.noise_chunk.  s is the LWE secret int32 [n] on
    the keys' device."""
    q = keys.params.q
    weights = torch.from_numpy(boot.PREP_WEIGHTS).to(s.device, non_blocking=True)  # no host wait
    c = carry
    for g in gids:
        prep = boot.prepare_gates(c.c1, c.c2, g, q)
        w = weights[g.long()]
        expq = (w[:, 0] * c.m1 + w[:, 1] * c.m2) % 4
        perr = (lwe.phase_dev(s, prep, q) - expq * (q // 4) + q // 2) % q - q // 2
        out = boot.bootstrap_batch(prep, g, keys)
        want = truth_all(c.m1, c.m2).gather(0, g[None].long())[0]
        err = centred_error(s, out, want, q)
        c = XorCarry(
            c1=out, c2=torch.roll(c.c1, 1, 0), m1=want, m2=torch.roll(c.m1, 1),
            ohist=c.ohist + histogram(err, q), phist=c.phist + histogram(perr, q),
            nfail=c.nfail + (err.abs() >= q // 8).sum(),
            maxo=torch.maximum(c.maxo, err.abs().max()),
            maxp=torch.maximum(c.maxp, perr.abs().max()),
        )
    return c


def gate_summary(name: str, c: XorCarry, n_tot: int, q: int, dt: float) -> dict:
    """The JAX tool's record of one gate type (histograms read here)."""
    ohist, phist = c.ohist.cpu().numpy(), c.phist.cpu().numpy()
    n_fail, max_o, max_p = int(c.nfail), int(c.maxo), int(c.maxp)
    centers = np.arange(q) - q // 2
    o_std = float(np.sqrt((ohist * centers ** 2).sum() / max(n_tot, 1)))
    p_std = float(np.sqrt((phist * centers ** 2).sum() / max(n_tot, 1)))
    margin = prep_margin(q)[name]
    return {
        "bootstraps": n_tot, "failures": n_fail, "failure_rate": n_fail / n_tot,
        "out_noise_std": round(o_std, 2), "out_noise_max_abs": max_o,
        "prep_margin_q": margin, "prep_err_std": round(p_std, 2), "prep_err_max_abs": max_p,
        "prep_margin_sigmas": round(margin / p_std, 2) if p_std else None,
        "boots_per_sec": round(n_tot / dt, 1),
        "out_hist_nonzero": {int(k): int(h) for k, h in zip(centers, ohist) if h},
        "prep_hist_nonzero": {int(k): int(h) for k, h in zip(centers, phist) if h},
    }


def run(set_name: str = "STD128_OPT", n_iters: int = 100, B: int = 2048, layout: str = "rev2",
        device="cuda", log=print) -> dict:
    """The keys of seed 0, then per gate type of ``GATES`` a
    first batch from ``np.random.default_rng(321)`` (one stream across the
    types) and ceil(n_iters / CHUNK) chunks of CHUNK chained batches of B
    gates; the host reads each type's histograms once, at its end."""
    p = get_params(set_name)
    q = p.q
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("measure_xor_noise: CUDA is not available; pass --device cpu for the CPU")
    rng = np.random.default_rng(321)
    sk, dkeys = make_keys(p, layout, dev)
    s = torch.as_tensor(np.asarray(sk.s), dtype=torch.int32, device=dev)
    results = {}
    for gate_id, name in GATES:
        (oh, zero), (ph, _) = zeros(q, dev), zeros(q, dev)
        c = XorCarry(**first_batch(sk, rng, B, dev), ohist=oh, phist=ph, nfail=zero,
                     maxo=zero.clone(), maxp=zero.clone())
        gids = torch.full((CHUNK, B), gate_id, dtype=torch.int32, device=dev)
        t0 = time.time()
        n_tot = 0
        for _ in range(-(-n_iters // CHUNK)):
            c = xor_chunk(dkeys, s, c, gids)
            n_tot += CHUNK * B
        r = results[name] = gate_summary(name, c, n_tot, q, time.time() - t0)
        log(f"# {name}: {n_tot} boots, {r['failures']} failures, out sigma {r['out_noise_std']:.2f} "
            f"(max {r['out_noise_max_abs']}), prep sigma {r['prep_err_std']:.2f} (max "
            f"{r['prep_err_max_abs']}, margin {r['prep_margin_q']} = {r['prep_margin_sigmas'] or 0:.1f} "
            f"sigma) [{time.time() - t0:.1f}s]")
    return {
        "set": set_name, "layout": layout, "backend": dev.type, "device": card_line(dev),
        "batch": B, "chained": True, "per_gate": results,
        "note": ("per-gate-type chained bootstrap loops; prep_err is the input-side phase error "
                 "the blind rotation decides on (vs the gate's own window margin)"),
    }


def corpus_files() -> list:
    """The corpus's Bristol files, sorted: examples/old_bristol_ckts and
    examples/new_bristol_ckts, every .txt."""
    root = os.path.join(REPO, "examples")
    files = []
    for sub in ("old_bristol_ckts", "new_bristol_ckts"):
        for dirp, _dirs, fns in os.walk(os.path.join(root, sub)):
            files += [os.path.join(dirp, fn) for fn in fns if fn.endswith(".txt")]
    return sorted(files)


def shared_roots(nl) -> int:
    """The 2-input bootstrapped gates of netlist nl whose operands share a
    linear root: root(w) follows NOT/EQW chains, a bootstrapped or other
    gate's output is its own root."""
    from ..circuits.netlist import BOOTSTRAP_OPS, Op

    boot_ops = {int(o) for o in BOOTSTRAP_OPS}
    linear = (int(Op.NOT), int(Op.EQW))
    root = np.arange(nl.n_wires, dtype=np.int64)
    shared = 0
    for o, a, b, w in zip(nl.op.tolist(), nl.in0.tolist(), nl.in1.tolist(), nl.out.tolist()):
        if o in linear:
            root[w] = root[a]
        else:
            shared += o in boot_ops and root[a] == root[b]
            root[w] = w
    return int(shared)


def scan_corpus(files: Optional[Sequence[str]] = None, log=print) -> int:
    """The shared-linear-root count over ``files`` (default the corpus);
    a file that does not parse is skipped, as in the JAX tool."""
    from ..circuits import bristol

    total = 0
    for f in corpus_files() if files is None else files:
        try:
            nl = bristol.parse_bristol(f)
        except (ValueError, IndexError, KeyError):
            continue
        shared = shared_roots(nl)
        total += shared
        if shared:
            log(f"{os.path.basename(f)}: {shared} shared-root gates")
    log(f"# corpus total shared-linear-root 2-input gates: {total}")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("set", nargs="?", default="STD128_OPT")
    ap.add_argument("n_iters", nargs="?", type=int, default=100)
    ap.add_argument("batch", nargs="?", type=int, default=2048)
    ap.add_argument("--layout", default="rev2", choices=LAYOUTS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="the JSON document's path")
    ap.add_argument("--scan", action="store_true", help="the static shared-root scan only")
    args = ap.parse_args(argv)
    if args.scan:
        scan_corpus()
        return 0
    res = run(args.set, args.n_iters, args.batch, args.layout, args.device)
    print(f"# device: {res['device']}")
    print(json.dumps({g: {k: v for k, v in r.items() if not k.endswith("hist_nonzero")}
                      for g, r in res["per_gate"].items()}))
    path = args.out or os.path.join(REPO, "build", "noise", f"xor_noise_{args.set}_{args.layout}.json")
    write(res, path)
    print(f"# written {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
