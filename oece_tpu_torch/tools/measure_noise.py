"""Bootstrap noise distribution and failure rate (counterpart of the JAX
package's tools/measure_noise.py; NOISE.md).

Everything stays on the device until a progress line:

  * the first ciphertext batch is encrypted on the host and uploaded once;
  * every batch bootstraps the previous batch's outputs (chained: the
    input noise a circuit's gates see);
  * gate types are drawn on the device (a ``torch.Generator``), the
    plaintext truth is co-evaluated there, and the centred phase error of
    every output is histogrammed there (an ``index_add_`` into q bins);
  * the host reads the histogram and counters only at a progress line
    (every ten chunks and at the end), the JAX tool's fetches.

``noise_chunk`` runs given chained batches from a ``Carry`` (ciphertexts,
plaintexts, histogram, counters); ``run`` makes the keys, the first batch
and the gate ids and returns the JAX tool's summary; ``main`` writes it as
JSON under build/noise/ (never artifacts/, which holds the TPU's).

Keys: device keygen with seed 0 (eight zero seed words) in the rev2 or rev
layout, or golden host keys (``fhe/keycache.py``, seed 0: ginx_ext, the
standard form on host keys) for ``--layout host``; ``run(seed=k)`` takes
the keys of another seed (chip_smoke.py's sweep of the noise mean over key
draws).

    python -m oece_tpu_torch.tools.measure_noise [SET] [n_iters] [batch]
        [--layout rev|rev2|host] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..fhe import boot, devkeygen, keycache, lwe
from ..fhe.params import BinFHEMethod, get_params

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHUNK = 10  # chained batches per chunk; a progress line every ten chunks
LAYOUTS = ("rev", "rev2", "host")


@dataclasses.dataclass
class Carry:
    """The chain's state on the device: the next batch's operands c1, c2
    int32 [B, n+1] and their bits m1, m2 int32 [B]; the output-error
    histogram int64 [q] (bin e + q/2 for the centred error e), the failure
    count and the largest |e| (int64 scalars)."""

    c1: torch.Tensor
    c2: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    hist: torch.Tensor
    nfail: torch.Tensor
    maxabs: torch.Tensor


def truth_all(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Every gate of GATE_ORDER (AND OR NAND NOR XOR XNOR) on bits m1, m2
    int32 [B] -> int32 [6, B]."""
    a, o, x = m1 & m2, m1 | m2, m1 ^ m2
    return torch.stack([a, o, 1 - a, 1 - o, x, 1 - x])


def centred_error(s: torch.Tensor, cts: torch.Tensor, want: torch.Tensor, q: int) -> torch.Tensor:
    """The phase error of cts int32 [B, n+1] against bits want encoded at
    want*q/4, centred into (-q/2, q/2]: int64 [B] (lwe.decrypt_noise)."""
    err = (lwe.phase_dev(s, cts, q) - want * (q // 4)) % q
    return torch.where(err > q // 2, err - q, err)


def histogram(err: torch.Tensor, q: int) -> torch.Tensor:
    """Counts of centred errors err, bin (e + q/2) mod q: int64 [q].  An
    index_add_, not torch.bincount: on the card bincount reads its input's
    minimum and maximum back to the host to size its output."""
    idx = ((err + q // 2) % q).long()
    return torch.zeros(q, dtype=torch.int64, device=err.device).index_add_(0, idx, torch.ones_like(idx))


def first_batch(sk, rng: np.random.Generator, B: int, device) -> dict:
    """The chain's first operands, as the JAX tool draws them: bits m1, m2
    from ``rng``, then c1, c2 encrypted on the host and uploaded once."""
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    c1, c2 = lwe.encrypt_bits(sk, m1, rng), lwe.encrypt_bits(sk, m2, rng)
    up = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(device)  # noqa: E731
    return dict(c1=up(c1), c2=up(c2), m1=up(m1), m2=up(m2))


def zeros(q: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """An empty histogram int64 [q] and a zero int64 counter."""
    return (torch.zeros(q, dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def noise_chunk(keys, s: torch.Tensor, carry: Carry, gids: torch.Tensor) -> Carry:
    """Chained batches of mixed gates: gids int32 [k, B] are the gate types
    of k batches; batch j bootstraps EvalBinGate(gids[j], c1, c2), and its
    outputs and bits become the next batch's c1 and m1 while the last c1
    and m1, rolled by one lane, become c2 and m2 (the JAX tool's chain).
    s is the LWE secret int32 [n] on the keys' device."""
    q = keys.params.q
    c = carry
    for g in gids:
        out = boot.eval_bin_gate_batch(keys, g, c.c1, c.c2)
        want = truth_all(c.m1, c.m2).gather(0, g[None].long())[0]
        err = centred_error(s, out, want, q)
        c = Carry(
            c1=out, c2=torch.roll(c.c1, 1, 0), m1=want, m2=torch.roll(c.m1, 1),
            hist=c.hist + histogram(err, q),
            nfail=c.nfail + (err.abs() >= q // 8).sum(),
            maxabs=torch.maximum(c.maxabs, err.abs().max()),
        )
    return c


def make_keys(p, layout: str, device, seed: int = 0):
    """(sk, keys) of ``seed``: device keygen (seed words [seed, 0, ..., 0])
    in rev or rev2, or golden host keys (ginx_ext) from the key cache for
    "host"."""
    if layout == "host":
        return keycache.load_or_generate(p, BinFHEMethod.GINX, seed, device)
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: choose from {LAYOUTS}")
    words = np.zeros(8, np.uint32)
    words[0] = seed
    return devkeygen.device_keygen(p, words, device, layout=layout)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def summary(hist: np.ndarray, n_tot: int, n_fail: int, max_abs: int, q: int) -> dict:
    """The JAX tool's statistics of an output-error histogram."""
    centers = np.arange(q) - q // 2
    mean = float((hist * centers).sum() / n_tot)
    std = float(np.sqrt((hist * (centers - mean) ** 2).sum() / n_tot))
    margin = q // 8
    return {
        "bootstraps": n_tot, "failures": n_fail, "failure_rate": n_fail / n_tot,
        "noise_mean": mean, "noise_std": std, "noise_max_abs": max_abs, "margin_q8": margin,
        "margin_sigmas": margin / std if std else None,
    }


def run(set_name: str = "STD128_OPT", n_iters: int = 100, B: int = 1024, layout: str = "rev",
        device="cuda", seed: int = 0, log=print) -> dict:
    """The keys of ``seed`` (0, as the JAX tool's), the first batch from
    ``np.random.default_rng(123)``, then ceil(n_iters / CHUNK) chunks of
    CHUNK chained batches of B random gates; returns the JAX tool's
    summary."""
    p = get_params(set_name)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("measure_noise: CUDA is not available; pass --device cpu for the CPU")
    rng = np.random.default_rng(123)
    sk, dkeys = make_keys(p, layout, dev, seed)
    s = torch.as_tensor(np.asarray(sk.s), dtype=torch.int32, device=dev)
    hist, zero = zeros(p.q, dev)
    carry = Carry(**first_batch(sk, rng, B, dev), hist=hist, nfail=zero, maxabs=zero.clone())
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000)
    t0 = time.time()
    n_tot = 0
    chunks = -(-n_iters // CHUNK)
    for k in range(chunks):
        gids = torch.randint(0, 6, (CHUNK, B), generator=gen, device=dev, dtype=torch.int32)
        carry = noise_chunk(dkeys, s, carry, gids)
        n_tot += CHUNK * B
        if k == chunks - 1 or k % 10 == 9:
            n_fail, max_abs = int(carry.nfail), int(carry.maxabs)  # the host waits here only
            dt = time.time() - t0
            log(f"# {n_tot} bootstraps, {n_fail} failures, max|e| {max_abs} "
                f"({dt:.1f}s, {n_tot / dt:.0f} boots/s)")
    hist = carry.hist.cpu().numpy()
    res = {"set": set_name, "method": "GINX", "layout": layout, "key_seed": seed, "d_g_eff": p.d_g_eff,
           "backend": dev.type, "device": card_line(dev),
           **summary(hist, n_tot, n_fail, max_abs, p.q),
           "boots_per_sec": n_tot / (time.time() - t0),
           "input_regime": "chained (outputs feed next gates, the circuit regime)"}
    res["hist_nonzero"] = {int(c): int(h) for c, h in zip(np.arange(p.q) - p.q // 2, hist) if h}
    return res


def write(res: dict, path: str) -> None:
    """The JSON document at ``path``; artifacts/ holds the TPU's
    measurements and is refused."""
    if os.path.abspath(path).startswith(os.path.join(REPO, "artifacts") + os.sep):
        raise ValueError(f"{path}: artifacts/ holds the JAX package's TPU measurements; write under build/")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("set", nargs="?", default="STD128_OPT")
    ap.add_argument("n_iters", nargs="?", type=int, default=100)
    ap.add_argument("batch", nargs="?", type=int, default=1024)
    ap.add_argument("--layout", default="rev", choices=LAYOUTS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="the JSON document's path")
    args = ap.parse_args(argv)
    res = run(args.set, args.n_iters, args.batch, args.layout, args.device)
    print(f"# device: {res['device']}")
    print(json.dumps({k: v for k, v in res.items() if k != "hist_nonzero"}))
    path = args.out or os.path.join(REPO, "build", "noise", f"noise_{args.set}_{args.layout}.json")
    write(res, path)
    print(f"# written {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
