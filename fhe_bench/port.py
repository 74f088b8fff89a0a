"""Every contact of the benchmark with the program under test, the PyTorch
and CUDA port ``oece_tpu_torch``: its parameter record, its key assembly,
its ``Circuit``, the output ciphertexts, a hook around each level, and the
two module-level calls the traced run wraps in spans.  Nothing else of the
program is read, and nothing of it is changed.

The program has no public entry point for three of these, so they read
``Circuit``'s private state: the output ciphertexts (``_ct_arena`` and
``_slot``), the level hook (``_run_level`` and ``_cur_level``) and, in
the traced run, the output decryption alone (``_collect_outputs``).  A
change of those names in the program breaks them loudly.

``Circuit`` holds the client's secret, as the program has no other way in:
``SetInput`` encrypts the request's bits with it on the host, and every
encrypted ``Clock`` ends by decrypting each output word with it
(``_collect_outputs``) and copying the bits to the host.  Both are inside
a request's time.  The benchmark judges the output ciphertexts, never the
bits the program decrypts.
"""

from __future__ import annotations

import statistics
import time
from typing import List

import numpy as np
import torch

from oece_tpu_torch.fhe import boot, devkeygen, golden, hostkeygen
from oece_tpu_torch.fhe.params import BinFHEMethod, BinFHEParams
from oece_tpu_torch.runtime.evaluator import Circuit


def params(cfg: dict) -> BinFHEParams:
    return BinFHEParams(name=cfg["paramset"], **cfg["params"])


def build_keys(cfg: dict, p: BinFHEParams, draws: dict, host_seed: int, device):
    """The program's keys from the benchmark's draws: its assembly of the
    device layouts ("rev2", "rev", "ap_ext"), or for "ginx_ext" its host
    keygen around the benchmark's LWE secret."""
    sk = golden.LWESecretKey(s=draws["s"].cpu().numpy().astype(np.int64), params=p)
    order = ("s", "z", "A", "E", "Aks", "Eks")
    layout = cfg["key_layout"]
    if layout == "ap_ext":
        keys = devkeygen.assemble_ap(p, *(draws[k] for k in order))
    elif layout in ("rev", "rev2"):
        keys = devkeygen.assemble(p, *(draws[k] for k in order), layout=layout)
    elif layout == "ginx_ext":
        keys = hostkeygen.bootstrap_keygen(p, sk, np.random.default_rng(host_seed),
                                           BinFHEMethod.GINX, device)
    else:
        raise ValueError(f"unknown key layout {layout!r}")
    return sk, keys


def circuit(cfg: dict, traffic: dict, p, sk, keys, path: str, enc_seed: int, device) -> Circuit:
    """The Circuit: keys given, no key generation, inputs encrypted on
    the host from ``enc_seed``; the traffic sets the check mode (default:
    pure-encrypted, recovery off) and the XOR form."""
    c = Circuit(set=p, method=cfg["method"], device=device, keys=keys, sk=sk,
                rng=np.random.default_rng(enc_seed), generate_keys=False,
                xor_mode=traffic.get("xor_mode", "native"))
    c.ReadFile(path)
    verify = bool(traffic.get("verify", False))
    c.setPlaintext(verify)
    c.setEncrypted(True)
    c.setVerify(verify)
    c.setRecovery(bool(traffic.get("recovery", False)))
    return c


def evaluate(c: Circuit, words: List[np.ndarray], device) -> List[torch.Tensor]:
    """One request: Reset, SetInput, Clock; returns the output ciphertexts
    [bits, T, n+1] per output word, on the device, after a synchronize."""
    c.Reset()
    c.SetInput(words)
    c.Clock()
    outs = output_ciphertexts(c)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return outs


def output_ciphertexts(c: Circuit) -> List[torch.Tensor]:
    dev = c._ct_arena.device
    return [c._ct_arena[torch.from_numpy(c._slot[w]).to(dev)] for w in c.netlist.outputs]


def level_hook(c: Circuit, before, after) -> None:
    """Calls before(lv) and after(lv) around each level of ``c``'s Clock."""
    run = c._run_level

    def hooked(level):
        lv = c._cur_level
        before(lv)
        run(level)
        after(lv)

    c._run_level = hooked


def client_costs(c: Circuit, words: List[np.ndarray], repeats: int) -> tuple[float, float]:
    """Median host seconds of the client's two parts of a request, after an
    evaluation: SetInput (host encryption and upload) and the decryption of
    every output word that Clock ends with.  Leaves ``c`` needing a Reset."""
    sync = torch.cuda.synchronize if c.device.type == "cuda" else (lambda: None)
    dec, enc = [], []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        c._collect_outputs()
        dec.append(time.perf_counter() - t0)
    for _ in range(repeats):
        c.Reset()
        sync()
        t0 = time.perf_counter()
        c.SetInput(words)
        sync()
        enc.append(time.perf_counter() - t0)
    return statistics.median(enc), statistics.median(dec)


def wrap_spans(bootstrap_batch, blind_rotation):
    """Replace the program's module-level boot.bootstrap_batch and
    boot.blind_rotation (the evaluator and bootstrap_batch call them by
    module name) with the given wrappers of the originals; returns the
    function that restores them."""
    orig = boot.bootstrap_batch, boot.blind_rotation
    boot.bootstrap_batch = bootstrap_batch(orig[0])
    boot.blind_rotation = blind_rotation(orig[1])

    def restore():
        boot.bootstrap_batch, boot.blind_rotation = orig

    return restore
