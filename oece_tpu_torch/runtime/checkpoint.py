"""Mid-circuit checkpoint and resume (counterpart of
oece_tpu.runtime.checkpoint).

``Circuit.Clock(checkpoint_path=..., checkpoint_every=N)`` saves the
evaluation state every N levels, and a later ``Clock`` with the same path
on the same circuit, batch and modes resumes from the last saved level.
The format is the JAX package's: one ``.npz`` with a JSON header
(``meta``), uncompressed here (``write``), written to a temporary file
and moved into place with ``os.replace``; the netlist and modes are
fingerprinted with the JAX package's fields, and besides them with a
digest of the keys (the LWE secret and the key-switch key), the XOR mode
and the recovery flag and threshold, so a checkpoint is resumed only on
the identical circuit, batch, keys and modes, and only with the arena's
slot count.  The file is removed when the
evaluation completes (Circuit.Clock).

Besides the JAX package's state (both arenas, the DFF state, the gate and
repair counts and the numpy generator), a checkpoint holds the Clock()
cycle that the lane trace tags and what the port's
device branch keeps on the card until the end of ``Clock()``: the
``torch.Generator`` of its re-encryptions, its verify and recovery
accumulators and the lane trace's cube, and, on either branch, the repairs
by level, the recovery counts, the worst margin and the lane trace.  A
resumed run therefore equals an uninterrupted one bit for bit on both
branches, repair counts included; the device branch's plaintext arena,
computed for every level before the first bootstrap, is saved whole and
uploaded again on resume.  A checkpoint of one branch is not resumed on
the other (their generators differ).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

# the device branch's accumulators, saved when present
_DEVICE_STATE = ("_bad_dev", "_bad_lv_dev", "_rec_dev", "_rec_max", "_bad_mask_dev")


def _key_digest(circ) -> str:
    """sha256 of the LWE secret and the key-switch key: ciphertexts saved
    under other keys decrypt wrongly.  Computed once per key object (the
    key-switch key may sit on the card)."""
    ident = (id(circ.sk), id(circ.keys))
    cached = getattr(circ, "_ckpt_key_digest", None)
    if cached is None or cached[0] != ident:
        h = hashlib.sha256()
        if circ.sk is not None:
            h.update(np.ascontiguousarray(circ.sk.s).tobytes())
        if circ.keys is not None:
            h.update(circ.keys.ksk.cpu().numpy().tobytes())
        cached = circ._ckpt_key_digest = (ident, h.hexdigest())
    return cached[1]


def _fingerprint(circ) -> str:
    nl = circ.netlist
    h = hashlib.sha256()
    h.update(nl.name.encode())
    for a in (nl.op, nl.in0, nl.in1, nl.out, nl.dff_d, nl.dff_q):
        h.update(np.ascontiguousarray(a).tobytes())
    for w in nl.inputs + nl.outputs:
        h.update(np.ascontiguousarray(w).tobytes())
    h.update(json.dumps([
        circ.params.name, circ.method.value, circ.plaintext_flag, circ.encrypted_flag,
        circ.verify_flag, circ._batch,
        # the port's fields: the keys, and the modes that change the gates
        # run and the repairs counted
        _key_digest(circ), circ.xor_mode, circ.recover_flag, circ.recover_threshold,
    ]).encode())
    return h.hexdigest()


def _branch(circ) -> str:
    return "device" if circ._dev_branch else "host"


def state(circ, next_level: int) -> tuple[dict, dict]:
    """The evaluation state reached before ``next_level``, on the host:
    (the JSON header, the arrays).  Reading the card's tensors waits for
    the work queued on it."""
    arrays = {
        "next_level": np.int64(next_level),
        "bootstraps_run": np.int64(circ._bootstraps_run),
        "n_ct_slots": np.int64(circ._n_ct_slots),
    }
    if circ._plain_arena is not None:
        arrays["plain_arena"] = circ._plain_arena
    if circ._ct_arena is not None:
        arrays["ct_arena"] = circ._ct_arena.cpu().numpy()
    if circ._state_plain is not None:
        arrays["state_plain"] = circ._state_plain
    if circ._state_ct is not None:
        arrays["state_ct"] = circ._state_ct.cpu().numpy()
    if circ._gen is not None:
        arrays["gen_state"] = circ._gen.get_state().numpy()
    for name in _DEVICE_STATE:
        t = getattr(circ, name)
        if t is not None:
            arrays[name.lstrip("_")] = t.cpu().numpy()
    meta = {
        "fingerprint": _fingerprint(circ),
        "branch": _branch(circ),
        "gate_counts": circ.gate_counts,
        "bad_gate_counts": circ.bad_gate_counts,
        "bad_gate_levels": {str(k): v for k, v in circ.bad_gate_levels.items()},
        "bad_gate_lanes": circ.bad_gate_lanes,
        "recover_counts": circ.recover_counts,
        "max_phase_err": int(circ.max_phase_err),
        "cycle": circ._cycle,
        "rng_state": circ._rng.bit_generator.state,  # plain ints: JSON-safe
    }
    return meta, arrays


def write(path: str, meta: dict, arrays: dict, compress: bool = False) -> None:
    """One ``.npz`` (``np.load`` reads either form) with ``meta`` as its
    JSON header, moved into place atomically.  Uncompressed by default:
    ``np.savez_compressed`` makes the file 0.44x as large but takes 30-50x
    as long (chip_smoke.py's ``checkpoint`` phase times both)."""
    tmp = f"{path}.{os.getpid()}.tmp"  # the ranks of a mesh write the same state
    with open(tmp, "wb") as f:
        (np.savez_compressed if compress else np.savez)(
            f, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
    os.replace(tmp, path)  # atomic: a torn write never clobbers a checkpoint


def save(circ, path: str, next_level: int) -> None:
    """Write the evaluation state reached before ``next_level``."""
    write(path, *state(circ, next_level))


def maybe_resume(circ, path: str) -> int:
    """If ``path`` holds a checkpoint of this circuit, batch and modes, on
    this check branch and slot map, restore its state and return the level
    to resume from; else return 0 (and change nothing)."""
    if not os.path.exists(path):
        return 0
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["fingerprint"] != _fingerprint(circ) or meta["branch"] != _branch(circ):
            return 0
        if int(z["n_ct_slots"]) != circ._n_ct_slots:
            return 0  # saved under another arena slot map
        dev = circ.device
        circ._plain_arena = z["plain_arena"] if "plain_arena" in z else circ._plain_arena
        if "ct_arena" in z:
            circ._ct_arena = torch.from_numpy(z["ct_arena"]).to(dev)
        if "state_plain" in z:
            circ._state_plain = z["state_plain"]
        if "state_ct" in z:
            circ._state_ct = torch.from_numpy(z["state_ct"]).to(dev)
        circ._gen = None  # re-seeded from the restored generator when first used
        if "gen_state" in z:
            circ._gen = torch.Generator(device=dev)
            circ._gen.set_state(torch.from_numpy(z["gen_state"]))
        for name in _DEVICE_STATE:
            key = name.lstrip("_")
            setattr(circ, name, torch.from_numpy(z[key]).to(dev) if key in z else None)
        circ._bootstraps_run = int(z["bootstraps_run"])
        next_level = int(z["next_level"])
    circ.gate_counts = dict(meta["gate_counts"])
    circ.bad_gate_counts = dict(meta["bad_gate_counts"])
    circ.bad_gate_levels = {int(k): dict(v) for k, v in meta["bad_gate_levels"].items()}
    circ.bad_gate_lanes = list(meta["bad_gate_lanes"])
    circ.recover_counts = dict(meta["recover_counts"])
    circ.max_phase_err = int(meta["max_phase_err"])
    circ._cycle = int(meta["cycle"])
    circ._rng.bit_generator.state = meta["rng_state"]
    return next_level
