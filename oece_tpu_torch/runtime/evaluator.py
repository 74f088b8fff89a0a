"""The circuit evaluator on torch (counterpart of oece_tpu.runtime.evaluator).

API parity with the reference ``Circuit`` (src/circuit.h:54-72): ReadFile,
LoadNetlist, Reset, SetInput, Clock, setPlaintext, setEncrypted, setVerify,
setRecovery, GetOutput, dumpNetList, dumpGates, dumpGateCount.  The engine
is the JAX package's level schedule: per level, every bootstrap gate of
every test case runs as one batch (fhe/boot.py), linear gates run as arena
ops, and each level's bootstrap outputs are then checked: in verify mode
decrypted, compared with the plaintext arena, counted and repaired by fresh
encryptions; in pure-encrypted mode with recovery (setRecovery, on by
default there) margin-checked and re-encrypted when they drift.
``xor_mode="compound"`` runs each level's XOR/XNOR gates first as the
reference's three bootstraps OR(AND(a, !b), AND(!a, b)), with their own
check; circuits with DFFs keep their state across Clock() cycles.

The checks run in one of the JAX package's two branches, chosen as it
chooses them: ``OECE_LEVEL_JIT=1`` selects the device branch, ``=0`` the
host branch, and unset the device branch on "cuda" and the host branch on
"cpu".
  * The host branch is the JAX package's CPU path bit for bit: decryptions
    come to the host each level, repairs are host encryptions drawn from
    ``self._rng``, and repair lines print per level.  Randomness: ``_rng``
    draws the 8 keygen seed words, then one ``encrypt_bits`` call per
    input word in SetInput, then one call covering all W*T lanes of a
    level's (or compound subset's) check whenever any of its lanes needs a
    repair.  Given the same keys and generator state, a run reproduces the
    JAX package's ciphertexts.
  * The device branch is the JAX package's accelerator branch: decryption,
    comparison, re-encryption (lwe.encrypt_bits_dev on a torch.Generator)
    and per-op repair counts stay on the device and are fetched once at the
    end of Clock(); in recovery it also repairs each gate's prep phase
    before its bootstrap (the fused level program's input-side check,
    counted as IN_<op>).  The generator is seeded by one
    ``_rng.integers(0, 2**31)`` draw where the JAX package takes its first
    device key (OS entropy for an unseeded circuit), so the host generator
    stays in step with the JAX package's.  Decryptions and repair counts
    match the JAX package's device branch; ciphertexts differ after the
    first repair (another generator).

Both blind-rotation methods run: GINX, and AP with the binary rotation
base (B_r = 2, as STD128 and STD128_OPT have it), each on device-generated
keys.  As in the JAX package, ``OECE_LAYOUT`` picks the device GINX key
layout (default "rev2", the rotated-difference form of fhe/rot.py, run as
one step loop, or one call per step under ``OECE_ROT_MEGA=0``; "rev", the
standard form on prebuilt diagonals of fhe/rev.py; any other value
raises).  With ``OECE_HOST_KEYGEN=1`` in the environment, as in the JAX
package, the keys are golden's host keys instead, drawn from ``self._rng``
(the LWE secret, then golden.bootstrap_keygen's draws, no seed words) and
packed as the JAX package packs them on an accelerator: GINX then runs the
standard form (fhe/std.py, Pallas kernels #1 and #4), AP its ap_ext
kernel.  Not ported yet (each raises NotImplementedError naming its ROADMAP
item): the generic-base AP method (B_r != 2), device meshes (``mesh=``,
``setMesh``), checkpointing (``Clock(checkpoint_path=...)``) and the
``OECE_BAD_TRACE=1`` lane trace of verify runs.  ``generate_keys=False``
skips key generation, as in the JAX package (plaintext work, or keys
injected with ``keys``/``sk``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..circuits import asm as asm_mod
from ..circuits import bristol as bristol_mod
from ..circuits.netlist import Netlist, Op, assign_ct_slots, levelize
from ..fhe import _build, boot, devkeygen, golden, hostkeygen, lwe
from ..fhe.keys import GATE_INDEX, BootKeys
from ..fhe.params import BinFHEMethod, BinGate, get_params
from ..utils.trace import LevelRecord, Trace

_OP_TO_GATE = {
    Op.AND: BinGate.AND, Op.OR: BinGate.OR, Op.NAND: BinGate.NAND,
    Op.NOR: BinGate.NOR, Op.XOR: BinGate.XOR, Op.XNOR: BinGate.XNOR,
}

_PLAIN_FN = {
    int(Op.AND): lambda a, b: a & b,
    int(Op.OR): lambda a, b: a | b,
    int(Op.NAND): lambda a, b: 1 - (a & b),
    int(Op.NOR): lambda a, b: 1 - (a | b),
    int(Op.XOR): lambda a, b: a ^ b,
    int(Op.XNOR): lambda a, b: 1 - (a ^ b),
}

_N_OPS = max(int(o) for o in Op) + 1  # device repair accumulators' op axis

# Lanes per device call; bootstraps are independent per lane, so chunking
# changes no value.
MAX_LANES = 4096


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to oece_tpu_torch yet (ROADMAP.md queue 1, {item})"
    )


class Circuit:
    """Parity class for the reference's Circuit.

    ``device`` is explicit: "cuda" needs a CUDA device and builds the
    rotation kernels at construction (raising if either fails); "cpu" runs
    the kernels' plain torch versions.  Keys of ``method`` are generated on
    ``device`` from ``seed`` (None draws OS entropy; ``OECE_HOST_KEYGEN=1``
    selects golden's host keys, see the module docstring), or injected with
    ``keys`` (of the same method), ``sk`` and ``rng`` (the generator for
    host encryption; an injected generator counts as a seed).
    """

    def __init__(
        self,
        set: str = "STD128_OPT",
        method: str | BinFHEMethod = "GINX",
        seed: Optional[int] = None,
        device: str | torch.device = "cuda",
        keys: Optional[BootKeys] = None,
        sk: Optional[golden.LWESecretKey] = None,
        rng: Optional[np.random.Generator] = None,
        xor_mode: str = "native",
        verbose: bool = False,
        generate_keys: bool = True,
        mesh=None,
    ):
        if mesh is not None:
            raise _not_ported("Circuit(mesh=...)", "item 10, the mesh")
        self.params = get_params(set) if isinstance(set, str) else set
        self.method = (
            method if isinstance(method, BinFHEMethod)
            else BinFHEMethod[str(method).upper()]
        )
        if self.method == BinFHEMethod.AP and (self.params.B_r != 2 or self.params.N % 128):
            raise _not_ported(
                f"method='AP' with B_r={self.params.B_r}, N={self.params.N} "
                "(only the binary rotation base with N % 128 == 0 is ported)",
                "the generic-base AP method",
            )
        if keys is not None and keys.method != self.method:
            raise ValueError(f"keys are {keys.method.name} keys, the circuit is {self.method.name}")
        if xor_mode not in ("native", "compound"):
            raise ValueError(f"xor_mode={xor_mode!r}: choose 'native' or 'compound'")
        # 'compound' is the reference's 3-bootstrap XOR OR(AND(a,!b),AND(!a,b))
        # (gate.cpp:194-203); 'native' the 1-bootstrap 2(c1-c2) XOR.
        self.xor_mode = xor_mode
        self.verbose = verbose
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Circuit(device='cuda'): CUDA is not available")
            _build.load()  # build the rotation kernels now; raises on failure
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        if self.params.name in ("TOY", "MICRO"):
            print(f"WARNING: {self.params.name} parameters have NO security")

        self._rng = rng if rng is not None else np.random.default_rng(seed)
        self._seed_explicit = seed is not None or rng is not None
        self._gen: Optional[torch.Generator] = None  # the device branch's, see _next_gen
        self.sk = sk
        self.keys = keys.to(self.device) if keys is not None else None
        self.keygen_s = 0.0
        if self.keys is None and generate_keys:
            t0 = time.time()
            if os.environ.get("OECE_HOST_KEYGEN") == "1":
                self.sk = golden.lwe_keygen(self.params, self._rng)
                self.keys = hostkeygen.bootstrap_keygen(
                    self.params, self.sk, self._rng, self.method, self.device
                )
            else:
                words = (
                    np.asarray(self._rng.integers(0, 2**32, size=8), dtype=np.uint32)
                    if seed is not None else None
                )
                if self.method == BinFHEMethod.AP:
                    self.sk, self.keys = devkeygen.device_keygen_ap(self.params, words, self.device)
                else:
                    self.sk, self.keys = devkeygen.device_keygen(
                        self.params, words, self.device,
                        layout=os.environ.get("OECE_LAYOUT", "rev2"),
                    )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.keygen_s = time.time() - t0
            if verbose:
                print(f"# key generation: {self.keygen_s:.1f}s")
        self._s_dev = (
            torch.as_tensor(np.asarray(self.sk.s), dtype=torch.int32, device=self.device)
            if self.sk is not None else None
        )

        self.netlist: Optional[Netlist] = None
        self.plan = None
        self.plaintext_flag = True
        self.encrypted_flag = False
        self.verify_flag = False
        self.recover_flag = False
        self._recover_explicit = False
        self.recover_threshold = self.params.q // 16
        self._batch = 1
        self._dev_branch = False
        self._index = None
        self.Reset()

    # -- file loading -------------------------------------------------------
    def ReadFile(self, fname: str) -> None:
        if fname.endswith(".out"):
            nl = asm_mod.parse_asm(fname)
        else:
            nl = bristol_mod.parse_bristol(fname)
        self.LoadNetlist(nl)

    def LoadNetlist(self, nl: Netlist) -> None:
        self.netlist = nl
        self.plan = levelize(nl)
        self._slot, self._n_ct_slots = assign_ct_slots(nl, self.plan)
        self._index = None
        if self.verbose:
            s = self.plan.stats()
            print(
                f"# levelized {nl.name}: depth {s['depth']}, "
                f"{s['bootstrap_gates']} bootstrap gates, "
                f"{self._n_ct_slots}/{nl.n_wires} ct slots"
            )
        self.Reset()

    # -- modes --------------------------------------------------------------
    def setPlaintext(self, flag: bool) -> None:
        self.plaintext_flag = bool(flag)

    def setEncrypted(self, flag: bool) -> None:
        self.encrypted_flag = bool(flag)

    def setVerify(self, flag: bool) -> None:
        """verify forces both modes on (circuit.cpp:833-840)."""
        self.verify_flag = bool(flag)
        if flag:
            self.plaintext_flag = True
            self.encrypted_flag = True

    def setRecovery(self, flag: bool, threshold: Optional[int] = None) -> None:
        """Pure-encrypted-mode failure recovery (the JAX package's
        setRecovery): after each level, every bootstrap output's phase
        margin is measured with the secret key and outputs whose |error|
        reaches ``threshold`` (default q/16, halfway to the q/8 decision
        boundary) are re-encrypted from their decoded bit; the device
        branch also re-encrypts each drifting gate prep before its
        bootstrap.  Counts go to ``recover_counts`` ("HARD": |error| >= q/8,
        a provable failure; "IN_<op>": prep repairs) and the worst margin to
        ``max_phase_err``.  On by default for pure-encrypted Clock() runs
        unless set here or ``OECE_AUTO_RECOVER`` is not "1"."""
        self.recover_flag = bool(flag)
        self._recover_explicit = True
        if flag:
            self.encrypted_flag = True
        self.recover_threshold = int(threshold) if threshold is not None else self.params.q // 16

    def setMesh(self, mesh) -> None:
        """Only ``setMesh(None)`` (no mesh) is supported."""
        if mesh is not None:
            raise _not_ported("setMesh", "item 10, the mesh")

    def Reset(self) -> None:
        self._plain_arena: Optional[np.ndarray] = None
        self._ct_arena: Optional[torch.Tensor] = None
        self.circuit_output = []
        self.gate_counts: Dict[str, int] = {}
        self.bad_gate_counts: Dict[str, int] = {}
        self.bad_gate_levels: Dict[int, Dict[str, int]] = {}
        self.manager_time = 0.0
        self.exec_time = 0.0
        self._done = False
        self._cur_level = 0
        self._bootstraps_run = 0
        self.trace: Optional[Trace] = None
        # sequential state: values latched on wires dff_q, cleared to 0 here
        self._state_plain: Optional[np.ndarray] = None  # [T, n_dff]
        self._state_ct: Optional[torch.Tensor] = None  # [n_dff, T, n+1]
        self.recover_counts: Dict[str, int] = {}
        self.max_phase_err = 0
        # device branch accumulators, fetched at the end of Clock()
        self._bad_dev: Optional[torch.Tensor] = None  # [ops] verify repairs
        self._bad_lv_dev: Optional[torch.Tensor] = None  # [depth+1, ops]
        self._rec_dev: Optional[torch.Tensor] = None  # [3, ops]: suspects, HARD, IN_
        self._rec_max: Optional[torch.Tensor] = None  # worst |phase error|

    # -- inputs -------------------------------------------------------------
    def SetInput(self, inputs: Sequence[np.ndarray]) -> None:
        """inputs: one bit array per declared input word, [bits] or
        [T, bits] (T = test-case batch)."""
        nl = self.netlist
        if nl is None:
            raise RuntimeError("ReadFile first")
        words = [np.atleast_2d(np.asarray(wd, dtype=np.int64)) for wd in inputs]
        if len(words) != len(nl.inputs):
            raise ValueError(
                f"circuit declares {len(nl.inputs)} input words, got {len(words)}"
            )
        T = words[0].shape[0]
        self._batch = T
        for wd, wires in zip(words, nl.inputs):
            if wd.shape != (T, len(wires)):
                raise ValueError(f"input word shape {wd.shape}, want {(T, len(wires))}")
        if self.plaintext_flag:
            self._plain_arena = np.zeros((T, nl.n_wires + 1), dtype=np.int8)
            for wd, wires in zip(words, nl.inputs):
                self._plain_arena[:, wires] = wd
            if nl.n_dff:
                if self._state_plain is None:
                    self._state_plain = np.zeros((T, nl.n_dff), dtype=np.int8)
                self._plain_arena[:, nl.dff_q] = self._state_plain
        if self.encrypted_flag:
            if self.sk is None:
                raise RuntimeError("no keys")
            p = self.params
            arena = np.zeros((self._n_ct_slots + 1, T, p.n + 1), dtype=np.int32)
            for wd, wires in zip(words, nl.inputs):
                cts = lwe.encrypt_bits(self.sk, wd.reshape(-1), self._rng)
                arena[self._slot[wires]] = cts.reshape(T, len(wires), p.n + 1).transpose(1, 0, 2)
            self._ct_arena = torch.from_numpy(arena).to(self.device)
            # else the zero ciphertexts on dff_q: noiseless encryptions of
            # 0, the flip-flops' initial state
            if nl.n_dff and self._state_ct is not None:
                self._ct_arena[torch.from_numpy(self._slot[nl.dff_q]).to(self.device)] = self._state_ct

    # -- the engine ---------------------------------------------------------
    def _use_level_jit(self) -> bool:
        """The JAX package's branch switch: OECE_LEVEL_JIT=1 the device
        branch, =0 the host branch, unset the device branch on the card."""
        v = os.environ.get("OECE_LEVEL_JIT")
        if v is not None:
            return v == "1"
        return self.device.type == "cuda"

    def _next_gen(self) -> torch.Generator:
        """The device branch's generator, seeded at its first use: from one
        ``_rng`` draw (where the JAX package seeds its device key) when the
        circuit is seeded, else from OS entropy."""
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
            if self._seed_explicit:
                self._gen.manual_seed(int(self._rng.integers(0, 2**31)))
            else:
                self._gen.manual_seed(int.from_bytes(os.urandom(8), "little"))
        return self._gen

    def Clock(
        self,
        verbose: bool = False,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
    ) -> None:
        """Evaluate the whole circuit (one cycle of a sequential one);
        ``checkpoint_every`` is read only with a ``checkpoint_path``, which
        is not ported."""
        if self.plan is None:
            raise RuntimeError("ReadFile first")
        if self._done:
            raise RuntimeError("Circuit already evaluated; call Reset")
        if checkpoint_path is not None:
            raise _not_ported("Clock(checkpoint_path=...)", "item 7, checkpointing")
        if self.verify_flag and os.environ.get("OECE_BAD_TRACE", "0") == "1":
            raise _not_ported("OECE_BAD_TRACE=1", "item 8, OECE_BAD_TRACE lanes")
        t_start = time.time()
        exec0 = self.exec_time
        if (self.encrypted_flag and not self.verify_flag and not self._recover_explicit
                and os.environ.get("OECE_AUTO_RECOVER", "1") == "1"):
            self.recover_flag = True  # pure-encrypted runs are margin-protected by default
        self._dev_branch = self.encrypted_flag and self._use_level_jit()
        mode = (
            "verify" if self.verify_flag
            else "encrypted" if self.encrypted_flag else "plaintext"
        )
        self.trace = Trace(circuit=self.netlist.name, mode=mode)
        self.trace.begin()
        index = self._level_index()
        plain_dev = None
        if self._dev_branch and self.verify_flag:
            # the whole plaintext pass first, then one upload: the device
            # checks read it without a host copy per level
            for level in self.plan.levels:
                self._plain_level(level)
            plain_dev = torch.from_numpy(self._plain_arena).to(self.device)
            self._bad_dev = torch.zeros(_N_OPS, dtype=torch.int64, device=self.device)
            self._bad_lv_dev = torch.zeros(
                (self.plan.depth + 1, _N_OPS), dtype=torch.int64, device=self.device
            )
        on_cuda = self.device.type == "cuda"
        for lv, level in enumerate(self.plan.levels):
            t0 = time.time()
            self._cur_level = lv
            b0 = self._bootstraps_run
            self._count_level(level)
            if self.plaintext_flag and plain_dev is None:
                self._plain_level(level)
            if self.encrypted_flag:
                groups, segments = index[lv]
                for grp in groups:
                    self._run_group(grp, plain_dev)
                self._run_linear_encrypted(segments)
                if on_cuda:
                    torch.cuda.synchronize(self.device)
            dt = time.time() - t0
            self.exec_time += dt
            self.trace.add(LevelRecord(
                level=lv, boot_gates=len(level["boot_op"]),
                linear_gates=len(level["lin_op"]), batch=self._batch,
                wall_s=dt, bootstraps=self._bootstraps_run - b0,
            ))
            if (self.verbose or verbose) and self.plan.depth > 1:
                print(
                    f"\rProcessing level {lv + 1} of {self.plan.depth}",
                    end="" if lv + 1 < self.plan.depth else "\n", flush=True,
                )
        self._flush_bad_dev()
        self._flush_rec_dev()
        self._collect_outputs()
        nl = self.netlist
        if nl.n_dff:  # latch D into the state; the circuit stays clockable
            if self.plaintext_flag:
                self._state_plain = self._plain_arena[:, nl.dff_d].copy()
            if self.encrypted_flag:
                self._state_ct = self._ct_arena[torch.from_numpy(self._slot[nl.dff_d]).to(self.device)]
        self.trace.end()
        total = time.time() - t_start
        self.manager_time += total - (self.exec_time - exec0)
        self._done = nl.n_dff == 0
        if self.verbose or verbose:
            eff = 100.0 * (self.exec_time - exec0) / total if total > 0 else 0.0
            print(f"### Total time {total * 1e3:.1f} msec, efficiency {eff:.1f}%")

    def _level_index(self) -> list:
        """Per level, ([bootstrap gate groups], [linear op runs]) with the
        device index tensors each needs, uploaded once per netlist: a
        group is the level's bootstrap gates, or under compound XOR its
        XOR/XNOR subset (run first) and the rest; a linear run is a run of
        one op, whose inputs rank order makes final."""
        if self._index is not None:
            return self._index
        parts: List[np.ndarray] = []

        def put(a) -> int:
            parts.append(np.asarray(a, dtype=np.int64).reshape(-1))
            return len(parts) - 1

        index = []
        slot = self._slot
        for level in self.plan.levels:
            ops, outw = level["boot_op"], level["boot_out"]
            in0, in1 = level["boot_in0"], level["boot_in1"]
            xm = np.isin(ops, (int(Op.XOR), int(Op.XNOR)))
            if self.xor_mode != "compound":
                xm[:] = False
            groups = []
            for compound, m in ((True, xm), (False, ~xm)):
                if not m.any():
                    continue
                gids = [GATE_INDEX[_OP_TO_GATE[Op(int(o))]] for o in ops[m]]
                groups.append(dict(
                    compound=compound, ops=ops[m], outw=outw[m],
                    s0=put(slot[in0[m]]), s1=put(slot[in1[m]]), so=put(slot[outw[m]]),
                    wo=put(outw[m]), gids=put(gids), opsv=put(ops[m]),
                    xnor=put(ops[m] == int(Op.XNOR)),
                ))
            segments = []
            lops, lin0, lout = level["lin_op"], level["lin_in0"], level["lin_out"]
            k, G = 0, len(lops)
            while k < G:
                j = k + 1
                while j < G and int(lops[j]) == int(lops[k]):
                    j += 1
                segments.append((int(lops[k]), put(slot[lin0[k:j]]), put(slot[lout[k:j]])))
                k = j
            index.append((groups, segments))
        flat = torch.from_numpy(np.concatenate(parts) if parts else np.zeros(0, np.int64))
        views = torch.split(flat.to(self.device), [len(a) for a in parts])
        for groups, segments in index:
            for g in groups:
                for key in ("s0", "s1", "so", "wo", "gids", "opsv", "xnor"):
                    g[key] = views[g[key]]
            segments[:] = [(o, views[i], views[j]) for o, i, j in segments]
        self._index = index
        return index

    def _count_level(self, level: dict) -> None:
        """Gate counts (circuit.cpp:722-749 parity)."""
        for o in level["boot_op"]:
            name = Op(int(o)).name
            self.gate_counts[name] = self.gate_counts.get(name, 0) + self._batch
        lops = level["lin_op"]
        for o in np.unique(lops):
            name = Op(int(o)).name
            cnt = int((lops == o).sum())
            self.gate_counts[name] = self.gate_counts.get(name, 0) + cnt * self._batch

    def _plain_level(self, level: dict) -> None:
        pa = self._plain_arena
        ops = level["boot_op"]
        if len(ops):
            in0, in1, outw = level["boot_in0"], level["boot_in1"], level["boot_out"]
            a = pa[:, in0].astype(np.int64)
            b = pa[:, in1].astype(np.int64)
            res = np.empty_like(a)
            for o in np.unique(ops):
                m = ops == o
                res[:, m] = _PLAIN_FN[int(o)](a[:, m], b[:, m])
            pa[:, outw] = res
        for o, i, w in zip(level["lin_op"], level["lin_in0"], level["lin_out"]):
            oo = int(o)
            if oo == int(Op.NOT):
                pa[:, w] = 1 - pa[:, i]
            elif oo == int(Op.EQW):
                pa[:, w] = pa[:, i]
            else:
                pa[:, w] = 1 if oo == int(Op.EQ1) else 0

    def _bootstrap(self, prep: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            boot.bootstrap_batch(prep[k:k + MAX_LANES], gids[k:k + MAX_LANES], self.keys)
            for k in range(0, prep.shape[0], MAX_LANES)
        ])

    def _run_group(self, grp: dict, plain_dev: Optional[torch.Tensor]) -> None:
        """One group's bootstraps, its check, and the scatter."""
        T, W = self._batch, len(grp["ops"])
        B = W * T
        q = self.params.q
        arena = self._ct_arena
        c1 = arena[grp["s0"]].reshape(B, -1)
        c2 = arena[grp["s1"]].reshape(B, -1)
        recover = self.recover_flag and not self.verify_flag
        gen = self._next_gen() if self._dev_branch and (self.verify_flag or recover) else None
        if grp["compound"]:
            # t1 = AND(a, !b), t2 = AND(!a, b) in one batch, then OR(t1, t2);
            # XNOR adds a linear NOT
            and_ids = torch.full((2 * B,), GATE_INDEX[BinGate.AND], device=self.device)
            both = self._bootstrap(
                boot.prepare_gates(
                    torch.cat([c1, lwe.eval_not_batch(c1, q)]),
                    torch.cat([lwe.eval_not_batch(c2, q), c2]), and_ids, q,
                ),
                and_ids,
            )
            or_ids = torch.full((B,), GATE_INDEX[BinGate.OR], device=self.device)
            out = self._bootstrap(boot.prepare_gates(both[:B], both[B:], or_ids, q), or_ids)
            self._bootstraps_run += 3 * B
            xnor = grp["xnor"].repeat_interleave(T).bool()[:, None]
            out = torch.where(xnor, lwe.eval_not_batch(out, q), out)
            self.gate_counts["XOR_BOOTSTRAPS"] = (
                self.gate_counts.get("XOR_BOOTSTRAPS", 0) + 3 * T * W
            )
        else:
            gids = grp["gids"].repeat_interleave(T)
            prep = boot.prepare_gates(c1, c2, gids, q)
            if self._dev_branch and recover:
                prep = self._repair_prep_dev(grp, prep, gids, gen)
            out = self._bootstrap(prep, gids)
            self._bootstraps_run += B
        out = out.reshape(W, T, -1)
        if self.verify_flag:
            out = (self._verify_fix_dev(grp, out, plain_dev, gen) if self._dev_branch
                   else self._verify_fix(grp["ops"], grp["outw"], out))
        elif self.recover_flag:
            out = (self._recover_fix_dev(grp, out, gen) if self._dev_branch
                   else self._recover_fix(grp["ops"], out))
        arena[grp["so"]] = out

    # -- the host branch's checks (the parity anchor) -------------------------
    def _verify_fix(self, ops, outw, out: torch.Tensor) -> torch.Tensor:
        """Per-level decrypt-compare-fix (gate.cpp:153-160 parity): the JAX
        package's host-branch semantics, with the decryption on the device."""
        T, W = self._batch, len(ops)
        want_np = self._plain_arena[:, outw].T.astype(np.int32)  # [W, T]
        got = lwe.decrypt_bits_dev(self._s_dev, out, self.params.q).cpu().numpy()
        bad = got != want_np
        if not np.any(bad):
            return out
        for o in np.unique(ops):
            name = Op(int(o)).name
            cnt = int(bad[ops == o].sum())
            self.bad_gate_counts[name] = self.bad_gate_counts.get(name, 0) + cnt
            if cnt:
                lvd = self.bad_gate_levels.setdefault(self._cur_level, {})
                lvd[name] = lvd.get(name, 0) + cnt
            print(f"Bad {name} fixing")
        fixed = lwe.encrypt_bits(self.sk, want_np.reshape(-1), self._rng).reshape(W, T, -1)
        mask = torch.from_numpy(bad).to(out.device)[:, :, None]
        return torch.where(mask, torch.from_numpy(fixed).to(out.device), out)

    def _recover_fix(self, ops, out: torch.Tensor) -> torch.Tensor:
        """Output-side margin check of [W, T, n+1] outputs: suspects
        (|error| >= recover_threshold) are counted per op and, when there
        is any, all W*T lanes are re-encrypted from their decoded bits in
        one host call and the suspects take theirs."""
        q = self.params.q
        W, T = out.shape[0], self._batch
        bit_d, err_d = lwe.phase_margin_dev(self._s_dev, out.reshape(W * T, -1), q)
        bitn = bit_d.cpu().numpy().astype(np.int64)
        aerr = np.abs(err_d.cpu().numpy()).reshape(W, T)
        self.max_phase_err = max(self.max_phase_err, int(aerr.max()) if aerr.size else 0)
        suspect = aerr >= self.recover_threshold
        nhard = int((aerr >= q // 8).sum())
        if nhard:
            self.recover_counts["HARD"] = self.recover_counts.get("HARD", 0) + nhard
        if np.any(suspect):
            for o in np.unique(ops):
                cnt = int(suspect[ops == o].sum())
                if cnt:
                    name = Op(int(o)).name
                    self.recover_counts[name] = self.recover_counts.get(name, 0) + cnt
            fixed = lwe.encrypt_bits(self.sk, bitn, self._rng).reshape(W, T, -1)
            mask = torch.from_numpy(suspect).to(out.device)[:, :, None]
            out = torch.where(mask, torch.from_numpy(fixed).to(out.device), out)
        return out

    # -- the device branch's checks -----------------------------------------
    def _verify_fix_dev(self, grp: dict, out, plain_dev, gen) -> torch.Tensor:
        """Decrypt, compare with the plaintext arena, re-encrypt every lane
        and keep the fresh ciphertext where the bit was wrong; per-op and
        per-level counts add up on the device."""
        p = self.params
        W, T = out.shape[0], self._batch
        want = plain_dev[:, grp["wo"]].T  # [W, T]
        bad = lwe.decrypt_bits_dev(self._s_dev, out, p.q) != want
        fixed = lwe.encrypt_bits_dev(self._s_dev, want, gen, p).reshape(W, T, -1)
        per_op = bad.sum(1)
        self._bad_dev.index_add_(0, grp["opsv"], per_op)
        self._bad_lv_dev[self._cur_level].index_add_(0, grp["opsv"], per_op)
        return torch.where(bad[:, :, None], fixed, out)

    def _rec_acc(self):
        if self._rec_dev is None:
            self._rec_dev = torch.zeros((3, _N_OPS), dtype=torch.int64, device=self.device)
            self._rec_max = torch.zeros((), dtype=torch.int64, device=self.device)
        return self._rec_dev

    def _recover_fix_dev(self, grp: dict, out, gen) -> torch.Tensor:
        """The output-side margin check of _recover_fix on the device."""
        p = self.params
        W, T = out.shape[0], self._batch
        rec = self._rec_acc()
        bit, err = lwe.phase_margin_dev(self._s_dev, out, p.q)
        aerr = err.abs().to(torch.int64)
        suspect = aerr >= self.recover_threshold
        fixed = lwe.encrypt_bits_dev(self._s_dev, bit, gen, p).reshape(W, T, -1)
        rec[0].index_add_(0, grp["opsv"], suspect.sum(1))
        rec[1].index_add_(0, grp["opsv"], (aerr >= p.q // 8).sum(1))
        self._rec_max = torch.maximum(self._rec_max, aerr.max())
        return torch.where(suspect[:, :, None], fixed, out)

    def _repair_prep_dev(self, grp: dict, prep, gids, gen) -> torch.Tensor:
        """The input-side check of the JAX package's fused level program:
        each prep phase is snapped to its quarter of q; a prep whose error
        reaches q/8 (XOR/XNOR, whose windows are q/4 wide) or q/16 (the
        others) is re-encrypted from that quarter before its bootstrap."""
        p = self.params
        q = p.q
        phase = lwe.phase_dev(self._s_dev, prep, q)
        quarter = ((phase + q // 8) // (q // 4)) % 4
        err = (phase + q // 8) % (q // 4) - q // 8
        thr = torch.where((gids == 4) | (gids == 5), q // 8, q // 16)
        suspect = err.abs() >= thr
        fixed = lwe.encrypt_bits_dev(self._s_dev, quarter, gen, p)
        self._rec_acc()[2].index_add_(
            0, grp["opsv"].repeat_interleave(self._batch), suspect.to(torch.int64)
        )
        return torch.where(suspect[:, None], fixed, prep)

    def _flush_bad_dev(self) -> None:
        """Fetch the device verify counts (one small copy) into
        bad_gate_levels and bad_gate_counts, with their lines."""
        if self._bad_lv_dev is not None:
            lv_counts = self._bad_lv_dev.cpu().numpy()
            self._bad_lv_dev = None
            for lv, o in zip(*np.nonzero(lv_counts)):
                d = self.bad_gate_levels.setdefault(int(lv), {})
                name = Op(int(o)).name
                d[name] = d.get(name, 0) + int(lv_counts[lv, o])
        if self.bad_gate_levels:
            print(f"bad gates by level: {self.bad_gate_levels}")
        if self._bad_dev is None:
            return
        counts = self._bad_dev.cpu().numpy()
        self._bad_dev = None
        for o in np.nonzero(counts)[0]:
            name = Op(int(o)).name
            self.bad_gate_counts[name] = self.bad_gate_counts.get(name, 0) + int(counts[o])
            print(f"Bad {name} fixing (x{int(counts[o])})")

    def _flush_rec_dev(self) -> None:
        """Fetch the device recovery counts and worst margin (one small
        copy each) into recover_counts and max_phase_err."""
        if self._rec_dev is None:
            return
        cnts = self._rec_dev.cpu().numpy()
        self.max_phase_err = max(self.max_phase_err, int(self._rec_max.cpu()))
        self._rec_dev = self._rec_max = None
        for o in np.nonzero(cnts[0])[0]:
            name = Op(int(o)).name
            self.recover_counts[name] = self.recover_counts.get(name, 0) + int(cnts[0, o])
        nhard = int(cnts[1].sum())
        if nhard:
            self.recover_counts["HARD"] = self.recover_counts.get("HARD", 0) + nhard
        for o in np.nonzero(cnts[2])[0]:
            name = f"IN_{Op(int(o)).name}"
            self.recover_counts[name] = self.recover_counts.get(name, 0) + int(cnts[2, o])
        if self.recover_counts:
            print(f"recovery: re-encrypted {self.recover_counts}")

    def _run_linear_encrypted(self, segments) -> None:
        q = self.params.q
        arena = self._ct_arena
        for o, idx_in, idx_out in segments:
            if o == int(Op.NOT):
                vals = lwe.eval_not_batch(arena[idx_in], q)
            elif o == int(Op.EQW):
                vals = arena[idx_in]
            else:
                vals = torch.zeros(
                    (idx_out.shape[0], self._batch, self.params.n + 1), dtype=torch.int32,
                    device=self.device,
                )
                vals[..., -1] = (q // 4) if o == int(Op.EQ1) else 0
            arena[idx_out] = vals

    # -- outputs ------------------------------------------------------------
    def _collect_outputs(self) -> None:
        nl = self.netlist
        outs = []
        for wires in nl.outputs:
            if self.encrypted_flag:
                cts = self._ct_arena[torch.from_numpy(self._slot[wires]).to(self.device)]
                bits = lwe.decrypt_bits_dev(self._s_dev, cts, self.params.q).cpu().numpy()
                outs.append(bits.T)  # [T, bits]
                if self.verify_flag:
                    bad = int((bits.T != self._plain_arena[:, wires]).sum())
                    if bad:
                        self.bad_gate_counts["OUTPUT"] = (
                            self.bad_gate_counts.get("OUTPUT", 0) + bad
                        )
                        print(f"Bad OUTPUT {bad}")
            elif self.plaintext_flag:
                outs.append(self._plain_arena[:, wires].astype(np.int32))
        self.circuit_output = outs

    def GetOutput(self) -> List[np.ndarray]:
        """Output bit arrays, one [T, bits] per output word."""
        return self.circuit_output

    # -- dumps (circuit.cpp:844-873 parity) ---------------------------------
    def dumpNetList(self) -> None:
        """One line per wire: its id and the gates it feeds (``g<k>`` by
        file order), after a header line."""
        nl = self.netlist
        print("Netlist ")
        print(f"# {nl.name}: {nl.n_wires} wires, {nl.n_gates} gates, "
              f"inputs {nl.input_bits} bits, outputs {nl.output_bits} bits")
        fan: Dict[int, List[int]] = {}
        for k in range(nl.n_gates):
            fan.setdefault(int(nl.in0[k]), []).append(k)
            if nl.in1[k] != nl.in0[k]:
                fan.setdefault(int(nl.in1[k]), []).append(k)
        for w in sorted(fan):
            print(f"w{w} " + " ".join(f"g{k}" for k in fan[w]))

    def dumpGates(self) -> None:
        nl = self.netlist
        for k in range(nl.n_gates):
            print(
                f"  {Op(int(nl.op[k])).name} w{int(nl.in0[k])}, w{int(nl.in1[k])}"
                f" -> w{int(nl.out[k])}"
            )

    def dumpGateCount(self) -> None:
        for name, cnt in sorted(self.gate_counts.items()):
            print(f"  {name}: {cnt}")
        if self.bad_gate_counts:
            print(f"  bad gates fixed: {self.bad_gate_counts}")
