"""The circuit evaluator on torch (counterpart of oece_tpu.runtime.evaluator).

API parity with the reference ``Circuit`` (src/circuit.h:54-72): ReadFile,
LoadNetlist, Reset, SetInput, Clock, setPlaintext, setEncrypted, setVerify,
GetOutput, dumpGates, dumpGateCount.  The engine is the JAX package's level
schedule: per level, every bootstrap gate of every test case runs as one
batch (fhe/boot.py), linear gates run as arena ops, and in verify mode each
level's outputs are decrypted, compared with the plaintext arena, counted
and repaired by fresh host encryptions.

Randomness follows the JAX package's CPU path exactly: ``self._rng`` draws
the 8 keygen seed words, then one ``encrypt_bits`` call per input word in
SetInput, then one call covering all W*T lanes of a level whenever any
lane of that level needs a verify repair.  Given the same keys and
generator state, a run reproduces the JAX package's ciphertexts bit for bit.

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
item): the generic-base AP method (B_r != 2), setRecovery(True) and the
automatic recovery of pure-encrypted runs, xor_mode="compound", circuits
with DFF state, device meshes (``mesh=``, ``setMesh``), checkpointing
(``Clock(checkpoint_path=...)``) and the ``OECE_BAD_TRACE=1`` lane trace of
verify runs.  A pure-encrypted Clock() (encrypted without verify)
therefore raises unless recovery is off: after setRecovery(False), or with
``OECE_AUTO_RECOVER`` set to anything but "1", the JAX package's own
recovery-off configurations.  ``generate_keys=False`` skips key
generation, as in the JAX package (plaintext work, or keys injected with
``keys``/``sk``).
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
    host encryption).
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
        if xor_mode != "native":
            raise _not_ported(f"xor_mode={xor_mode!r}", "compound XOR")
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
        self._recovery_off = False
        self._batch = 1
        self.circuit_output: List[np.ndarray] = []
        self.gate_counts: Dict[str, int] = {}
        self.bad_gate_counts: Dict[str, int] = {}
        self.bad_gate_levels: Dict[int, Dict[str, int]] = {}
        self.trace: Optional[Trace] = None
        self._done = False

    # -- file loading -------------------------------------------------------
    def ReadFile(self, fname: str) -> None:
        if fname.endswith(".out"):
            nl = asm_mod.parse_asm(fname)
        else:
            nl = bristol_mod.parse_bristol(fname)
        self.LoadNetlist(nl)

    def LoadNetlist(self, nl: Netlist) -> None:
        if nl.n_dff:
            raise _not_ported("a circuit with DFF state", "DFF state")
        self.netlist = nl
        self.plan = levelize(nl)
        self._slot, self._n_ct_slots = assign_ct_slots(nl, self.plan)
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
        """Only setRecovery(False) is supported: pure-encrypted runs then go
        without recovery, as the JAX package's recovery-off runs do."""
        if flag:
            raise _not_ported("setRecovery(True)", "recovery")
        self._recovery_off = True

    def setMesh(self, mesh) -> None:
        """Only ``setMesh(None)`` (no mesh) is supported."""
        if mesh is not None:
            raise _not_ported("setMesh", "item 10, the mesh")

    def Reset(self) -> None:
        self._plain_arena: Optional[np.ndarray] = None
        self._ct_arena: Optional[torch.Tensor] = None
        self.circuit_output = []
        self.gate_counts = {}
        self.bad_gate_counts = {}
        self.bad_gate_levels = {}
        self._done = False
        self._cur_level = 0
        self._bootstraps_run = 0
        self.trace = None

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
        if self.encrypted_flag:
            if self.sk is None:
                raise RuntimeError("no keys")
            p = self.params
            arena = np.zeros((self._n_ct_slots + 1, T, p.n + 1), dtype=np.int32)
            for wd, wires in zip(words, nl.inputs):
                cts = lwe.encrypt_bits(self.sk, wd.reshape(-1), self._rng)
                arena[self._slot[wires]] = cts.reshape(T, len(wires), p.n + 1).transpose(1, 0, 2)
            self._ct_arena = torch.from_numpy(arena).to(self.device)

    # -- the engine ---------------------------------------------------------
    def Clock(
        self,
        verbose: bool = False,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
    ) -> None:
        """Evaluate the whole circuit; ``checkpoint_every`` is read only
        with a ``checkpoint_path``, which is not ported."""
        if self.plan is None:
            raise RuntimeError("ReadFile first")
        if self._done:
            raise RuntimeError("Circuit already evaluated; call Reset")
        if checkpoint_path is not None:
            raise _not_ported("Clock(checkpoint_path=...)", "item 7, checkpointing")
        if self.verify_flag and os.environ.get("OECE_BAD_TRACE", "0") == "1":
            raise _not_ported("OECE_BAD_TRACE=1", "item 8, OECE_BAD_TRACE lanes")
        if (self.encrypted_flag and not self.verify_flag and not self._recovery_off
                and os.environ.get("OECE_AUTO_RECOVER", "1") == "1"):
            raise _not_ported(
                "pure-encrypted mode with automatic recovery (call "
                "setVerify(True), or setRecovery(False) or set "
                "OECE_AUTO_RECOVER=0 to run without it)",
                "recovery",
            )
        mode = (
            "verify" if self.verify_flag
            else "encrypted" if self.encrypted_flag else "plaintext"
        )
        self.trace = Trace(circuit=self.netlist.name, mode=mode)
        self.trace.begin()
        on_cuda = self.device.type == "cuda"
        for lv, level in enumerate(self.plan.levels):
            t0 = time.time()
            self._cur_level = lv
            b0 = self._bootstraps_run
            self._run_level_boot(level)
            self._run_level_linear(level)
            if on_cuda and self.encrypted_flag:
                torch.cuda.synchronize(self.device)
            self.trace.add(LevelRecord(
                level=lv, boot_gates=len(level["boot_op"]),
                linear_gates=len(level["lin_op"]), batch=self._batch,
                wall_s=time.time() - t0, bootstraps=self._bootstraps_run - b0,
            ))
            if (self.verbose or verbose) and self.plan.depth > 1:
                print(
                    f"\rProcessing level {lv + 1} of {self.plan.depth}",
                    end="" if lv + 1 < self.plan.depth else "\n", flush=True,
                )
        if self.bad_gate_levels:
            print(f"bad gates by level: {self.bad_gate_levels}")
        self._collect_outputs()
        self.trace.end()
        self._done = True

    def _run_level_boot(self, level: dict) -> None:
        ops = level["boot_op"]
        if len(ops) == 0:
            return
        in0, in1, outw = level["boot_in0"], level["boot_in1"], level["boot_out"]
        for o in ops:
            name = Op(int(o)).name
            self.gate_counts[name] = self.gate_counts.get(name, 0) + self._batch
        if self.plaintext_flag:
            pa = self._plain_arena
            a = pa[:, in0].astype(np.int64)
            b = pa[:, in1].astype(np.int64)
            res = np.empty_like(a)
            for o in np.unique(ops):
                m = ops == o
                res[:, m] = _PLAIN_FN[int(o)](a[:, m], b[:, m])
            pa[:, outw] = res
        if self.encrypted_flag:
            self._run_level_boot_encrypted(ops, in0, in1, outw)

    def _run_level_boot_encrypted(self, ops, in0, in1, outw) -> None:
        T, W = self._batch, len(ops)
        B = W * T
        gate_ids = np.array([GATE_INDEX[_OP_TO_GATE[Op(int(o))]] for o in ops])
        dev = self.device
        arena = self._ct_arena
        c1 = arena[torch.from_numpy(self._slot[in0]).to(dev)].reshape(B, -1)
        c2 = arena[torch.from_numpy(self._slot[in1]).to(dev)].reshape(B, -1)
        gids = torch.from_numpy(np.repeat(gate_ids, T)).to(dev)
        out = torch.cat([
            boot.eval_bin_gate_batch(
                self.keys, gids[k:k + MAX_LANES], c1[k:k + MAX_LANES], c2[k:k + MAX_LANES]
            )
            for k in range(0, B, MAX_LANES)
        ])
        self._bootstraps_run += B
        out = out.reshape(W, T, -1)
        if self.verify_flag:
            out = self._verify_fix(ops, outw, out)
        arena[torch.from_numpy(self._slot[outw]).to(dev)] = out

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

    def _run_level_linear(self, level: dict) -> None:
        ops, in0, outw = level["lin_op"], level["lin_in0"], level["lin_out"]
        if len(ops) == 0:
            return
        q = self.params.q
        for o in np.unique(ops):
            name = Op(int(o)).name
            cnt = int((ops == o).sum())
            self.gate_counts[name] = self.gate_counts.get(name, 0) + cnt * self._batch
        if self.plaintext_flag:
            pa = self._plain_arena
            for o, i, w in zip(ops, in0, outw):
                oo = int(o)
                if oo == int(Op.NOT):
                    pa[:, w] = 1 - pa[:, i]
                elif oo == int(Op.EQW):
                    pa[:, w] = pa[:, i]
                else:
                    pa[:, w] = 1 if oo == int(Op.EQ1) else 0
        if self.encrypted_flag:
            # runs of one op: rank order makes each run's inputs final
            arena = self._ct_arena
            k, G = 0, len(ops)
            while k < G:
                o = int(ops[k])
                j = k + 1
                while j < G and int(ops[j]) == o:
                    j += 1
                idx_in = torch.from_numpy(self._slot[in0[k:j]]).to(self.device)
                idx_out = torch.from_numpy(self._slot[outw[k:j]]).to(self.device)
                if o == int(Op.NOT):
                    vals = lwe.eval_not_batch(arena[idx_in], q)
                elif o == int(Op.EQW):
                    vals = arena[idx_in]
                else:
                    vals = torch.zeros(
                        (j - k, self._batch, self.params.n + 1), dtype=torch.int32,
                        device=self.device,
                    )
                    vals[..., -1] = (q // 4) if o == int(Op.EQ1) else 0
                arena[idx_out] = vals
                k = j

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
