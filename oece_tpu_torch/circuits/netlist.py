"""Netlist IR: integer-indexed struct-of-arrays gate lists.

The TPU-first replacement for the reference's string-keyed dynamic structures
(``NetList = std::map<std::string, GateNameList>``, circuit.h:52, built by an
O(G^2) scan at circuit.cpp:323-354): wires are dense integer ids, gates are
flat int32 arrays, and fanout/levels are computed in O(G).

The port's own copy of ``oece_tpu.circuits.netlist``, kept in step with it
(tests/test_torch_copies.py): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

import numpy as np


class Op(enum.IntEnum):
    """Gate opcodes.  Superset of the reference's GateEnum (gate.h:51) and of
    Bristol ops (analyze.cpp:264-283): XOR/AND/INV(=NOT)/EQ/EQW plus the
    extended bootstrappable set."""

    AND = 0
    OR = 1
    NAND = 2
    NOR = 3
    XOR = 4
    XNOR = 5
    NOT = 6
    EQW = 7   # wire copy (new-Bristol EQW)
    EQ0 = 8   # constant 0 (new-Bristol EQ with operand 0)
    EQ1 = 9   # constant 1
    LUT3 = 10  # reserved (reference stub, gate.cpp:217-225)
    LUT4 = 11  # reserved
    DFF = 12   # reserved


# ops whose encrypted evaluation is one bootstrap
BOOTSTRAP_OPS = (Op.AND, Op.OR, Op.NAND, Op.NOR, Op.XOR, Op.XNOR)
# ops that are linear (no bootstrap) under FHEW
LINEAR_OPS = (Op.NOT, Op.EQW, Op.EQ0, Op.EQ1)

TWO_INPUT_OPS = set(BOOTSTRAP_OPS)


@dataclasses.dataclass
class Netlist:
    """A parsed boolean circuit.

    gates are (op, in0, in1, out) int32 rows in topological (file) order; for
    1-input ops in1 == in0; for 0-input (EQ const) both are 0 and ignored.
    """

    name: str
    n_wires: int
    inputs: List[np.ndarray]   # wire ids per declared input word
    outputs: List[np.ndarray]  # wire ids per declared output word
    op: np.ndarray             # [G] int32 (Op)
    in0: np.ndarray            # [G] int32
    in1: np.ndarray            # [G] int32
    out: np.ndarray            # [G] int32
    # Sequential state (the reference's unimplemented DFF, gate.cpp:217-225):
    # flip-flop k holds state on wire dff_q[k]; each Clock() cycle latches
    # dff_d[k] into it.  Q wires read as 0 on the first cycle after Reset.
    dff_d: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=np.int32)
    )
    dff_q: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=np.int32)
    )

    @property
    def n_gates(self) -> int:
        return int(self.op.shape[0])

    @property
    def n_dff(self) -> int:
        return int(self.dff_q.shape[0])

    @property
    def input_bits(self) -> List[int]:
        return [len(w) for w in self.inputs]

    @property
    def output_bits(self) -> List[int]:
        return [len(w) for w in self.outputs]

    def op_counts(self) -> dict:
        """Gate-type histogram (dumpGateCount parity, circuit.cpp:866-873)."""
        vals, counts = np.unique(self.op, return_counts=True)
        return {Op(int(v)).name: int(c) for v, c in zip(vals, counts)}

    def validate(self) -> None:
        G = self.n_gates
        assert self.in0.shape == (G,) and self.in1.shape == (G,) and self.out.shape == (G,)
        assert np.all(self.out < self.n_wires)
        produced = np.zeros(self.n_wires, dtype=bool)
        for word in self.inputs:
            produced[word] = True
        produced[self.dff_q] = True  # state wires are readable from cycle 0
        # every gate input must be produced by an earlier gate or an input
        order = np.argsort(np.arange(G))  # file order
        for k in order:
            o = Op(int(self.op[k]))
            if o not in (Op.EQ0, Op.EQ1):
                assert produced[self.in0[k]], f"gate {k} reads unset wire {self.in0[k]}"
                if o in TWO_INPUT_OPS:
                    assert produced[self.in1[k]], f"gate {k} reads unset wire {self.in1[k]}"
            produced[self.out[k]] = True
        for word in self.outputs:
            assert np.all(produced[word])
        assert np.all(produced[self.dff_d]), "DFF D input never produced"


@dataclasses.dataclass
class LevelPlan:
    """Static ASAP schedule: the dataflow scheduler of the reference
    (``_CircuitManager``, circuit.cpp:575-683) collapsed into a precomputed
    list of levels; every gate in a level is independent and batches into one
    device call.

    Per level: boot_* arrays (bootstrappable gates) and lin_* arrays (linear
    gates, evaluated without bootstraps in the same level).
    """

    n_wires: int
    levels: List[dict]  # {boot_op, boot_in0, boot_in1, boot_out, lin_op, ...}

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def max_width(self) -> int:
        return max((len(l["boot_op"]) for l in self.levels), default=0)

    def stats(self) -> dict:
        bw = [len(l["boot_op"]) for l in self.levels]
        lw = [len(l["lin_op"]) for l in self.levels]
        return {
            "depth": self.depth,
            "bootstrap_gates": int(np.sum(bw)),
            "linear_gates": int(np.sum(lw)),
            "max_level_width": int(max(bw, default=0)),
            "mean_level_width": float(np.mean(bw)) if bw else 0.0,
        }


def assign_ct_slots(nl: Netlist, plan: "LevelPlan"):
    """Liveness-based ciphertext-arena slot assignment (VERDICT r4 #4).

    The encrypted arena is the dominant non-key HBM consumer: wire-indexed
    it holds n_wires x T x (n+1) int32 (sha256 at T=16: ~4.4 GB, OOM next
    to the ~8 GB resident keys).  But a wire is only *live* from the level
    that writes it to the last level that reads it, and the peak live set
    is a small fraction of n_wires (sha256: ~3% — see n_slots in the
    evaluator's verbose output).  This assigns each wire a reusable SLOT
    with a free-list, honoring the engine's execution order:

      * a slot freed by a wire last read at level L-1 is reusable for
        outputs of level >= L (never the same level: within a level,
        chunked dispatches write outputs before later chunks read inputs);
      * circuit outputs and DFF state wires are pinned live to the end;
      * dead gate outputs recycle one level after their write.

    Returns (slot int64 [n_wires] with -1 for never-materialized wires,
    n_slots).  The reference has no analogue — its wire values are
    per-gate heap ciphertexts freed by shared_ptr refcount (circuit.cpp's
    LweSample members); this is the same liveness idea done statically.
    """
    import heapq

    n_wires = nl.n_wires
    NEVER = np.iinfo(np.int64).max
    last_read = np.full(n_wires, -1, np.int64)
    no_read_lin = (int(Op.EQ0), int(Op.EQ1))
    for lv, level in enumerate(plan.levels):
        np.maximum.at(last_read, level["boot_in0"], lv)
        np.maximum.at(last_read, level["boot_in1"], lv)
        rd = level["lin_in0"][~np.isin(level["lin_op"], no_read_lin)]
        np.maximum.at(last_read, rd, lv)
    for word in nl.outputs:
        last_read[word] = NEVER
    last_read[nl.dff_d] = NEVER
    last_read[nl.dff_q] = NEVER

    slot = np.full(n_wires, -1, np.int64)
    free: List[int] = []  # min-heap: deterministic, dense reuse
    next_slot = 0
    release_at: dict = {}  # level -> wires whose slots free after it

    def alloc(w: int, lv: int) -> None:
        nonlocal next_slot
        if slot[w] >= 0:
            return
        if free:
            slot[w] = heapq.heappop(free)
        else:
            slot[w] = next_slot
            next_slot += 1
        lr = last_read[w]
        if lr != NEVER:
            release_at.setdefault(max(int(lr), lv), []).append(w)

    # wires written before Clock(): circuit inputs + DFF state
    for word in nl.inputs:
        for w in word:
            alloc(int(w), -1)
    for w in nl.dff_q:
        alloc(int(w), -1)
    for lv, level in enumerate(plan.levels):
        for w in release_at.pop(lv - 1, ()):
            heapq.heappush(free, int(slot[w]))
        for w in level["boot_out"]:
            alloc(int(w), lv)
        for w in level["lin_out"]:
            alloc(int(w), lv)
    return slot, next_slot


def levelize(nl: Netlist) -> LevelPlan:
    """ASAP levelization in O(G).

    A gate's level is 1 + max(level of producers of its inputs); input wires
    are level 0.  Linear gates (NOT/EQW/EQ) are *free* under FHEW, so they do
    not advance the level counter: chains of NOTs stay inside one level and
    are applied as a sequence of linear passes before the level's bootstrap
    batch.  Within a level, linear gates are kept in topological order.
    """
    G = nl.n_gates
    is_boot = np.isin(nl.op, [int(o) for o in BOOTSTRAP_OPS])

    native_res = None
    try:  # C++ fast path (bit-identical; tests/test_torch_native.py)
        from . import native as native_mod

        native_res = native_mod.levelize_native(nl)
    except Exception:
        native_res = None
    if native_res is not None:
        glevel, grank = native_res
    else:
        wire_level = np.zeros(nl.n_wires, dtype=np.int64)
        # rank: sub-order inside a level for linear chains; bootstrap
        # outputs are rank 0, each linear gate is max(input rank) + 1.
        wire_rank = np.zeros(nl.n_wires, dtype=np.int64)
        glevel = np.zeros(G, dtype=np.int64)
        grank = np.zeros(G, dtype=np.int64)
        for k in range(G):
            o = int(nl.op[k])
            if o in (int(Op.EQ0), int(Op.EQ1)):
                lv, rk = 0, 1
            elif is_boot[k]:
                lv = max(wire_level[nl.in0[k]], wire_level[nl.in1[k]]) + 1
                rk = 0
            else:  # NOT / EQW: free, stays in the producer's level
                lv = wire_level[nl.in0[k]]
                rk = wire_rank[nl.in0[k]] + 1
            glevel[k] = lv
            grank[k] = rk
            wire_level[nl.out[k]] = lv
            wire_rank[nl.out[k]] = rk

    n_levels = int(glevel.max()) + 1 if G else 0
    levels = []
    order = np.lexsort((grank, glevel))
    sorted_ops = nl.op[order]
    sorted_boot = is_boot[order]
    sorted_lv = glevel[order]
    bounds = np.searchsorted(sorted_lv, np.arange(n_levels + 1))
    for lv in range(n_levels):
        sel = order[bounds[lv] : bounds[lv + 1]]
        bsel = sel[sorted_boot[bounds[lv] : bounds[lv + 1]]]
        lsel = sel[~sorted_boot[bounds[lv] : bounds[lv + 1]]]
        levels.append(
            {
                "boot_op": nl.op[bsel].astype(np.int32),
                "boot_in0": nl.in0[bsel].astype(np.int32),
                "boot_in1": nl.in1[bsel].astype(np.int32),
                "boot_out": nl.out[bsel].astype(np.int32),
                "lin_op": nl.op[lsel].astype(np.int32),
                "lin_in0": nl.in0[lsel].astype(np.int32),
                "lin_out": nl.out[lsel].astype(np.int32),
            }
        )
    return LevelPlan(n_wires=nl.n_wires, levels=levels)
