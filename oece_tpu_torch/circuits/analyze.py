"""Circuit analysis: op counts, wire lifetimes, fan statistics.

Parity with ``analyze_bristol`` (src/analyze.cpp:56-394): parses a Bristol
file (both fashions), counts ops, computes per-wire first/last use
(low/high-water, analyze.cpp:285-298), lifetimes (365-367) and optional
fan-in/fan-out statistics (309-351) — but in O(G) with integer arrays
instead of the reference's O(V*G) scans.

The port's own copy of ``oece_tpu.circuits.analyze``, kept in step with it
(tests/test_torch_harness.py): the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .bristol import parse_bristol
from .netlist import Netlist, Op, levelize


@dataclasses.dataclass
class Analysis:
    """Parity container for the reference's Analysis struct (analyze.h:41-83)."""

    netlist: Netlist
    op_counts: dict
    first_use: np.ndarray  # low-water per wire (gate index, -1 if unused)
    last_use: np.ndarray   # high-water per wire
    max_lifetime: int
    max_fan_in: int
    max_fan_out: int
    fan_out: Optional[np.ndarray] = None

    def report(self) -> str:
        nl = self.netlist
        lines = [
            f"circuit {nl.name}: {nl.n_gates} gates, {nl.n_wires} wires",
            f"  inputs {nl.input_bits} outputs {nl.output_bits}",
            f"  op counts: {self.op_counts}",
            f"  max fan-in {self.max_fan_in}, max fan-out {self.max_fan_out}",
            f"  max node lifetime {self.max_lifetime}",
        ]
        plan = levelize(nl)
        s = plan.stats()
        lines.append(
            f"  ASAP depth {s['depth']}, bootstrap gates {s['bootstrap_gates']}, "
            f"max/mean level width {s['max_level_width']}/{s['mean_level_width']:.1f}"
        )
        return "\n".join(lines)


def analyze(nl_or_path, gen_fan: bool = False) -> Analysis:
    """analyze_bristol parity (analyze.h:86-87): stats for a circuit."""
    nl = nl_or_path if isinstance(nl_or_path, Netlist) else parse_bristol(nl_or_path)
    G = nl.n_gates
    first = np.full(nl.n_wires, -1, dtype=np.int64)
    last = np.full(nl.n_wires, -1, dtype=np.int64)
    # vectorized first/last over in0, in1, out
    for arr in (nl.in0, nl.in1, nl.out):
        order = np.arange(G)
        np.maximum.at(last, arr, order)
        rev_first = np.full(nl.n_wires, G, dtype=np.int64)
        np.minimum.at(rev_first, arr, order)
        m = rev_first < G
        first[m] = np.where(first[m] < 0, rev_first[m], np.minimum(first[m], rev_first[m]))

    lifetime = np.where((first >= 0) & (last >= 0), last - first, 0)
    fan_out = np.zeros(nl.n_wires, dtype=np.int64)
    np.add.at(fan_out, nl.in0, 1)
    two_in = np.isin(nl.op, [int(o) for o in (Op.AND, Op.OR, Op.NAND, Op.NOR, Op.XOR, Op.XNOR)])
    np.add.at(fan_out, nl.in1[two_in], 1)
    max_fan_in = 2 if np.any(two_in) else 1
    return Analysis(
        netlist=nl,
        op_counts=nl.op_counts(),
        first_use=first,
        last_use=last,
        max_lifetime=int(lifetime.max()) if G else 0,
        max_fan_in=max_fan_in,
        max_fan_out=int(fan_out.max()) if G else 0,
        fan_out=fan_out if gen_fan else None,
    )


def assemble(analysis: Analysis, out_path: Optional[str] = None,
             reuse_registers: bool = False, debug: bool = False) -> str:
    """assemble_bristol parity (assemble.h:43-44): write the ``.out``
    register program for a previously analyzed circuit.  The default output
    name appends ``_FHE.out`` like assemble.cpp:96-100."""
    from .asm import emit_asm

    text = emit_asm(analysis.netlist, reuse_registers=reuse_registers)
    if out_path is None:
        out_path = analysis.netlist.name + "_FHE.out"
    with open(out_path, "w") as f:
        f.write(text)
    if debug:
        print(f"# wrote {out_path} ({len(text.splitlines())} lines)")
    return out_path
