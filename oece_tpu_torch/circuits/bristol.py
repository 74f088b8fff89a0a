"""Bristol-format circuit parsers (old and new fashion).

Functional parity with the reference analyzer's parsing
(``analyze_bristol``, src/analyze.cpp:56-299):

* old format (src/analyze.cpp:159-180): header ``ngates nwires`` /
  ``n_in1 n_in2 n_out1`` / blank; ops XOR, AND, INV, EQ, EQW.
* new format (src/analyze.cpp:129-157): header ``ngates nwires`` /
  ``n_inputs <bits...>`` / ``n_outputs <bits...>`` / blank; same ops, plus
  MAND which the reference assembler rejects ("not updated for the new
  format", assemble.cpp:88-90) but which is DECOMPOSED here into its
  component ANDs so the SIMD-Bristol corpus loads whole.

Documented divergences from the reference analyzer:
  * ``EQ`` (constant-0/1 assignment) aborts the reference with "Cannot
    parse EQ!! yet failing" (analyze.cpp:273-277); here it parses into the
    Op.EQ0/Op.EQ1 constant ops the evaluator handles natively.
  * ``MAND`` (see above) is decomposed instead of rejected.

Unlike the reference, parsing is O(G) into integer arrays (no string keys).
Wire conventions (Bristol fashion): inputs occupy the lowest wire ids in
declaration order; outputs are the *last* wires in declaration order.

The port's own copy of ``oece_tpu.circuits.bristol``, kept in step with it
(tests/test_torch_copies.py): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .netlist import Netlist, Op

_OP_MAP = {
    "XOR": Op.XOR,
    "AND": Op.AND,
    "OR": Op.OR,
    "INV": Op.NOT,
    "NOT": Op.NOT,
    "EQW": Op.EQW,
    "NAND": Op.NAND,
    "NOR": Op.NOR,
    "XNOR": Op.XNOR,
}


def _detect_new_format(line2: List[str], line3: List[str]) -> bool:
    """New fashion iff line2 = 'niv <bits>*niv' (count then that many widths)
    and line3 declares outputs the same way."""
    if not line2:
        return False
    try:
        niv = int(line2[0])
    except ValueError:
        return False
    return len(line2) == niv + 1 and len(line3) >= 2


def parse_bristol(path: str, name: str | None = None, fmt: str = "auto") -> Netlist:
    """Parse either Bristol fashion; fmt in ('auto', 'old', 'new').

    Uses the native C++ parser (circuits/native.py) when it builds:
    bit-identical to this implementation (tests/test_torch_native.py).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(2, "no such circuit file", path)
    if fmt == "auto" and os.environ.get("OECE_NO_NATIVE", "0") != "1":
        try:
            from . import native as native_mod

            nl = native_mod.parse_bristol_native(path, name)
            if nl is not None:
                return nl
        except ValueError:
            raise
        except Exception:
            pass
    with open(path) as f:
        raw = [ln.strip() for ln in f]
    lines = [ln for ln in raw if ln]
    if len(lines) < 3:
        raise ValueError(f"{path}: not a Bristol file")
    hdr = lines[0].split()
    n_gates, n_wires = int(hdr[0]), int(hdr[1])
    l2 = lines[1].split()
    l3 = lines[2].split()

    is_new = fmt == "new" or (fmt == "auto" and _detect_new_format(l2, l3))
    if is_new:
        in_bits = [int(x) for x in l2[1:]]
        out_bits = [int(x) for x in l3[1 : 1 + int(l3[0])]]
        gate_lines = lines[3:]
    else:
        # old fashion: line2 = "n_in1 n_in2 n_out1"; gate lines follow
        vals = [int(x) for x in l2]
        if len(vals) == 2:
            vals.append(0)
        n_in1, n_in2, n_out1 = vals[0], vals[1], vals[2]
        in_bits = [b for b in (n_in1, n_in2) if b > 0]
        out_bits = [n_out1]
        gate_lines = lines[2:]

    ops: List[int] = []
    in0: List[int] = []
    in1: List[int] = []
    out: List[int] = []

    k = 0  # header gate-line count (a MAND line is ONE gate)
    for ln in gate_lines:
        if k >= n_gates:
            break
        parts = ln.split()
        opname = parts[-1]
        n_in, n_out = int(parts[0]), int(parts[1])
        wires = [int(x) for x in parts[2 : 2 + n_in + n_out]]
        if opname == "MAND":
            # new-fashion multi-AND: out[j] = AND(in[j], in[n_out+j]);
            # decomposed into native ANDs (the reference assembler rejects
            # MAND, assemble.cpp:88-90 — here it is supported).
            if n_in != 2 * n_out:
                raise ValueError(f"{path}: MAND arity mismatch: {ln!r}")
            for j in range(n_out):
                ops.append(int(Op.AND))
                in0.append(wires[j])
                in1.append(wires[n_out + j])
                out.append(wires[n_in + j])
        elif opname == "EQ":
            # constant assignment: input token is the constant 0/1
            const = wires[0]
            ops.append(int(Op.EQ1 if const else Op.EQ0))
            in0.append(0)
            in1.append(0)
            out.append(wires[n_in])
        else:
            op = _OP_MAP.get(opname)
            if op is None:
                raise ValueError(f"{path}: unknown op {opname!r}")
            ops.append(int(op))
            in0.append(wires[0])
            in1.append(wires[1] if n_in > 1 else wires[0])
            out.append(wires[n_in])
        k += 1
    if k != n_gates:
        raise ValueError(f"{path}: expected {n_gates} gates, found {k}")
    ops = np.array(ops, dtype=np.int32)
    in0 = np.array(in0, dtype=np.int32)
    in1 = np.array(in1, dtype=np.int32)
    out = np.array(out, dtype=np.int32)

    inputs = []
    off = 0
    for b in in_bits:
        inputs.append(np.arange(off, off + b, dtype=np.int32))
        off += b
    outputs = []
    total_out = sum(out_bits)
    off = n_wires - total_out
    for b in out_bits:
        outputs.append(np.arange(off, off + b, dtype=np.int32))
        off += b

    nl = Netlist(
        name=name or os.path.splitext(os.path.basename(path))[0],
        n_wires=n_wires,
        inputs=inputs,
        outputs=outputs,
        op=ops,
        in0=in0,
        in1=in1,
        out=out,
    )
    return nl


_EMIT_NAMES = {
    int(Op.XOR): "XOR",
    int(Op.AND): "AND",
    int(Op.OR): "OR",
    int(Op.NOT): "INV",
    int(Op.EQW): "EQW",
    int(Op.NAND): "NAND",
    int(Op.NOR): "NOR",
    int(Op.XNOR): "XNOR",
}


def emit_bristol(nl: Netlist, fmt: str = "new") -> str:
    """Emit a Netlist as a Bristol-fashion circuit file (old or new header).

    The reference only *reads* Bristol files; emission makes generated
    netlists (circuits/gen.py) interchangeable with the reference corpus.
    Wires are renumbered to the Bristol convention: inputs are the lowest
    ids in declaration order, outputs the highest.  EQW copies are appended
    when an output slot aliases an input wire or repeats another output.
    Ops beyond the reference's old-fashion set (XOR/AND/INV/EQ/EQW) are
    emitted with their natural names (OR/NAND/...), which parse_bristol
    accepts.
    """
    if nl.n_dff:
        raise ValueError("sequential (DFF) netlists have no Bristol form")
    out_flat = [int(w) for word in nl.outputs for w in word]
    n_out = len(out_flat)

    input_id: dict[int, int] = {}
    nxt = 0
    for word in nl.inputs:
        for w in word:
            input_id[int(w)] = nxt
            nxt += 1

    # the first output slot of each gate-produced output wire is written
    # directly by its producing gate; aliases/duplicates get EQW copies.
    prod_slot: dict[int, int] = {}
    copy_slots: List[int] = []
    for i, w in enumerate(out_flat):
        if w not in input_id and w not in prod_slot:
            prod_slot[w] = i
        else:
            copy_slots.append(i)

    internal_ids: dict[int, int] = {}
    for w in nl.out:
        w = int(w)
        if w not in prod_slot:
            internal_ids[w] = nxt
            nxt += 1
    out_base = nxt

    def src(w: int) -> int:
        if w in input_id:
            return input_id[w]
        if w in internal_ids:
            return internal_ids[w]
        return out_base + prod_slot[w]

    lines: List[str] = []
    for o, a, b, w in zip(nl.op, nl.in0, nl.in1, nl.out):
        o, a, b, w = int(o), int(a), int(b), int(w)
        dst = out_base + prod_slot[w] if w in prod_slot else internal_ids[w]
        if o in (int(Op.EQ0), int(Op.EQ1)):
            lines.append(f"1 1 {1 if o == int(Op.EQ1) else 0} {dst} EQ")
        elif o in (int(Op.NOT), int(Op.EQW)):
            lines.append(f"1 1 {src(a)} {dst} {_EMIT_NAMES[o]}")
        else:
            lines.append(f"2 1 {src(a)} {src(b)} {dst} {_EMIT_NAMES[o]}")
    for i in copy_slots:
        lines.append(f"1 1 {src(out_flat[i])} {out_base + i} EQW")

    n_wires_total = out_base + n_out
    hdr = [f"{len(lines)} {n_wires_total}"]
    if fmt == "new":
        hdr.append(str(len(nl.inputs)) + " " + " ".join(str(b) for b in nl.input_bits))
        hdr.append(str(len(nl.outputs)) + " " + " ".join(str(b) for b in nl.output_bits))
    else:
        ib = nl.input_bits
        hdr.append(
            f"{ib[0] if ib else 0} {ib[1] if len(ib) > 1 else 0} "
            f"{nl.output_bits[0] if nl.outputs else 0}"
        )
    return "\n".join(hdr) + "\n\n" + "\n".join(lines) + "\n"
