"""The register-based ``.out`` assembler format: parse and emit.

Format parity with the reference (emitted by assemble.cpp:96-425, parsed by
Circuit::ReadFile circuit.cpp:102-366):

  * three machine-read header comment lines
      ``# number input1 bits N`` / ``# number input2 bits N`` /
      ``# number output1 bits N``             (adder_2bit.out:1-3)
  * program lines
      ``R<d> = LOAD(In<i>,<j>)``   1-based input word, 0-based bit
      ``R<d> = OP(R<a>[, R<b>])``  OP in NOT/AND/OR/XOR (+our NAND/NOR/XNOR)
      ``Out<k> = STORE(R<a>)``
      ``BOOT(...)`` accepted as a no-op (circuit.cpp:292-294)
      ``#`` comments and a statistics footer (skipped)

Parsing builds the same integer Netlist IR as the Bristol parser: registers
and input bits become dense wire ids.

The port's own copy of ``oece_tpu.circuits.asm``, kept in step with it
(tests/test_torch_copies.py): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import io
import os
import re
from typing import List

import numpy as np

from .lut import lower_lut
from .netlist import Netlist, Op

_ASM_OPS = {
    "NOT": Op.NOT,
    "AND": Op.AND,
    "OR": Op.OR,
    "XOR": Op.XOR,
    "NAND": Op.NAND,
    "NOR": Op.NOR,
    "XNOR": Op.XNOR,
}
_OP_NAMES = {v: k for k, v in _ASM_OPS.items()}

_RE_HDR = re.compile(r"#\s*number\s+(input|output)(\d+)\s+bits\s+(\d+)")
_RE_LOAD = re.compile(r"R(\d+)\s*=\s*LOAD\(\s*In(\d+)\s*,\s*(\d+)\s*\)")
_RE_STORE = re.compile(r"Out(\d+)\s*=\s*STORE\(\s*R(\d+)\s*\)")
_RE_OP2 = re.compile(r"R(\d+)\s*=\s*(\w+)\(\s*R(\d+)\s*,\s*R(\d+)\s*\)")
_RE_OP1 = re.compile(r"R(\d+)\s*=\s*(\w+)\(\s*R(\d+)\s*\)")
# LUT extension (working replacement for the reference's stub gate types,
# gate.cpp:217-225): Rd = LUT3(0xE8, Ra, Rb, Rc) / LUT4(0x1234, Ra..Rd)
_RE_LUT = re.compile(
    r"R(\d+)\s*=\s*LUT([34])\(\s*(0[xX][0-9a-fA-F]+|\d+)\s*((?:,\s*R\d+\s*)+)\)"
)


def parse_asm(path_or_text: str, name: str | None = None) -> Netlist:
    """Parse a ``.out`` program into a Netlist (ReadFile parity)."""
    if "\n" in path_or_text or "=" in path_or_text and not os.path.exists(path_or_text):
        text = path_or_text
        name = name or "inline"
    else:
        with open(path_or_text) as f:
            text = f.read()
        name = name or os.path.splitext(os.path.basename(path_or_text))[0]

    in_bits: dict[int, int] = {}
    out_bits: dict[int, int] = {}
    ops: List[int] = []
    in0: List[int] = []
    in1: List[int] = []
    outw: List[int] = []

    # wire id assignment: one wire per (input word, bit) and per register DEF.
    # Registers are SSA-renamed on redefinition so the Netlist stays a DAG
    # even though the .out format reuses register names.
    input_wires: dict[tuple, int] = {}
    reg_wire: dict[int, int] = {}
    out_word_regs: dict[int, dict] = {}
    n_wires = 0

    def new_wire() -> int:
        nonlocal n_wires
        n_wires += 1
        return n_wires - 1

    for raw in text.splitlines():
        ln = raw.strip()
        if not ln:
            continue
        if ln.startswith("#"):
            m = _RE_HDR.match(ln)
            if m:
                kind, idx, bits = m.group(1), int(m.group(2)), int(m.group(3))
                (in_bits if kind == "input" else out_bits)[idx] = bits
            continue
        if ln.startswith("BOOT"):
            continue  # no-op, circuit.cpp:292-294
        m = _RE_LOAD.match(ln)
        if m:
            r, word, bit = int(m.group(1)), int(m.group(2)), int(m.group(3))
            key = (word, bit)
            if key not in input_wires:
                input_wires[key] = new_wire()
            reg_wire[r] = input_wires[key]
            continue
        m = _RE_STORE.match(ln)
        if m:
            word1 = 1  # reference uses Out<k> with a single output word 1
            k, r = int(m.group(1)), int(m.group(2))
            out_word_regs.setdefault(word1, {})[k] = reg_wire[r]
            continue
        m = _RE_LUT.match(ln)
        if m:
            r, k, mask = int(m.group(1)), int(m.group(2)), int(m.group(3), 0)
            regs = [int(x) for x in re.findall(r"R(\d+)", m.group(4))]
            if len(regs) != k:
                raise ValueError(f"LUT{k} needs {k} inputs: {raw!r}")

            def _emit(op, a, b):
                w = new_wire()
                ops.append(int(op))
                in0.append(a)
                in1.append(b)
                outw.append(w)
                return w

            def _const(bit):
                w = new_wire()
                ops.append(int(Op.EQ1 if bit else Op.EQ0))
                in0.append(0)
                in1.append(0)
                outw.append(w)
                return w

            reg_wire[r] = lower_lut(_emit, _const, mask, [reg_wire[x] for x in regs])
            continue
        m = _RE_OP2.match(ln)
        if m and m.group(2) in _ASM_OPS and m.group(2) != "NOT":
            r, opn, a, b = (int(m.group(1)), m.group(2), int(m.group(3)), int(m.group(4)))
            w = new_wire()
            ops.append(int(_ASM_OPS[opn]))
            in0.append(reg_wire[a])
            in1.append(reg_wire[b])
            outw.append(w)
            reg_wire[r] = w
            continue
        m = _RE_OP1.match(ln)
        if m and m.group(2) in _ASM_OPS:
            r, opn, a = int(m.group(1)), m.group(2), int(m.group(3))
            w = new_wire()
            ops.append(int(_ASM_OPS[opn]))
            in0.append(reg_wire[a])
            in1.append(reg_wire[a])
            outw.append(w)
            reg_wire[r] = w
            continue
        raise ValueError(f"unparseable .out line: {raw!r}")

    # build input wire arrays in (word, bit) order; words are 1-based
    inputs = []
    for word in sorted({w for (w, _) in input_wires}):
        bits = sorted(b for (w, b) in input_wires if w == word)
        inputs.append(
            np.array([input_wires[(word, b)] for b in bits], dtype=np.int32)
        )
    outputs = []
    for word in sorted(out_word_regs):
        d = out_word_regs[word]
        outputs.append(np.array([d[k] for k in sorted(d)], dtype=np.int32))

    nl = Netlist(
        name=name,
        n_wires=n_wires,
        inputs=inputs,
        outputs=outputs,
        op=np.array(ops, dtype=np.int32),
        in0=np.array(in0, dtype=np.int32),
        in1=np.array(in1, dtype=np.int32),
        out=np.array(outw, dtype=np.int32),
    )
    # sanity vs declared header bit counts when present
    for i, w in enumerate(inputs, start=1):
        if i in in_bits and in_bits[i] != len(w):
            raise ValueError(
                f"{name}: header says input{i} has {in_bits[i]} bits, program LOADs {len(w)}"
            )
    return nl


def emit_asm(
    nl: Netlist,
    reuse_registers: bool = False,
) -> str:
    """Emit a Netlist as a ``.out`` program (assemble_bristol emit parity,
    assemble.cpp:96-425).

    reuse_registers=False reproduces the reference's greedy allocator that
    never frees registers (assemble.cpp:212-233: one register per node);
    True enables the fixed allocator that frees a register after its wire's
    last use (the improvement the reference lists as future work,
    README.md:63-66).
    """
    buf = io.StringIO()
    in_words = nl.input_bits
    w = buf.write
    w(f"# number input1 bits {in_words[0] if len(in_words) > 0 else 0}\n")
    w(f"# number input2 bits {in_words[1] if len(in_words) > 1 else 0}\n")
    w(f"# number output1 bits {nl.output_bits[0] if nl.outputs else 0}\n")
    w("# Do not edit the top 3 lines!\n")
    w(f"# generated by oece_tpu from netlist {nl.name!r}\n")

    # Alias map: EQW outputs share their source's register; EQ0/EQ1 outputs
    # share the synthesized constant registers (pseudo-roots -1/-2).  The
    # .out format has no const/copy instruction, so constants are lowered to
    # XOR(r, r) (+ NOT) on the first loaded input register.
    _CZERO, _CONE = -1, -2
    alias: dict[int, int] = {}

    def root(wid: int) -> int:
        while wid in alias:
            wid = alias[wid]
        return wid

    has_c0 = has_c1 = False
    for k in range(nl.n_gates):
        op = Op(int(nl.op[k]))
        o = int(nl.out[k])
        if op == Op.EQW:
            alias[o] = root(int(nl.in0[k]))
        elif op == Op.EQ0:
            alias[o] = _CZERO
            has_c0 = True
        elif op == Op.EQ1:
            alias[o] = _CONE
            has_c0 = has_c1 = True

    # wire -> register, keyed by root wire only
    wire_reg: dict[int, int] = {}
    free: List[int] = []
    next_reg = 0
    # last use index per root (for the improved allocator); aliases merge
    last_use: dict[int, int] = {}
    for k in range(nl.n_gates):
        if Op(int(nl.op[k])) in (Op.EQ0, Op.EQ1):
            continue  # dummy operands
        last_use[root(int(nl.in0[k]))] = k
        last_use[root(int(nl.in1[k]))] = k
    for word in nl.outputs:
        for wid in word:
            last_use[root(int(wid))] = nl.n_gates + 1  # live to the end
    last_use[_CZERO] = last_use[_CONE] = nl.n_gates + 1

    def alloc() -> int:
        nonlocal next_reg
        if reuse_registers and free:
            return free.pop()
        r = next_reg
        next_reg += 1
        return r

    def release(rwid: int, k: int):
        if reuse_registers and last_use.get(rwid, -1) <= k and rwid in wire_reg:
            free.append(wire_reg.pop(rwid))

    first_reg = None
    for i, word in enumerate(nl.inputs, start=1):
        for j, wid in enumerate(word):
            r = alloc()
            wire_reg[int(wid)] = r
            if first_reg is None:
                first_reg = r
            w(f"R{r} = LOAD(In{i},{j})\n")

    if has_c0:
        if first_reg is None:
            raise ValueError(".out constant lowering needs at least one input bit")
        rz = alloc()
        wire_reg[_CZERO] = rz
        w(f"R{rz} = XOR(R{first_reg}, R{first_reg})\n")
        if has_c1:
            ro = alloc()
            wire_reg[_CONE] = ro
            w(f"R{ro} = NOT(R{rz})\n")

    for k in range(nl.n_gates):
        op = Op(int(nl.op[k]))
        if op in (Op.EQ0, Op.EQ1, Op.EQW):
            continue  # pure aliases, resolved above
        a = root(int(nl.in0[k]))
        b = root(int(nl.in1[k]))
        o = int(nl.out[k])
        ra = wire_reg[a]
        rb = wire_reg[b]
        release(a, k)
        if op != Op.NOT:
            release(b, k)
        r = alloc()
        wire_reg[o] = r
        if op == Op.NOT:
            w(f"R{r} = NOT(R{ra})\n")
        else:
            w(f"R{r} = {_OP_NAMES[op]}(R{ra}, R{rb})\n")

    k_out = 0
    for word in nl.outputs:
        for wid in word:
            w(f"Out{k_out} = STORE(R{wire_reg[root(int(wid))]})\n")
            k_out += 1
    w(f"# statistics: gates {nl.n_gates} registers {next_reg}\n")
    return buf.getvalue()
