"""The benchmark's plain reference: a Bristol parser, a plaintext evaluator
and LWE decryption, in Python and NumPy.

It imports nothing of the program under test.  The benchmark hands it the
same circuit file, the same input bits and the LWE secret it drew itself;
it reads the program's output ciphertexts only to judge them.

Both Bristol fashions (Tillich-Smart; the "Bristol Fashion" of Archer et
al.): old, ``ngates nwires`` / ``n_in1 n_in2 n_out``, and new,
``ngates nwires`` / ``niv w1 .. wniv`` / ``nov w1 .. wnov``.  Inputs take
the lowest wires in declaration order, outputs the last wires.  Gates are
``n_in n_out in.. out.. OP`` in topological order.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

# Gates that cost one bootstrap each (XOR natively, as one bootstrap of
# 2(c1 - c2)); INV, EQ and EQW are linear.
BOOTSTRAPPED = ("AND", "OR", "XOR", "NAND", "NOR", "XNOR")
LINEAR = ("INV", "NOT", "EQ", "EQW")


@dataclasses.dataclass
class Bristol:
    n_wires: int
    input_bits: List[int]
    output_bits: List[int]
    gates: List[tuple]  # (op, in0, in1, out); in1 == in0 for one input, in0 = constant for EQ

    def bootstrapped_gates(self) -> int:
        return sum(g[0] in BOOTSTRAPPED for g in self.gates)

    def input_wires(self) -> List[range]:
        words, off = [], 0
        for b in self.input_bits:
            words.append(range(off, off + b))
            off += b
        return words

    def output_wires(self) -> List[range]:
        words, off = [], self.n_wires - sum(self.output_bits)
        for b in self.output_bits:
            words.append(range(off, off + b))
            off += b
        return words


def parse(path: str) -> Bristol:
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    n_gates, n_wires = int(lines[0][0]), int(lines[0][1])
    l2, l3 = lines[1], lines[2]
    new = len(l2) == int(l2[0]) + 1 and len(l3) == int(l3[0]) + 1 and len(l3) >= 2
    if new:
        input_bits = [int(x) for x in l2[1:]]
        output_bits = [int(x) for x in l3[1:]]
        body = lines[3:]
    else:
        vals = [int(x) for x in l2]
        input_bits = [b for b in vals[:2] if b > 0]
        output_bits = [vals[2]]
        body = lines[2:]
    if len(body) != n_gates:
        raise ValueError(f"{path}: header says {n_gates} gates, found {len(body)}")
    gates = []
    for parts in body:
        op, n_in = parts[-1], int(parts[0])
        wires = [int(x) for x in parts[2:-1]]
        if op not in BOOTSTRAPPED and op not in LINEAR:
            raise ValueError(f"{path}: gate {op!r} is not one the reference evaluates")
        if len(wires) != n_in + int(parts[1]) or int(parts[1]) != 1:
            raise ValueError(f"{path}: bad gate line {' '.join(parts)!r}")
        gates.append((op, wires[0], wires[1] if n_in > 1 else wires[0], wires[n_in]))
    return Bristol(n_wires, input_bits, output_bits, gates)


def evaluate(circ: Bristol, inputs: List[np.ndarray]) -> List[np.ndarray]:
    """Plaintext evaluation of many cases at once: ``inputs`` holds one
    int array [cases, bits] per input word; returns one [cases, bits]
    per output word.  Each wire is a Python integer whose bit k is its
    value in case k."""
    cases = inputs[0].shape[0]
    ones = (1 << cases) - 1
    weights = [1 << k for k in range(cases)]
    w = [0] * circ.n_wires

    def pack(col) -> int:
        return sum(wt for wt, v in zip(weights, col) if v)

    for word, wires in zip(inputs, circ.input_wires()):
        word = np.asarray(word)
        if word.shape != (cases, len(wires)):
            raise ValueError(f"input word of shape {word.shape}, want {(cases, len(wires))}")
        for j, wire in enumerate(wires):
            w[wire] = pack(word[:, j])
    for op, a, b, o in circ.gates:
        if op == "XOR":
            w[o] = w[a] ^ w[b]
        elif op == "AND":
            w[o] = w[a] & w[b]
        elif op in ("INV", "NOT"):
            w[o] = w[a] ^ ones
        elif op == "OR":
            w[o] = w[a] | w[b]
        elif op == "EQW":
            w[o] = w[a]
        elif op == "EQ":
            w[o] = ones if a else 0
        elif op == "NAND":
            w[o] = (w[a] & w[b]) ^ ones
        elif op == "NOR":
            w[o] = (w[a] | w[b]) ^ ones
        else:  # XNOR
            w[o] = w[a] ^ w[b] ^ ones
    outs = []
    for wires in circ.output_wires():
        outs.append(np.array([[(w[wire] >> k) & 1 for wire in wires] for k in range(cases)],
                             dtype=np.int64).reshape(cases, len(wires)))
    return outs


def phase_errors(cts: np.ndarray, s: np.ndarray, want: np.ndarray, q: int) -> np.ndarray:
    """Centred error of LWE ciphertexts cts [..., n+1] = (a, b) mod q under
    the secret s [n], against the bits ``want`` [...] encoded at m*q/4:
    e = b - <a, s> - m*q/4, in (-q/2, q/2]."""
    cts = np.asarray(cts, dtype=np.int64)
    phase = (cts[..., -1] - cts[..., :-1] @ np.asarray(s, dtype=np.int64)) % q
    return (phase - np.asarray(want, dtype=np.int64) * (q // 4) + q // 2) % q - q // 2


def decrypt(cts: np.ndarray, s: np.ndarray, q: int) -> np.ndarray:
    """The bit of the nearest multiple of q/4, modulo 2."""
    cts = np.asarray(cts, dtype=np.int64)
    phase = (cts[..., -1] - cts[..., :-1] @ np.asarray(s, dtype=np.int64)) % q
    return ((phase + q // 8) // (q // 4)) % 4 % 2
