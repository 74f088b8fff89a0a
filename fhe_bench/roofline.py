"""The yardstick of the blind rotation: published peaks of one NVIDIA H100
SXM (data sheet, dense) and the work a rotation needs, counted from the
configuration's parameters and each call's lanes, whatever kernel runs it.

Operations: a GINX step multiplies each gate's accumulator digits (2 polys
x d gadget digits = 2d rows) by an RGSW key of 2 output polys, for s_i = 1
and for s_i = -1: 2 x 2d x 2 dense negacyclic N x N products, each on the 4
signed int8 limbs of a coefficient mod Q < 2**27, at 2 operations a MAC.
At STD128_OPT (d = 2, N = 1024) that is 16 x 4 x N**2 = 67.1 M MACs per
gate and step.  A binary-base AP step is one RGSW product (half of the
GINX pair), and only for the gates whose select bit is set: bit j of
(-a_i mod 2N), which the rotation's public input a2N fixes.

Bytes: each step's compact key, the key material itself whatever layout
the program keeps it in (GINX: both RGSW keys, 2 x 2d x 2 x N coefficients
of 4 bytes; AP: one RGSW key, for the steps with a live gate), plus the
accumulators [B, 2, N] int32 read in and written out once per call.

A call's least time is the larger of operations at the int8 peak and bytes
at the HBM rate.
"""

from __future__ import annotations

import math

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
LIMBS = 4  # signed int8 limbs of a coefficient mod Q < 2**27
COEFF_BYTES = 4


def product_macs(p: dict, d: int) -> float:
    """MACs of one RGSW product of one gate: 2d digit rows x 2 output
    polys of N x N negacyclic products, on LIMBS limbs."""
    return 2 * d * 2 * LIMBS * p["N"] ** 2


def rgsw_bytes(p: dict, d: int) -> int:
    return 2 * d * 2 * p["N"] * COEFF_BYTES


def acc_bytes(p: dict, B: int) -> int:
    """The accumulators in and out."""
    return 2 * B * 2 * p["N"] * COEFF_BYTES


def least_s(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ginx_call(p: dict, d: int, B: int) -> tuple[float, str]:
    """Least time of a GINX rotation of B gates over n steps."""
    n = p["n"]
    ops = 2 * 2 * product_macs(p, d) * B * n
    return least_s(ops, 2 * rgsw_bytes(p, d) * n + acc_bytes(p, B))


def ap_call(p: dict, d: int, B: int, live_pairs: int, live_steps: int) -> tuple[float, str]:
    """Least time of a binary-base AP rotation of B gates with
    ``live_pairs`` selected (gate, step) pairs over ``live_steps`` steps
    that select any gate."""
    ops = 2 * product_macs(p, d) * live_pairs
    return least_s(ops, rgsw_bytes(p, d) * live_steps + acc_bytes(p, B))


def ap_digits(p: dict) -> int:
    return math.ceil(math.log2(2 * p["N"]) / math.log2(p["B_r"]))
