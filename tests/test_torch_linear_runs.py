"""The evaluator's linear runs (``evaluator.linear_runs``): a level's
NOT, EQW and constant gates run as one gather and one scatter per run, and
a run ends before a gate that reads what the run writes, so a chain such
as NOT(NOT(x)) inside one level sees its own writes.

Held to the benchmark's plain reference (``fhe_bench.reference``):
a small netlist of such chains run pure-encrypted at MICRO, and the whole
of aes_128.txt (FIPS-197 C.1 and seeded key/block pairs) through the
evaluator with an exact stand-in for the bootstrap, on trivial work.  The
runs of adder_32bit, mult_32x32 and sha256 have no such chain and stay as
runs of one op."""

import os

import numpy as np
import pytest
import torch

from fhe_bench import reference
from fhe_bench import run as bench_run
from oece_tpu_torch.circuits import bristol
from oece_tpu_torch.circuits.netlist import assign_ct_slots, levelize
from oece_tpu_torch.fhe import boot, golden, lwe
from oece_tpu_torch.fhe.keys import GATE_INDEX
from oece_tpu_torch.fhe.params import MICRO, STD128, BinGate
from oece_tpu_torch.runtime.evaluator import Circuit, linear_runs
from test_torch_std import one_torch_thread  # noqa: F401

EX = os.path.join(os.path.dirname(__file__), "..", "examples")
AES128 = os.path.join(EX, "new_bristol_ckts/crypto/aes_128.txt")
# levels of aes_128.txt whose one-op runs hold a chain (PERF.md section 6)
AES128_CHAIN_LEVELS = [84, 173, 529, 619, 796, 885]


def chain_bristol(path: str) -> None:
    """A new-fashion Bristol file of two 6-bit inputs a, b with linear
    chains inside one level: on the inputs (NOT -> NOT, NOT -> EQW ->
    EQW), on bootstrap outputs (AND -> NOT -> NOT -> EQW), a bootstrap
    level reading the chains' ends, and EQW copies of every chain's wires
    as the outputs (the last wires)."""
    gates, nxt = [], [12]

    def g(op, *ins):
        gates.append((op, ins, nxt[0]))
        nxt[0] += 1
        return nxt[0] - 1

    a, b = list(range(6)), list(range(6, 12))
    x = [g("INV", a[i]) for i in range(3)]             # level 0, rank 1
    xx = [g("INV", v) for v in x]                      # rank 2: NOT -> NOT
    xe = [g("EQW", v) for v in x]                      # rank 2: NOT -> EQW
    xee = [g("EQW", v) for v in xe]                    # rank 3: EQW -> EQW
    y = [g("AND", a[i], b[i]) for i in range(3, 6)]    # level 1
    yn = [g("INV", v) for v in y]                      # rank 1, fed by a bootstrap
    ynn = [g("INV", v) for v in yn]                    # rank 2
    yne = [g("EQW", v) for v in ynn]                   # rank 3
    z = [g("XOR", u, v) for u, v in zip(xx, ynn)]      # level 2
    z += [g("OR", u, v) for u, v in zip(xee, yne)]
    zn = [g("INV", v) for v in z]
    keep = x + xx + xe + xee + yn + ynn + yne + z + zn
    for w in keep:
        g("EQW", w)
    lines = [f"{len(gates)} {nxt[0]}", "2 6 6", f"1 {len(keep)}", ""]
    for op, ins, out in gates:
        lines.append(f"{len(ins)} 1 {' '.join(map(str, ins))} {out} {op}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def old_runs(level: dict) -> list:
    """(op, first, end) of a level's runs of one op: runs split only where
    the op changes."""
    ops, out, k = level["lin_op"], [], 0
    while k < len(ops):
        j = k + 1
        while j < len(ops) and ops[j] == ops[k]:
            j += 1
        out.append((int(ops[k]), k, j))
        k = j
    return out


def runs_by_position(level: dict, slot) -> list:
    runs, k = [], 0
    for o, s_in, s_out in linear_runs(level, slot):
        runs.append((o, k, k + len(s_out)))
        k += len(s_out)
    return runs


def test_chain_runs_split_where_a_gate_reads_the_run(tmp_path):
    """The runs hold the level's linear gates in order; no run of a NOT or
    EQW reads a slot it writes, and each ends at an op change or before
    such a read."""
    path = str(tmp_path / "chains.txt")
    chain_bristol(path)
    nl = bristol.parse_bristol(path)
    plan = levelize(nl)
    slot, _ = assign_ct_slots(nl, plan)
    split = 0
    for level in plan.levels:
        runs = linear_runs(level, slot)
        if not runs:
            continue
        assert [o for o, _, s_out in runs for _ in s_out] == level["lin_op"].tolist()
        assert np.concatenate([s for _, s, _ in runs]).tolist() == slot[level["lin_in0"]].tolist()
        assert np.concatenate([s for _, _, s in runs]).tolist() == slot[level["lin_out"]].tolist()
        for (o, s_in, s_out), (o2, s_in2, _) in zip(runs, runs[1:] + [(None, None, None)]):
            assert not set(s_in.tolist()) & set(s_out.tolist())
            assert o2 != o or int(s_in2[0]) in set(s_out.tolist())
        split += len(runs) - len(old_runs(level))
    # level 0: x -> xx, xe -> xee, xee -> its copy; level 1: yn -> ynn,
    # yne -> its copy
    assert split == 5


@pytest.mark.parametrize("seed", [2**33 + 17, 5])
def test_linear_chains_decrypt_to_the_reference(tmp_path, seed):
    """Pure-encrypted at MICRO (recovery off, no plaintext pass to repair
    anything), every output bit equals the reference's evaluation."""
    path = str(tmp_path / "chains.txt")
    chain_bristol(path)
    circ = reference.parse(path)
    c = Circuit(set="MICRO", method="GINX", seed=seed, device="cpu")
    c.ReadFile(path)
    c.setPlaintext(False)
    c.setEncrypted(True)
    c.setRecovery(False)
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 2, (4, 6)) for _ in range(2)]
    c.SetInput(words)
    c.Clock()
    outs = [c._ct_arena[torch.from_numpy(c._slot[w])].numpy() for w in c.netlist.outputs]
    got = bench_run.judge(circ, [words], [outs], c.sk.s, MICRO.q)
    assert got["wrong_bits"] == 0 and got["output_bits"] == 4 * circ.output_bits[0]


# the bootstrap's gate on its prep's quarter: AND, OR, NAND and NOR prep
# c1 + c2 (quarters 0, 1, 2), XOR and XNOR 2(c1 - c2) (quarters 0, 2);
# -1 where no sound prep lands
TRUTH = {
    BinGate.AND: [0, 0, 1, -1], BinGate.OR: [0, 1, 1, -1],
    BinGate.NAND: [1, 1, 0, -1], BinGate.NOR: [1, 0, 0, -1],
    BinGate.XOR: [0, -1, 1, -1], BinGate.XNOR: [1, -1, 0, -1],
}


def exact_bootstrap(s: torch.Tensor, q: int):
    """A stand-in for ``boot.bootstrap_batch``: the gate's bit of the prep's
    phase under s, as a noiseless trivial ciphertext (a = 0, b = bit q/4)."""
    table = torch.tensor([TRUTH[g] for g in sorted(TRUTH, key=GATE_INDEX.get)])

    def run(prep, gids, keys):
        quarter = ((lwe.phase_dev(s, prep, q) + q // 8) // (q // 4)) % 4
        bit = table[gids.long(), quarter]
        assert (bit >= 0).all()
        out = torch.zeros_like(prep)
        out[:, -1] = bit.to(prep.dtype) * (q // 4)
        return out

    return run


def aes_words(keys: list, blocks: list) -> list:
    """[key, block] words of whole 128-bit values, big-endian values, bits
    LSB first (as fhe_bench's FIPS-197 check)."""
    def bits(values):
        return np.array([[(int.from_bytes(v, "big") >> i) & 1 for i in range(128)] for v in values])

    return [bits(keys), bits(blocks)]


def test_aes128_fips197_and_seeded_pairs_through_the_evaluator(monkeypatch):
    """aes_128.txt through Clock at STD128's q and n, pure-encrypted with
    recovery off, each bootstrap the exact stand-in: FIPS-197 C.1 and
    seeded key/block pairs give the reference's bits, every one."""
    p = STD128
    rng = np.random.default_rng(2**32 + 19)
    sk = golden.LWESecretKey(s=rng.integers(-1, 2, p.n), params=p)
    s = torch.from_numpy(sk.s)
    monkeypatch.setattr(boot, "bootstrap_batch", exact_bootstrap(s, p.q))
    circ = reference.parse(AES128)
    c = Circuit(set=p, method="GINX", device="cpu", sk=sk, rng=rng, generate_keys=False)
    c.ReadFile(AES128)
    c.setPlaintext(False)
    c.setEncrypted(True)
    c.setRecovery(False)
    keys = [bytes(range(16))] + [rng.bytes(16) for _ in range(3)]
    blocks = [bytes.fromhex("00112233445566778899aabbccddeeff")] + [rng.bytes(16) for _ in range(3)]
    words = aes_words(keys, blocks)
    c.SetInput(words)
    c.Clock()
    assert c._bootstraps_run == 4 * circ.bootstrapped_gates()
    (cts,) = [c._ct_arena[torch.from_numpy(c._slot[w])].numpy() for w in c.netlist.outputs]
    got = bench_run.judge(circ, [words], [[cts]], sk.s, p.q)
    assert got["wrong_bits"] == 0 and got["output_bits"] == 4 * 128
    bits = reference.decrypt(cts, sk.s, p.q)  # [128, T]
    first = sum(int(b) << i for i, b in enumerate(bits[:, 0]))
    assert first.to_bytes(16, "big").hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    assert [int(o) for o in c.GetOutput()[0][0]] == bits[:, 0].tolist()


@pytest.mark.parametrize("name", [
    "old_bristol_ckts/arith/adder_32bit.txt",
    "old_bristol_ckts/arith/mult_32x32.txt",
    "new_bristol_ckts/crypto/sha256.txt",
    "new_bristol_ckts/crypto/aes_128.txt",
])
def test_runs_split_only_at_chains(name):
    """adder_32bit, mult_32x32 and sha256 keep their runs of one op;
    aes_128 splits one run at each of its six chain levels, and no more."""
    nl = bristol.parse_bristol(os.path.join(EX, name))
    plan = levelize(nl)
    slot, _ = assign_ct_slots(nl, plan)
    changed = [lv for lv, level in enumerate(plan.levels)
               if runs_by_position(level, slot) != old_runs(level)]
    want = AES128_CHAIN_LEVELS if "aes_128" in name else []
    assert changed == want
    for lv in changed:
        level = plan.levels[lv]
        assert len(runs_by_position(level, slot)) == len(old_runs(level)) + 1


def test_a_chain_in_an_op_run_runs_in_rank_order():
    """One level of NOT(x0), NOT(x1), NOT(NOT(x0)): two runs, the second
    reading the first's output slot; constants never end a run."""
    NOT, EQ1 = 6, 9
    level = {"lin_op": np.array([NOT, NOT, NOT, EQ1, EQ1]), "lin_in0": np.array([0, 1, 2, 0, 5]),
             "lin_out": np.array([2, 3, 4, 5, 6])}
    slot = np.arange(7) + 10
    runs = linear_runs(level, slot)
    assert [(o, s_in.tolist(), s_out.tolist()) for o, s_in, s_out in runs] == [
        (NOT, [10, 11], [12, 13]), (NOT, [12], [14]), (EQ1, [10, 15], [15, 16])]
