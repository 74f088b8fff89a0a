"""The port's copies of the harness-side pure-NumPy modules, held to their
originals: every ``circuits.gen`` and ``circuits.fp`` generator (at small
widths where it takes one) gives the same netlist arrays, every
``harness.models`` function the same outputs on seeded inputs and every
constant the same value, ``utils.cli.parse_inputs`` the same ``Options``,
and ``circuits.analyze`` the same report and assembled ``.out`` text."""

import dataclasses
import inspect
import os

import numpy as np
import pytest

from oece_tpu.circuits import analyze as janalyze
from oece_tpu.circuits import fp as jfp
from oece_tpu.circuits import gen as jgen
from oece_tpu.harness import models as jmodels
from oece_tpu.utils import cli as jcli
from oece_tpu_torch.circuits import analyze, fp, gen
from oece_tpu_torch.harness import models
from oece_tpu_torch.utils import cli
from test_torch_copies import _same_netlist

EX = os.path.join(os.path.dirname(__file__), "..", "examples")

GENERATORS = [
    ("gen_adder", (4,)), ("gen_adder", (5, False)), ("gen_comparator", (4,)),
    ("gen_comparator", (4, True)), ("gen_comparator", (4, True, True)),
    ("gen_comparator", (4, False, True)), ("gen_multiplier", (4,)), ("gen_parity", (8,)),
    ("gen_sub", (4,)), ("gen_neg", (4,)), ("gen_zero_equal", (4,)), ("gen_mult_low", (4,)),
    ("gen_mult2", (4,)), ("gen_udivide", (4,)), ("gen_divide", (4,)),
    ("gen_sha256_compress", ()), ("gen_sha1_compress", ()), ("gen_md5_compress", ()),
    ("gen_sha512_compress", ()), ("gen_keccak_f", ()), ("gen_des", (True,)), ("gen_des", (False,)),
    ("gen_aes128", (True,)), ("gen_aes128", (False,)), ("gen_aes", (192,)), ("gen_aes", (256,)),
]
FP_GENERATORS = ["gen_fp_add", "gen_fp_mul", "gen_fp_div", "gen_fp_sqrt", "gen_fp_eq", "gen_fp_f2i"]


def test_every_generator_is_listed():
    for ours, theirs, listed in ((gen, jgen, {g for g, _ in GENERATORS}), (fp, jfp, set(FP_GENERATORS))):
        names = {n for n, f in vars(theirs).items() if n.startswith("gen_") and callable(f)}
        assert names == listed
        assert names == {n for n, f in vars(ours).items() if n.startswith("gen_") and callable(f)}


@pytest.mark.parametrize("name,args", GENERATORS, ids=[f"{g}{a}" for g, a in GENERATORS])
def test_gen_netlists_match(name, args):
    _same_netlist(getattr(gen, name)(*args), getattr(jgen, name)(*args))


@pytest.mark.parametrize("name", FP_GENERATORS)
def test_fp_netlists_match(name):
    _same_netlist(getattr(fp, name)(), getattr(jfp, name)())


def test_builder_luts_and_dffs_match():
    """The builder's LUT lowering and DFF binding, on one small netlist."""
    nets = []
    for mod in (gen, jgen):
        b = mod.Builder("mix")
        x = b.input_word(4)
        q = b.DFF()
        b.dff_bind(q, b.LUT3(0xE8, x[0], x[1], q))
        b.output_word([b.LUT4(0x6996, *x), b.MUX(x[0], x[1], x[2]), b.NAND(x[3], q), q])
        nets.append(b.build())
    _same_netlist(*nets)


def _model_cases(rng):
    """(function name, argument tuples) for every public model function."""
    blocks = [rng.bytes(64) for _ in range(3)]
    f64 = [0x0, 0x8000000000000000, 0x3FF0000000000000, 0x7FF0000000000000, 0x7FF8000000000001,
           0x0000000000000001, 0x4010000000000000, 0xC004000000000000]
    f64 += [int(v) for v in rng.integers(0, 1 << 64, 24, dtype=np.uint64)]
    pairs = [(a, b) for a, b in zip(f64, f64[::-1])]
    keys = [rng.bytes(16), rng.bytes(24), rng.bytes(32)]
    des_keys, des_pts = [rng.bytes(8) for _ in range(3)], [rng.bytes(8) for _ in range(3)]
    ints = [int(v) for v in rng.integers(0, 1 << 63, 6, dtype=np.uint64)] + [0, 1, (1 << 64) - 1]
    return {
        "hex_to_bits_lsb": [(rng.bytes(9).hex(),)],
        "bits_lsb_to_hex": [(rng.integers(0, 2, 72),)],
        "int_to_bits": [(v, 64) for v in ints] + [(v, 130) for v in ints[:3]],
        "bits_to_int": [(rng.integers(0, 2, 70),)],
        "md5_compress": [(b,) for b in blocks],
        "sha256_compress": [(b,) for b in blocks],
        "sha1_compress": [(b,) for b in blocks],
        "sha512_compress": [(rng.bytes(128),) for _ in range(2)],
        "keccak_f": [(rng.bytes(200),) for _ in range(2)],
        "aes_expand_key": [(k,) for k in keys],
        "aes128_expand_key": [(keys[0],)],
        "aes128_encrypt": [(rng.bytes(16), keys[0])],
        "aes128_encrypt_with_round_keys": [(rng.bytes(16), jmodels.aes128_expand_key(keys[0]))],
        "aes_encrypt": [(rng.bytes(16), k) for k in keys],
        "udiv": [(a, b, 64) for a, b in zip(ints, ints[::-1])] + [(7, 0, 64), (200, 7, 8)],
        "sdiv": [(a, b, 64) for a, b in zip(ints, ints[::-1])] + [(7, 0, 64), (200, 7, 8)],
        "des_expand_key": [(k,) for k in des_keys],
        "des_encrypt": list(zip(des_pts, des_keys)),
        "des_encrypt_with_round_keys": [(des_pts[0], jmodels.des_expand_key(des_keys[0]))],
        "fp_add": pairs, "fp_mul": pairs, "fp_div": pairs, "fp_eq": pairs,
        "fp_sqrt": [(a,) for a in f64], "fp_f2i": [(a,) for a in f64],
    }


def test_models_match():
    public = {n for n, f in vars(jmodels).items()
              if inspect.isfunction(f) and not n.startswith("_") and f.__module__ == jmodels.__name__}
    assert public == {n for n, f in vars(models).items()
                      if inspect.isfunction(f) and not n.startswith("_") and f.__module__ == models.__name__}
    cases = _model_cases(np.random.default_rng(11))
    assert set(cases) == public
    for name, arglist in cases.items():
        for args in arglist:
            got, want = getattr(models, name)(*args), getattr(jmodels, name)(*args)
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                assert got == want, name
    consts = [n for n, v in vars(jmodels).items()
              if not callable(v) and not inspect.ismodule(v) and not n.startswith("__")]
    assert consts
    for n in consts:
        a, b = getattr(models, n), getattr(jmodels, n)
        assert type(a) is type(b) and (np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b), n
    for n in ("_keccak_rcs", "_keccak_rots", "_aes_sbox"):
        assert getattr(models, n)() == getattr(jmodels, n)(), n


@pytest.mark.parametrize("argv", [
    [], ["-z", "-f", "-c", "2", "-n", "8", "-s", "TOY", "-m", "AP", "-v"],
    ["-a", "--recover", "--plaintext-only", "--xor-mode", "compound", "--seed", "9"],
    ["-s", "MICRO", "-n", "1"],
])
def test_cli_parse_inputs_match(argv):
    got, want = cli.parse_inputs(argv), jcli.parse_inputs(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(cli.Options)] == [f.name for f in dataclasses.fields(jcli.Options)]


@pytest.mark.parametrize("path", ["old_bristol_ckts/arith/adder_32bit.txt",
                                  "old_bristol_ckts/arith/mult_32x32.txt",
                                  "new_bristol_ckts/arith/zero_equal.txt"])
def test_analyze_and_assemble_match(path, tmp_path):
    fname = os.path.join(EX, path)
    for fan in (False, True):
        a, ja = analyze.analyze(fname, gen_fan=fan), janalyze.analyze(fname, gen_fan=fan)
        assert a.report() == ja.report()
        for f in ("first_use", "last_use"):
            np.testing.assert_array_equal(getattr(a, f), getattr(ja, f))
        assert (a.fan_out is None) == (ja.fan_out is None) == (not fan)
    for reuse in (False, True):
        out = analyze.assemble(a, str(tmp_path / "p.out"), reuse_registers=reuse)
        jout = janalyze.assemble(ja, str(tmp_path / "j.out"), reuse_registers=reuse)
        assert open(out).read() == open(jout).read()
