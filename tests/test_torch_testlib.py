"""The port's TB harness (``harness.testlib``, ``harness.tb``) and its
circuit runner (``tools/run_circuit.py``) against the JAX package's.

Plaintext: each TB family as ``tb.py`` names it runs on the repo's
``examples/`` (this file: the simple and 32-bit arithmetic benches;
tests/test_torch_testlib_crypto.py and _cipher.py the rest) and gives the
JAX package's ``HarnessResult`` apart from ``seconds``.  Encrypted: with
the JAX package's MICRO main-path keys, secret and a copy of its generator
injected through ``circuit=``, adder_2bit and parity in verify and in
recover mode give the same results, ciphertexts and generator state.
``tb.main`` prints the JAX package's PASS lines apart from the seconds,
and ``run_circuit`` writes the document of tools/run_circuit_std128.py."""

import copy
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from oece_tpu.fhe import boot as jboot
from oece_tpu.harness import tb as jtb
from oece_tpu.harness import testlib as jtl
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu.utils import cli as jcli
from oece_tpu_torch.fhe import keys
from oece_tpu_torch.fhe.golden import LWESecretKey
from oece_tpu_torch.harness import tb
from oece_tpu_torch.harness import testlib as tl
from oece_tpu_torch.runtime.evaluator import Circuit
from oece_tpu_torch.tools import run_circuit
from oece_tpu_torch.utils import cli
from test_torch_std import one_torch_thread  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SIMPLE = os.path.join(REPO, "examples", "simple_ckts")


def fields(r) -> dict:
    d = dataclasses.asdict(r)
    d.pop("seconds")
    return d


def assert_bench_plaintext_matches(name: str) -> None:
    """One TB bench, plaintext only, four cases, in both packages."""
    argv = ["--plaintext-only", "-n", "4"]
    want = jtb.BENCHES[name](jcli.parse_inputs(argv))
    got = tb.BENCHES[name](tb.TBOptions(**dataclasses.asdict(cli.parse_inputs(argv)), device="cpu"))
    assert [fields(r) for r in got] == [fields(r) for r in want]
    assert got and all(r.passed for r in got)


@pytest.mark.parametrize("name", ["adder_2bit", "parity", "adders", "comparators", "multipliers"])
def test_bench_plaintext_matches_jax(name):
    assert_bench_plaintext_matches(name)


def test_bench_lists_match():
    assert list(tb.BENCHES) == list(jtb.BENCHES)
    assert tl.DEFAULT_CIRCUITS_DIR == jtl.DEFAULT_CIRCUITS_DIR


@pytest.fixture(scope="module")
def jax_circuit():
    mp = pytest.MonkeyPatch()
    mp.setenv("OECE_FORCE_DEVICE_KEYGEN", "1")
    mp.delenv("OECE_LEVEL_JIT", raising=False)
    mp.setattr(jboot, "PALLAS_INTERPRET", True)
    jc = JaxCircuit(set="MICRO", method="GINX", seed=13)
    yield jc, keys.from_jax(jc.dkeys)
    mp.undo()


@pytest.mark.parametrize("mode", ["verify", "recover"])
@pytest.mark.parametrize("bench", ["adder_2bit", "parity"])
def test_encrypted_harness_matches_jax(jax_circuit, bench, mode):
    jc, kt = jax_circuit
    jc.recover_flag, jc._recover_explicit = False, False
    tc = Circuit(set="MICRO", device="cpu", keys=kt, sk=LWESecretKey(s=jc.sk.s, params=kt.params),
                 rng=copy.deepcopy(jc._rng))
    fname = os.path.join(SIMPLE, bench, f"{bench}.out")
    fn = {"adder_2bit": "test_adder", "parity": "test_parity"}[bench]
    kw = dict(verify=mode == "verify", recover=mode == "recover")
    want = getattr(jtl, fn)(fname, 4, circuit=jc, **kw)
    got = getattr(tl, fn)(fname, 4, circuit=tc, device="cpu", **kw)
    assert fields(got) == fields(want) and got.passed and got.enc_run
    assert tc.recover_counts == jc.recover_counts and tc.max_phase_err == jc.max_phase_err
    assert tc.recover_flag == (mode == "recover")
    assert tc._rng.bit_generator.state == jc._rng.bit_generator.state
    np.testing.assert_array_equal(tc._ct_arena.numpy(), np.asarray(jc._ct_arena))


def test_tb_main_matches_jax(capsys):
    """The TB command line at MICRO (each package its own keys): exit 0 and
    the JAX package's lines, apart from the seconds."""
    argv = ["adder_2bit", "-s", "MICRO", "-n", "1"]
    assert jtb.main(list(argv)) == 0
    want = capsys.readouterr().out
    assert tb.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def lines(out):
        return [re.sub(r"\[[0-9.]+s\]", "[s]", ln) for ln in out.splitlines()
                if ln.startswith(("PASS", "FAIL", "==="))]

    assert lines(got) == lines(want)
    assert lines(got)[0].startswith("PASS adder[adder_2bit.out]: plaintext 1/1 passed, encrypted 1/1")


def test_tb_cuda_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.main(["adder_2bit", "-s", "MICRO", "-n", "1", "--plaintext-only"])


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("bad_gate_levels", "recover_counts"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_run_circuit_document_matches_jax(tmp_path):
    """``run_circuit --set MICRO --loops 1 --device cpu adder_32bit`` writes
    the fields of tools/run_circuit_std128.py's document (run here in a
    scratch directory, where it writes artifacts/), plus the device."""
    out = tmp_path / "port.json"
    assert run_circuit.main(["--set", "MICRO", "--loops", "1", "--device", "cpu", "adder_32bit",
                             "--out", str(out)]) == 0
    env = {k: v for k, v in os.environ.items() if not k.startswith("OECE_")}
    env.update(OECE_KEY_CACHE=str(tmp_path / "keys"), PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "run_circuit_std128.py"), "adder_32bit",
         "--set", "MICRO", "--loops", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(out.read_text())
    want = json.loads((tmp_path / "artifacts" / "adder_32bit_micro_T1.json").read_text())
    assert _keys(got) == _keys(want) | {"provenance.device"}
    assert got["provenance"]["device"] == "cpu"
    for k in ("bench", "set", "method", "xor_mode", "loops", "verify"):
        assert got[k] == want[k], k
    for k in ("n_cases", "plain_passed", "enc_passed"):
        assert got["harness"][k] == want["harness"][k] == 1, k
    assert got["encrypted_trace"]["level_width_stats"] == want["encrypted_trace"]["level_width_stats"]
    assert [lv["bootstraps"] for lv in got["encrypted_trace"]["levels"]] == \
        [lv["bootstraps"] for lv in want["encrypted_trace"]["levels"]]
    assert os.path.basename(got["circuit_file"]) == os.path.basename(want["circuit_file"])
