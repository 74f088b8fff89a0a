"""The port runs without JAX and without the JAX package: a fresh
interpreter with ``jax`` blocked imports oece_tpu_torch, generates MICRO
keys with the port's own keygen and clocks adder_2bit to the right sums in
verify mode, runs gates through a MICRO ``BinFHEContext``, imports the
harness, circuit generators and tools, and passes the adder_2bit test
bench pure-encrypted with recovery (what chip_smoke.py needs on a machine
that has no JAX), clocks the adder again with a checkpoint and the lane
trace, builds the native parser and runs the NTT, the key cache, the
MICRO generic-base AP rotation, a chunk of the noise tool and the
XOR-noise tool's corpus scan; no module of
``oece_tpu`` is loaded on the way.  An AST scan finds no import of ``jax``
or ``oece_tpu`` in the port's sources, chip_smoke.py or chip_profile.py."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
from oece_tpu_torch.runtime.evaluator import Circuit

c = Circuit(set="MICRO", method="GINX", seed=17, device="cpu")
c.ReadFile("examples/simple_ckts/adder_2bit/adder_2bit.out")
c.setVerify(True)
cases = [(x, y) for x in range(4) for y in range(4)]
c.SetInput([np.array([[x & 1, x >> 1] for x, _ in cases]),
            np.array([[y & 1, y >> 1] for _, y in cases])])
c.Clock()
(out,) = c.GetOutput()
sums = (out << np.arange(out.shape[1])).sum(1)
assert list(sums) == [x + y for x, y in cases], sums
from oece_tpu_torch.fhe.context import BinFHEContext

cc = BinFHEContext(device="cpu").GenerateBinFHEContext("MICRO", "GINX", seed=3)
sk = cc.KeyGen()
cc.BTKeyGen(sk)
x, y = cc.EncryptBatch(sk, [0, 1, 1, 0]), cc.EncryptBatch(sk, [1, 1, 0, 0])
got = cc.DecryptBatch(sk, cc.EvalBinGateBatch(["AND", "OR", "XOR", "NOR"], x, y))
assert list(got) == [0, 1, 1, 1], got
from oece_tpu_torch.circuits import analyze, fp, gen  # noqa: F401
from oece_tpu_torch.harness import models, tb, testlib  # noqa: F401
from oece_tpu_torch.tools import circuit_walls, run_circuit  # noqa: F401
from oece_tpu_torch.utils import cli  # noqa: F401

assert tb.main(["adder_2bit", "-s", "MICRO", "-n", "2", "--device", "cpu", "--recover"]) == 0
import os
import tempfile

import torch
from oece_tpu_torch.circuits import native
from oece_tpu_torch.fhe import ap, keycache, ntt, ntt_dev
from oece_tpu_torch.fhe.params import MICRO, BinFHEMethod
from oece_tpu_torch.parallel import mesh  # noqa: F401
from oece_tpu_torch.runtime import checkpoint  # noqa: F401

tmp = tempfile.mkdtemp()
os.environ["OECE_BAD_TRACE"] = "1"
c.Reset()
c.setVerify(True)
c.SetInput([np.array([[x & 1, x >> 1] for x, _ in cases]),
            np.array([[y & 1, y >> 1] for _, y in cases])])
c.Clock(checkpoint_path=os.path.join(tmp, "ck.npz"), checkpoint_every=1)
(out,) = c.GetOutput()
assert list((out << np.arange(out.shape[1])).sum(1)) == [x + y for x, y in cases]
assert not os.listdir(tmp) and len(c.bad_gate_lanes) == sum(c.bad_gate_counts.values())
assert native.available(), native.BUILD_ERROR
a = np.random.default_rng(0).integers(0, MICRO.Q, (2, 128))
assert np.array_equal(ntt_dev.ntt_forward_dev(torch.from_numpy(a)).numpy(), ntt.ntt_forward(a))
os.environ["OECE_KEY_CACHE"] = tmp
sk2, kt = keycache.load_or_generate(MICRO, BinFHEMethod.AP, seed=1, device="cpu")
acc = torch.zeros((1, 2, MICRO.N), dtype=torch.int32)
a2N = torch.ones((1, MICRO.n), dtype=torch.int32)
assert ap.blind_rotate_ap_generic(acc, kt.ap_ext, a2N, MICRO).shape == acc.shape
from oece_tpu_torch.tools import measure_noise, measure_xor_noise

assert measure_noise.run("MICRO", 10, 4, "rev2", "cpu", log=lambda m: None)["bootstraps"] == 40
fp_mul = "examples/new_bristol_ckts/fp/FP-mul.txt"
assert measure_xor_noise.scan_corpus([fp_mul], log=lambda m: None) > 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "jax" and sys.modules[m] is not None)
assert not loaded, loaded
jaxpkg = sorted(m for m in sys.modules if m.split(".")[0] == "oece_tpu")
assert not jaxpkg, jaxpkg
print("NOJAX_OK", c.trace.total_bootstraps)
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_OK 112" in proc.stdout, proc.stdout


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_sources_import_neither_jax_nor_the_jax_package():
    root = Path(REPO)
    files = sorted((root / "oece_tpu_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", root / "chip_profile.py"]
    assert len(files) > 10
    bad = [
        f"{f.relative_to(root)}:{line}: {name}"
        for f in files for line, name in _imported_roots(f)
        if name.split(".")[0] in ("jax", "jaxlib", "oece_tpu")
    ]
    assert not bad, bad
