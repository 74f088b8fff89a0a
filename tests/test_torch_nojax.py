"""The port runs without JAX: a fresh interpreter with ``jax`` blocked
imports oece_tpu_torch, generates MICRO keys with the port's own keygen and
clocks adder_2bit to the right sums in verify mode (what chip_smoke.py needs
on a machine that has no JAX)."""

import os
import subprocess
import sys

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
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "jax" and sys.modules[m] is not None)
assert not loaded, loaded
for m in ("oece_tpu.fhe.boot", "oece_tpu.fhe.devkeygen", "oece_tpu.runtime.evaluator",
          "oece_tpu.fhe.pallas_kernels", "oece_tpu.harness.testlib"):
    assert m not in sys.modules, m
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
