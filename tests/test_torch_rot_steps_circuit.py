"""The port's ``Circuit`` with ``boot.ROT_MEGA`` off (``OECE_ROT_MEGA=0``:
one ``rot.rot_step_true`` call per key step) on the CPU against the JAX
package's ``Circuit`` with its ``ROT_MEGA`` off (device-keygen rev2 keys,
the lax.scan of Pallas #11 in interpret mode): with the JAX circuit's keys,
secret and a copy of its generator injected, whole verify runs agree bit
for bit (ciphertext arena, outputs, gate counts, verify repairs)."""

import pytest

from oece_tpu.fhe import boot as jboot
from oece_tpu.runtime.evaluator import Circuit as JaxCircuit
from oece_tpu_torch.fhe import boot, keys, rot
from test_torch_evaluator import CIRCUITS, _assert_same, _inputs, _twin


@pytest.fixture(scope="module", params=["MICRO_A", "MICRO"])
def jax_steps_circuit(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("OECE_FORCE_DEVICE_KEYGEN", "1")
    mp.setattr(jboot, "PALLAS_INTERPRET", True)
    mp.setattr(jboot, "ROT_MEGA", False)
    mp.setattr(boot, "ROT_MEGA", False)
    jc = JaxCircuit(set=request.param, method="GINX", seed=5)
    assert jc.dkeys.ginx_rev2 is not None
    yield jc, keys.from_jax(jc.dkeys)
    mp.undo()


@pytest.mark.parametrize("name", ["adder_2bit", "adder4"])
def test_rot_mega_off_verify_run_matches_jax(jax_steps_circuit, name):
    jc, kt = jax_steps_circuit
    build, T_ = CIRCUITS[name]
    nl = build()
    tc = _twin(jc, kt, nl, True, True, True)
    ins = _inputs(nl, T_, seed=len(name))
    jc.SetInput(ins)
    tc.SetInput(ins)
    plain0 = rot.PLAIN_LAUNCHES
    jc.Clock()
    tc.Clock()
    _assert_same(jc, tc)
    boot_levels = sum(1 for r in tc.trace.records if r.boot_gates)
    assert rot.PLAIN_LAUNCHES - plain0 == boot_levels * jc.params.n  # one call per step
