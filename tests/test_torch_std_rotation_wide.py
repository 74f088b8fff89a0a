"""The port's standard-form GINX step and rotation at the STD128_OPT
(approximate gadget, R = 4) and STD128 (exact gadget, R = 8) shapes with
n = 2 steps, against the interpret-mode Pallas step, the jnp step and the
golden standard step, bit for bit (test_torch_std_rotation.check_rotation)."""

import pytest

from oece_tpu.fhe import boot as jboot
from test_torch_std_rotation import check_rotation


@pytest.mark.parametrize("name", ["STD128_OPT", "STD128"])
def test_rotation_matches_jax_and_golden_wide(name, monkeypatch):
    monkeypatch.setattr(jboot, "PALLAS_INTERPRET", True)
    check_rotation(name, {"n": 2}, 2, 3)
