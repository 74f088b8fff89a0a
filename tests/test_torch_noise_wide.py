"""The port's noise tools against the JAX tools' step bodies
(tests/test_torch_noise.py's checks) at STD128_OPT's widths: N, Q, Q_ks,
the gadget and key-switch bases as published, the LWE dimension n cut to 4
rotation steps.  The whole gate path at production widths (prep, rotation,
extract, both modulus switches, the key switch and its rounding) and the
tools' histograms agree in both packages on the same golden keys, bit for
bit.  Also chip_smoke.key_switch_mean, which predicts a key's noise mean
from its key-switch key: it reads back the errors drawn into a full-size
STD128_OPT key exactly."""

import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from oece_tpu_torch.fhe import boot, devkeygen
from oece_tpu_torch.fhe.params import STD128_OPT
from test_torch_noise import check_first_batch, check_noise_chunk, check_xor_chunk, make_setup
from test_torch_std import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    return make_setup(dataclasses.replace(STD128_OPT, n=4))


def test_first_batch_draws_as_the_jax_tools_wide(setup):
    check_first_batch(setup)


def test_noise_chunk_matches_jax_wide(setup):
    check_noise_chunk(setup)


@pytest.mark.parametrize("gate_id", [4, 0])  # XOR (weights 2, -2), AND (1, 1)
def test_xor_chunk_matches_jax_wide(setup, gate_id):
    check_xor_chunk(setup, gate_id)


def test_key_switch_mean_reads_the_key_errors():
    """key_switch_mean on a key-switch key made from known draws (device
    keygen's streams on the CPU, seed 3): the errors' mean it reads back
    and its prediction, -sum_k E[d_k] * sum_j e_jk * q / Q_ks, are those of
    the drawn errors."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    p = STD128_OPT
    words = np.zeros(8, np.uint32)
    words[0] = 3
    s, z, _, _, Aks, Eks = devkeygen.sample(p, devkeygen.seed_generators(words, "cpu"))
    keys = types.SimpleNamespace(params=p, ksk=devkeygen.keyswitch_key(p, s, z, Aks, Eks))
    got, e_mean = cs.key_switch_mean(types.SimpleNamespace(s=s.numpy()), keys)
    digit_means = boot.signed_digits_dev(torch.arange(p.Q_ks), p.B_ks, p.d_ks).double().mean(0)
    sums = Eks.double().reshape(p.N, p.d_ks).sum(0)
    assert e_mean == pytest.approx(float(Eks.double().mean()), abs=1e-12)
    assert got == pytest.approx(float(-(digit_means * sums).sum() * p.q / p.Q_ks), abs=1e-9)
    assert digit_means[:-1].eq(-0.5).all()
