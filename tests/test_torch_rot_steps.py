"""The port's per-step rotated-form path (oece_tpu_torch.fhe.rot
``rot_step_true``, ``blind_rotate_rot_steps``; ``boot.ROT_MEGA``) on the
CPU, bit for bit (tolerance 0), against the JAX package's
``OECE_ROT_MEGA=0`` scan of Pallas kernel #11 in interpret mode:

  * #11: ``rot_step_true`` (plain twin ``rot_step_plain``) equals
    ``pk.rot_step_true`` for any amount pairs (MICRO, MICRO_A, and TOY
    with zero_low_bits=1);
  * the rotation: ``blind_rotate_rot_steps`` equals ``blind_rotate_rot``
    and JAX ``blind_rotate_ginx_dev`` with ``ROT_MEGA = False`` on
    device-keygen rev2 keys carried across by ``from_jax``;
  * ``boot.ROT_MEGA`` (read from OECE_ROT_MEGA at import) picks the
    per-step path; whole Circuit verify runs with it off are in
    tests/test_torch_rot_steps_circuit.py.

The CUDA entry ``oece_rot_step`` is checked against the same plain twin on
the card by chip_smoke.py (phase rot-step).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import devkeygen as jdevkeygen
from oece_tpu.fhe import pallas_kernels as pk
from oece_tpu_torch.fhe import boot, devkeygen, keys, rot
from oece_tpu_torch.fhe.params import MICRO, MICRO_A, TOY
from test_torch_copies import jax_params

T = 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _zlb(p):
    return max(0, int(np.log2(2 * p.N // p.q)))


@pytest.mark.parametrize("params", [MICRO, MICRO_A, TOY], ids=lambda p: p.name)
def test_rot_step_true_matches_pallas(params):
    """#11 on a random block (any int8 bytes) and random amount pairs, not
    only the (2N - a, a) pairs of a rotation."""
    p = params
    rng = np.random.default_rng(p.N + p.d_g_used)
    B, zlb = 6, _zlb(p)
    nt, R = p.N // T, 2 * p.d_g_used
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)
    block = rng.integers(-128, 128, ((2 * nt - 1) * 2 * R * T, 8 * T)).astype(np.int8)
    amt = (rng.integers(0, 2 * p.N >> zlb, (B, 2)) << zlb).astype(np.int32)
    amt[0] = 0
    want = np.asarray(pk.rot_step_true(
        jnp.asarray(acc), jnp.asarray(block), jnp.asarray(amt), p.Q, p.B_g, p.d_g_used,
        p.g_shift, interpret=True, zero_low_bits=zlb,
    ))
    plain0 = rot.PLAIN_LAUNCHES
    got = rot.rot_step_true(_t(acc), _t(block), _t(amt), p)
    assert rot.PLAIN_LAUNCHES == plain0 + 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rot.rot_step_plain(_t(acc), _t(block), _t(amt), p).numpy(), want)
    out = torch.full_like(_t(acc), -1)
    assert rot.rot_step_true(_t(acc), _t(block), _t(amt), p, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.fixture(scope="module", params=[MICRO, MICRO_A], ids=lambda p: p.name)
def rev2_keys(request):
    p = request.param
    _, _, dkeys = jdevkeygen.device_keygen(jax_params(p), seed=7, layout="rev2")
    return p, dkeys, keys.from_jax(dkeys)


@pytest.mark.parametrize("B", [5, 16])
def test_steps_match_megakernel_path_and_jax(rev2_keys, B, monkeypatch):
    monkeypatch.setattr(jboot, "PALLAS_INTERPRET", True)
    monkeypatch.setattr(jboot, "ROT_MEGA", False)
    p, dkeys, kt = rev2_keys
    rng = np.random.default_rng(B)
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.int32)
    a2N = ((2 * p.N // p.q) * rng.integers(0, p.q, (B, p.n))).astype(np.int32)
    a2N[0] = 0
    a2N[:, ::3] = 0
    want = np.asarray(jboot.blind_rotate_ginx_dev(jnp.asarray(acc), jnp.asarray(a2N), dkeys))
    acc_t = _t(acc)
    plain0 = rot.PLAIN_LAUNCHES
    got = rot.blind_rotate_rot_steps(acc_t, kt.rev2, _t(a2N), p)
    assert rot.PLAIN_LAUNCHES == plain0 + p.n  # one plain step per key step
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(acc_t.numpy(), acc)  # the input is not written
    np.testing.assert_array_equal(rot.blind_rotate_rot(acc_t, kt.rev2, _t(a2N), p).numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), acc[0])  # the a=0 lane


def test_boot_rot_mega_switch(monkeypatch):
    """boot.ROT_MEGA picks the rotation of rev2 keys; both give the same
    gates."""
    p = MICRO
    sk, kt = devkeygen.device_keygen(p, np.arange(8, dtype=np.uint32), "cpu", layout="rev2")
    rng = np.random.default_rng(6)
    B = 6
    gids = _t((np.arange(B) % 6).astype(np.int32))
    c1 = _t(rng.integers(0, p.q, (B, p.n + 1)).astype(np.int32))
    c2 = _t(rng.integers(0, p.q, (B, p.n + 1)).astype(np.int32))
    assert boot.ROT_MEGA  # the default
    plain0 = rot.PLAIN_LAUNCHES
    mega = boot.eval_bin_gate_batch(kt, gids, c1, c2)
    assert rot.PLAIN_LAUNCHES == plain0 + 1
    monkeypatch.setattr(boot, "ROT_MEGA", False)
    steps = boot.eval_bin_gate_batch(kt, gids, c1, c2)
    assert rot.PLAIN_LAUNCHES == plain0 + 1 + p.n
    assert torch.equal(mega, steps)


def test_rot_mega_read_from_environment():
    code = "import oece_tpu_torch.fhe.boot as b; print(b.ROT_MEGA)"
    env = dict(os.environ, OECE_ROT_MEGA="0", PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert res.stdout.split()[-1] == "False"


def test_step_refuses_bad_input():
    p = MICRO_A
    nt, R, B = p.N // T, 2 * p.d_g_used, 3
    acc = torch.zeros((B, 2, p.N), dtype=torch.int32)
    block = torch.zeros(((2 * nt - 1) * 2 * R * T, 8 * T), dtype=torch.int8)
    amt = torch.zeros((B, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="bad shapes"):
        rot.rot_step_true(acc, block, torch.zeros((B, 1), dtype=torch.int32), p)
    with pytest.raises(ValueError, match="bad shapes"):
        rot.rot_step_true(acc, block[None], amt, p)
    with pytest.raises(ValueError, match="bad shapes"):
        rot.blind_rotate_rot_steps(acc, block[None], amt, p)
    counts = (rot.LAUNCHES, rot.SINGLE_STEP_LAUNCHES, rot.PLAIN_LAUNCHES)
    with pytest.raises(ValueError, match="no kernel"):
        rot.rot_step_true(acc.to("meta"), block.to("meta"), amt.to("meta"), p)
    with pytest.raises(ValueError, match="no kernel"):
        rot.blind_rotate_rot_steps(acc.to("meta"), block[None].to("meta"), amt[:, :1].contiguous().to("meta"), p)
    assert (rot.LAUNCHES, rot.SINGLE_STEP_LAUNCHES, rot.PLAIN_LAUNCHES) == counts
