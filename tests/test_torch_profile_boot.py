"""The port's step profiler (oece_tpu_torch.tools.profile_boot) on the CPU
(``--device cpu``) at TOY, 3 steps, B = 4, tolerance 0:

  * its command line runs every scan and prints one line each;
  * scan A (the full CMUX step on golden host keys) == std.blind_rotate_std
    on the same inputs, and every step of scan G (#1 then #3, raw limb
    sums), combined, == scan D's step (#1 then #2);
  * its keys are the JAX tool's: golden host keys of seed 0, packed by the
    JAX package with ``pack_bootstrap_key(bk, use_pallas=True)``, equal the
    tool's ginx_ext, and one step of scan G on them equals
    ``pk.negacyclic_matmul_split`` in interpret mode on the JAX windows.

chip_smoke.py runs the tool at full width on the card (phase
profile-boot).
"""

import numpy as np
import torch

import jax.numpy as jnp
from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import golden as jgolden
from oece_tpu.fhe import pallas_kernels as pk
from oece_tpu.fhe.params import TOY as JTOY
from oece_tpu.fhe.params import BinFHEMethod as JMethod
from oece_tpu_torch.fhe import keys, negacyclic, rot, std
from oece_tpu_torch.fhe.params import TOY
from oece_tpu_torch.tools import profile_boot as pb


def test_command_line_runs_every_scan(capsys):
    plain = dict(negacyclic.PLAIN_LAUNCHES)
    res = pb.main(["4", "--set", "TOY", "--steps", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "TOY B=4 steps=3 on cpu"
    assert [ln.split(":")[0] for ln in lines[1:]] == list(pb.SCANS) and set(res) == set(pb.SCANS)
    assert all(ln.endswith("us/step") for ln in lines[1:])
    # 1 + REPS runs of each scan of 3 steps, plain twins only
    assert pb.REPS == 2
    assert {k: negacyclic.PLAIN_LAUNCHES[k] - plain[k] for k in negacyclic.KERNELS} == {
        "build_diagonals": 54, "diag_matmul": 9, "negacyclic_matmul": 9,
        "window_matmul": 45, "cmux_epilogue": 9, "build_rev_conj": 9,
    }


def test_scans_match_the_rotation():
    inp = pb.make_inputs(TOY, 4, 3, "cpu")
    assert inp.ext.shape == (3, 2 * TOY.d_g_used, 16, 2 * TOY.N) and inp.a2N.shape == (4, 3)
    want = std.blind_rotate_std(inp.acc0, inp.ext, inp.a2N, TOY)
    assert torch.equal(pb.scan("A", inp), want)
    for i in range(3):
        raw = negacyclic.negacyclic_matmul_split(inp.digs0, inp.ext[i])
        P4 = negacyclic.negacyclic_matmul_window(inp.digs0, inp.ext[i], TOY.Q)
        assert torch.equal(rot.combine_planes(raw, TOY.Q), P4)


def test_keys_and_scan_g_match_jax():
    rng = np.random.default_rng(0)  # the JAX tool's key cache, seed 0
    sk = jgolden.lwe_keygen(JTOY, rng)
    dk = jboot.pack_bootstrap_key(jgolden.bootstrap_keygen(JTOY, sk, rng, JMethod.GINX), use_pallas=True)
    inp = pb.make_inputs(TOY, 4, 1, "cpu")
    ext = keys.from_jax(dk).ginx_ext
    assert torch.equal(ext[:1], inp.ext)
    R, nt = 2 * TOY.d_g_used, TOY.N // 128
    dt = jnp.asarray(inp.digs0.numpy().reshape(4, nt, -1).transpose(1, 0, 2))
    want = np.asarray(pk.negacyclic_matmul_split(dt, dk.ginx_pallas[0], R, interpret=True))
    np.testing.assert_array_equal(negacyclic.negacyclic_matmul_split(inp.digs0, ext[0]).numpy(), want)
