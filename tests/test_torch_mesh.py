"""The port's mesh (oece_tpu_torch/parallel/mesh.py, process groups on
torch.distributed) on the CPU: gloo with 2 processes here, 4 in
tests/test_torch_mesh_four.py.

  * tests/test_parallel.py's setup (MICRO golden GINX keys, the JAX
    package's jnp layout, seed 21): the sharded gate batch on a (dp, tp)
    mesh, tp in {1, 2, 4}, equals the JAX package's unsharded
    ``boot.eval_bin_gate_batch`` bit for bit;
  * dp-mesh ``Circuit``s (adder_2bit verify, T = 4) on device rev2 keys,
    on host GINX keys (under a dp x tp mesh too) and on AP keys equal the
    port's unsharded ``Circuit`` bit for bit: outputs, ciphertext arena
    and counts;
  * ``mesh.dryrun(4)``, the counterpart of
    ``__graft_entry__.dryrun_multichip`` (test_torch_mesh_four.py).

Each rank runs the same program on the same seeds; the ranks' processes
are spawned by ``torch.multiprocessing`` (they import this module)."""

import os
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from oece_tpu.fhe import boot as jboot
from oece_tpu.fhe import golden as jgolden
from oece_tpu.fhe import lwe as jlwe
from oece_tpu.fhe.params import MICRO, BinFHEMethod
from oece_tpu_torch.fhe import keys, std
from oece_tpu_torch.fhe import negacyclic as ng
from oece_tpu_torch.parallel import mesh as mesh_mod
from test_torch_copies import port_bootstrap_key

ADDER = os.path.join(
    os.path.dirname(__file__), "..", "examples", "simple_ckts", "adder_2bit", "adder_2bit.out"
)


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gate_case(tp_list, world):
    """JAX references for each tp: (tp, kt, gids, c1, c2, want)."""
    rng = np.random.default_rng(21)
    sk = jgolden.lwe_keygen(MICRO, rng)
    bk = jgolden.bootstrap_keygen(MICRO, sk, rng, BinFHEMethod.GINX)
    dk = jboot.pack_bootstrap_key(bk, use_pallas=False)
    kt = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    cases = []
    rng = np.random.default_rng(5)
    for tp in tp_list:
        B = 2 * (world // tp) + 1  # not a multiple of dp: the batch is padded
        m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
        c1 = jlwe.encrypt_bits(sk, m1, rng)
        c2 = jlwe.encrypt_bits(sk, m2, rng)
        gids = rng.integers(0, 6, B).astype(np.int32)
        want = np.asarray(jboot.eval_bin_gate_batch(dk, jnp.asarray(gids), jnp.asarray(c1), jnp.asarray(c2)))
        cases.append((tp, gids, c1, c2, want))
    return kt, cases


def _circuit_run(mesh, layout_env, method, ins):
    from oece_tpu_torch.runtime.evaluator import Circuit

    old = {k: os.environ.get(k) for k in layout_env}
    os.environ.update(layout_env)
    try:
        c = Circuit(set="MICRO", method=method, seed=3, device="cpu", mesh=mesh)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    c.ReadFile(ADDER)
    c.setVerify(True)
    c.SetInput(ins)
    c.Clock()
    return c


def _rank(rank, world, port, kt, cases, circuits):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        for tp, gids, c1, c2, want in cases:
            mesh = mesh_mod.make_mesh(world, tp=tp, device="cpu")
            before = dict(ng.PLAIN_LAUNCHES), std.PLAIN_LAUNCHES
            got = mesh_mod.eval_bin_gate_sharded(
                mesh_mod.shard_bootstrap_keys(kt, mesh), torch.from_numpy(gids),
                torch.from_numpy(c1), torch.from_numpy(c2), mesh)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"rank {rank}, tp={tp}")
            # tp > 1 runs each step through #5 and #6 (their plain twins on
            # the CPU), never the unsharded std rotation; tp = 1 the reverse
            steps = kt.params.n if tp > 1 else 0
            used = {k: ng.PLAIN_LAUNCHES[k] - before[0][k] for k in ng.KERNELS}
            assert used == {**dict.fromkeys(ng.KERNELS, 0), "negacyclic_matmul": steps,
                            "cmux_epilogue": steps}, (tp, used)
            assert std.PLAIN_LAUNCHES - before[1] == (tp == 1)
        ins = [np.array([[1, 0], [0, 1], [1, 1], [0, 0]]), np.array([[1, 1], [1, 0], [1, 1], [0, 1]])]
        for tp, env, method in circuits:
            mesh = mesh_mod.make_mesh(world, tp=tp, device="cpu")
            a = _circuit_run(mesh, env, method, ins)
            b = _circuit_run(None, env, method, ins)
            assert not a._dev_branch, "a mesh runs the host branch by default"
            for x, y in zip(a.GetOutput(), b.GetOutput()):
                np.testing.assert_array_equal(x, y)
            assert torch.equal(a._ct_arena, b._ct_arena), (tp, env, method)
            assert a.bad_gate_counts == b.bad_gate_counts == {} and a.gate_counts == b.gate_counts
            got = a.GetOutput()[0] @ (1 << np.arange(3))
            np.testing.assert_array_equal(got, ins[0] @ (1 << np.arange(2)) + ins[1] @ (1 << np.arange(2)))
    finally:
        dist.destroy_process_group()


def _spawn(world, kt, cases, circuits):
    mp.spawn(_rank, args=(world, _port(), kt, cases, circuits), nprocs=world, join=True)


def test_two_processes():
    """tp = 1 and 2 on two ranks, and dp = 2 Circuits on rev2, host GINX
    and generic-base AP keys, and a tp = 2 Circuit on host keys."""
    kt, cases = _gate_case([1, 2], 2)
    circuits = [
        (1, {"OECE_LAYOUT": "rev2"}, "GINX"),
        (1, {"OECE_HOST_KEYGEN": "1"}, "GINX"),
        (1, {}, "AP"),
        (2, {"OECE_HOST_KEYGEN": "1"}, "GINX"),  # tp > 1 draws host keys in any case
    ]
    _spawn(2, kt, cases, circuits)


def test_mesh_refusals():
    """make_mesh needs a process group; tp > 1 needs host GINX keys; AP
    shards dp-only; a batch pads to a multiple of dp; the tp rotation has
    no kernel for a device other than the CPU and the card."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_mod.make_mesh(1)
    m = mesh_mod.Mesh(dp=1, tp=2, dp_rank=0, tp_rank=0, dp_group=None, tp_group=None,
                      device=torch.device("cpu"))
    from oece_tpu_torch.fhe.params import MICRO as PM
    from oece_tpu_torch.runtime.evaluator import Circuit

    c = Circuit(set=PM, seed=1, device="cpu")  # device rev2 keys
    with pytest.raises(ValueError, match="host GINX keys"):
        mesh_mod.shard_bootstrap_keys(c.keys, m)
    with pytest.raises(ValueError, match="dp-only"):
        Circuit(set="MICRO", method="AP", seed=1, device="cpu", mesh=m)
    assert mesh_mod.padded_batch(5, 6) == 6 and mesh_mod.padded_batch(100, 1) == 100
    assert mesh_mod.padded_batch(7, 2) == 8 and mesh_mod.padded_batch(8, 4) == 8
    acc = torch.zeros((1, 2, PM.N), dtype=torch.int32, device="meta")
    ext = torch.zeros((PM.n, PM.d_g_used, 16, 2 * PM.N), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        std.blind_rotate_std_tp(acc, ext, torch.zeros((1, PM.n), dtype=torch.int32, device="meta"), PM, m)
    with pytest.raises(ValueError, match="key rows"):  # unsharded keys on a tp = 2 rank
        std.blind_rotate_std_tp(torch.zeros((1, 2, PM.N), dtype=torch.int32),
                                torch.zeros((PM.n, 2 * PM.d_g_used, 16, 2 * PM.N), dtype=torch.int8),
                                torch.zeros((1, PM.n), dtype=torch.int32), PM, m)


class _FakeLib:
    """The kernel library's entry points of #5 and #6, returning 0."""

    def __init__(self):
        self.calls = []

    def oece_negacyclic_matmul(self, *args) -> int:
        self.calls.append("negacyclic_matmul")
        return 0

    def oece_cmux_epilogue_true(self, *args) -> int:
        self.calls.append("cmux_epilogue")
        return 0


def test_tp_rotation_launches_on_the_card(monkeypatch):
    """A CUDA tensor no longer raises: with the device check, the kernel
    library and the all-reduce stubbed, each step of the tp rotation
    launches #5 then #6, counted in their own LAUNCHES and no plain twin
    runs (the kernels themselves run on the card: chip_smoke.py tp)."""
    from oece_tpu_torch.fhe import rev
    from oece_tpu_torch.fhe.params import MICRO as PM

    lib = _FakeLib()
    monkeypatch.setattr(rev, "_on_card", lambda name, *ts: True)
    monkeypatch.setattr(rev, "_aligned", lambda name, *ts: None)
    monkeypatch.setattr(rev, "_stream", lambda t: 0)
    monkeypatch.setattr(rev._build, "load", lambda: lib)
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: None)
    m = mesh_mod.Mesh(dp=1, tp=2, dp_rank=0, tp_rank=1, dp_group=None, tp_group=None,
                      device=torch.device("cpu"))
    n = 3
    acc = torch.zeros((2, 2, PM.N), dtype=torch.int32)
    ext = torch.zeros((n, PM.d_g_used, 16, 2 * PM.N), dtype=torch.int8)
    launches, plain = dict(ng.LAUNCHES), dict(ng.PLAIN_LAUNCHES)
    std.blind_rotate_std_tp(acc, ext, torch.zeros((2, n), dtype=torch.int32), PM, m)
    assert lib.calls == ["negacyclic_matmul", "cmux_epilogue"] * n
    assert {k: ng.LAUNCHES[k] - launches[k] for k in ng.KERNELS} == {
        **dict.fromkeys(ng.KERNELS, 0), "negacyclic_matmul": n, "cmux_epilogue": n}
    assert ng.PLAIN_LAUNCHES == plain


def test_make_mesh_defaults_to_the_card(monkeypatch):
    """make_mesh() with no device takes the current CUDA device under any
    backend: on a host without CUDA it raises, where it used to pick the
    CPU under gloo; device="cpu" still gives a CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_port()}", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh_mod.make_mesh(1)
        m = mesh_mod.make_mesh(1, device="cpu")
        assert m.device == torch.device("cpu") and (m.dp, m.tp) == (1, 1)
    finally:
        dist.destroy_process_group()
