"""Process-group parallelism for batched gate bootstrapping (counterpart of
oece_tpu.parallel.mesh on ``torch.distributed``).

The JAX package maps the reference's OpenMP gate parallelism onto a
(dp, tp) device mesh with ``shard_map``.  Here the mesh is a (dp, tp)
layout of process groups over the ranks of an initialised default group
(one process per device; every rank runs the same program on the same
seeds, so each holds the same keys and ciphertext arena):

  * ``dp`` (data parallel): each level's gate x case batch is padded to
    a multiple of dp (the JAX package's 32*2^k buckets fit its jit shapes;
    the port has none) and split across the dp ranks; each rank bootstraps its shard on its own device with the
    replicated keys, through the same rotation as an unsharded batch, and
    ``all_gather`` reassembles the batch.  Every key layout and both
    methods shard this way.
  * ``tp`` (tensor parallel), on host GINX keys (ginx_ext) only, as in the
    JAX package: each rank keeps R/tp rows of every step key and 1/tp of
    the key-switch key's contraction rows.  Per step it computes the
    digits of its rows times its key rows as raw limb sums (kernel #5 on
    the card), an ``all_reduce`` sums them over the tp group, then the
    limb combine mod Q and the CMUX (#6) follow
    (``std.blind_rotate_std_tp``); the key switch sums its partial
    products the same way (``boot.key_switch_dev``).  On CPU ranks the
    wrappers run their plain twins, on the card their kernels.

``make_mesh`` builds the groups (every rank calls it, in the same order)
on the current CUDA device unless ``device`` says otherwise (the CPU
ranks of the tests and ``dryrun`` pass ``device="cpu"``);
``shard_bootstrap_keys`` cuts a rank's keys to its tp shard;
``eval_bin_gate_sharded`` and ``bootstrap_sharded`` run one batch.
``dryrun(n)`` spawns n CPU processes on gloo and checks the sharded gate
batch and a dp x tp Circuit against unsharded runs (the counterpart of
``__graft_entry__.dryrun_multichip``).

NCCL takes one rank per GPU and is the route over several cards.  gloo
takes CUDA tensors too, staged through the host: its ``all_reduce`` takes
them as they are, its ``all_gather`` does not, so the dp gather copies
the shard to the host and back under gloo, and skips the gather at dp =
1.  So several gloo processes can share one card, as chip_smoke.py's
``tp`` phase runs a (1, 2) mesh of two processes on ``cuda:0``.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..fhe import boot
from ..fhe.keys import BootKeys
from ..fhe.params import BinFHEMethod


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (dp, tp) layout of ranks r = d*tp + t."""

    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: object
    tp_group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, device=None) -> Mesh:
    """The (dp, tp) mesh over all ranks of the default process group
    (``n_devices``, if given, must equal the world size).  Every rank must
    call it: it creates each dp and each tp group in the same order on all
    ranks.  ``device`` defaults to the current CUDA device, whatever the
    backend; CPU ranks pass ``device="cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked for, the process group has {world} ranks")
    if tp < 1 or n % tp:
        raise ValueError(f"make_mesh: tp={tp} does not divide {n} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; CPU ranks pass device='cpu'")
        device = torch.device("cuda", torch.cuda.current_device())
    grid = np.arange(n).reshape(n // tp, tp)
    dp_groups = [dist.new_group([int(r) for r in grid[:, t]]) for t in range(tp)]
    tp_groups = [dist.new_group([int(r) for r in grid[d, :]]) for d in range(n // tp)]
    d, t = divmod(rank, tp)
    return Mesh(dp=n // tp, tp=tp, dp_rank=d, tp_rank=t, dp_group=dp_groups[t],
                tp_group=tp_groups[d], device=torch.device(device))


def padded_batch(B: int, dp: int) -> int:
    """The least multiple of ``dp`` that holds ``B`` lanes: no padding on a
    one-rank dp axis."""
    return -(-B // dp) * dp


def shard_bootstrap_keys(keys: BootKeys, mesh: Mesh) -> BootKeys:
    """This rank's keys on ``mesh``: all of them for tp = 1 (dp only); for
    tp > 1 (ginx_ext keys only) rows [t*R/tp, (t+1)*R/tp) of every step
    key and rows [t*K/tp, (t+1)*K/tp) of the key switch's K = N*d_ks."""
    if mesh.tp == 1:
        return keys
    if keys.method == BinFHEMethod.AP:
        raise ValueError("AP shards dp-only: build the mesh with tp=1")
    if keys.ginx_ext is None:
        raise ValueError("tp > 1 shards host GINX keys (ginx_ext) only; the prebuilt "
                         "rev/rev2 layouts shard dp-only: build the mesh with tp=1")
    R, K = keys.ginx_ext.shape[1], keys.ksk.shape[0]
    if R % mesh.tp or K % mesh.tp:
        raise ValueError(f"tp={mesh.tp} does not divide the {R} key rows and {K} key-switch rows")
    r, k = R // mesh.tp, K // mesh.tp
    t = mesh.tp_rank
    return dataclasses.replace(
        keys, ginx_ext=keys.ginx_ext[:, t * r:(t + 1) * r].contiguous(),
        ksk=keys.ksk[t * k:(t + 1) * k].contiguous(),
    )


def bootstrap_sharded(prep: torch.Tensor, gate_ids: torch.Tensor, keys: BootKeys, mesh: Mesh) -> torch.Tensor:
    """``boot.bootstrap_batch`` of prep [B, n+1] across the mesh: padded to
    ``padded_batch(B, dp)`` with zero lanes, this rank's dp shard through
    the rotation (tp > 1: the tp-sharded one over ``keys``, this rank's
    shard), the shards gathered over the dp group; returns [B, n+1] on
    every rank."""
    B = prep.shape[0]
    Bp = padded_batch(B, mesh.dp)
    if Bp != B:
        prep = torch.cat([prep, prep.new_zeros((Bp - B, prep.shape[1]))])
        gate_ids = torch.cat([gate_ids, gate_ids.new_zeros(Bp - B)])
    shard = Bp // mesh.dp
    lo = mesh.dp_rank * shard
    out = boot.bootstrap_batch(prep[lo:lo + shard], gate_ids[lo:lo + shard], keys,
                               tp=mesh if mesh.tp > 1 else None)
    if mesh.dp == 1:
        return out
    # gloo gathers host tensors only: a CUDA shard goes through the host
    staged = out.is_cuda and dist.get_backend(mesh.dp_group) == "gloo"
    local = out.cpu() if staged else out.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.dp)]
    dist.all_gather(parts, local, group=mesh.dp_group)
    return torch.cat(parts)[:B].to(out.device)


def eval_bin_gate_sharded(keys: BootKeys, gate_ids, ct1, ct2, mesh: Mesh) -> torch.Tensor:
    """Batched EvalBinGate over the mesh (keys: this rank's
    ``shard_bootstrap_keys``)."""
    prep = boot.prepare_gates(ct1, ct2, gate_ids, keys.params.q)
    return bootstrap_sharded(prep, gate_ids, keys, mesh)


# -- the CPU dry run ---------------------------------------------------------

ADDER_2BIT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples", "simple_ckts",
    "adder_2bit", "adder_2bit.out",
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, world: int, port: int, tp: int) -> None:
    from ..fhe import golden, hostkeygen, lwe
    from ..fhe.params import MICRO
    from ..runtime.evaluator import Circuit

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        mesh = make_mesh(world, tp=tp, device="cpu")
        rng = np.random.default_rng(0)
        sk = golden.lwe_keygen(MICRO, rng)
        keys = hostkeygen.bootstrap_keygen(MICRO, sk, rng, BinFHEMethod.GINX, "cpu")
        B = 8 * mesh.dp
        bits = rng.integers(0, 2, B)
        c1 = torch.from_numpy(lwe.encrypt_bits(sk, bits, rng))
        c2 = torch.from_numpy(lwe.encrypt_bits(sk, 1 - bits, rng))
        gids = torch.from_numpy(rng.integers(0, 6, B).astype(np.int32))
        got = eval_bin_gate_sharded(shard_bootstrap_keys(keys, mesh), gids, c1, c2, mesh)
        want = boot.eval_bin_gate_batch(keys, gids, c1, c2)
        if not torch.equal(got, want):
            raise AssertionError(f"rank {rank}: the sharded gate batch differs from the unsharded one")

        # a circuit Clock()ed with every level's batch sharded, against the same
        # circuit unsharded (same seed: same keys, inputs and repairs; host
        # keys in both, as a tp > 1 mesh draws them)
        os.environ["OECE_HOST_KEYGEN"] = "1"
        ins = [rng.integers(0, 2, (4, 2)), rng.integers(0, 2, (4, 2))]
        outs = []
        for m in (mesh, None):
            c = Circuit(set="MICRO", seed=0, device="cpu", mesh=m)
            c.ReadFile(ADDER_2BIT)
            c.setVerify(True)
            c.SetInput(ins)
            c.Clock()
            if c.bad_gate_counts:
                raise AssertionError(f"rank {rank}: verify repaired {c.bad_gate_counts}")
            outs.append((c.GetOutput()[0], c._ct_arena))
        want_sum = ins[0] @ (1 << np.arange(2)) + ins[1] @ (1 << np.arange(2))
        got_sum = outs[0][0] @ (1 << np.arange(outs[0][0].shape[1]))
        if not (np.array_equal(got_sum, want_sum) and torch.equal(outs[0][1], outs[1][1])):
            raise AssertionError(f"rank {rank}: the sharded circuit differs from the unsharded one")
        if rank == 0:
            print(f"dryrun: OK on {world} gloo processes (dp={mesh.dp}, tp={tp}): batch of {B} "
                  "gates and adder_2bit verify, T=4, bit-identical to unsharded runs", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun(n: int, tp: Optional[int] = None) -> None:
    """Spawn ``n`` CPU processes on gloo (tcp://localhost, a free port) and
    check, on a (n/tp, tp) mesh (tp = 2 for even n, else 1, as the JAX
    package's dryrun), a MICRO gate batch and a verify-mode adder_2bit
    Circuit against their unsharded runs, bit for bit; raises if any rank
    fails."""
    import torch.multiprocessing as mp

    tp = (2 if n % 2 == 0 else 1) if tp is None else tp
    mp.spawn(_dryrun_rank, args=(n, _free_port(), tp), nprocs=n, join=True)
