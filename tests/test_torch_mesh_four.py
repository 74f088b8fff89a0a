"""The port's mesh on four gloo processes (the helpers and the 2-process
cases are tests/test_torch_mesh.py): the sharded gate batch at tp = 1, 2
and 4 against the JAX package's unsharded ``boot.eval_bin_gate_batch``, a
dp = 2 x tp = 2 ``Circuit`` against the unsharded one, bit for bit, and
``mesh.dryrun(4)``."""

from oece_tpu_torch.parallel import mesh as mesh_mod
from test_torch_mesh import _gate_case, _spawn


def test_four_processes():
    """tp = 1, 2 and 4 on four ranks, and a dp = 2 x tp = 2 Circuit."""
    kt, cases = _gate_case([1, 2, 4], 4)
    _spawn(4, kt, cases, [(2, {"OECE_HOST_KEYGEN": "1"}, "GINX")])


def test_dryrun_four():
    mesh_mod.dryrun(4)
