"""The port's key cache (oece_tpu_torch/fhe/keycache.py): a round trip
through its own directory, the keys equal to a fresh golden host keygen
(and so to the JAX package's golden keys packed), and the shape checks."""

import os

import numpy as np
import pytest
import torch

from oece_tpu.fhe import golden as jgolden
from oece_tpu.fhe import params as jparams
from oece_tpu_torch.fhe import keycache, keys
from oece_tpu_torch.fhe.params import MICRO, BinFHEMethod
from test_torch_copies import port_bootstrap_key


@pytest.mark.parametrize("method", [BinFHEMethod.GINX, BinFHEMethod.AP])
def test_round_trip(tmp_path, monkeypatch, method):
    monkeypatch.setenv("OECE_KEY_CACHE", str(tmp_path))
    sk, kt = keycache.load_or_generate(MICRO, method, seed=4, device="cpu")
    path = keycache.key_path(MICRO, method, 4)
    assert os.path.dirname(path) == str(tmp_path / "oece_tpu_torch") and os.path.exists(path)
    sk2, kt2 = keycache.load_or_generate(MICRO, method, seed=4, device="cpu")  # from the file
    np.testing.assert_array_equal(sk2.s, sk.s)
    field = "ginx_ext" if method == BinFHEMethod.GINX else "ap_ext"
    for f in ("ksk", "tv_table", field):
        assert torch.equal(getattr(kt2, f), getattr(kt, f)), f
    # golden's keys from the same seed, packed
    rng = np.random.default_rng(4)
    jsk = jgolden.lwe_keygen(jparams.MICRO, rng)
    bk = jgolden.bootstrap_keygen(jparams.MICRO, jsk, rng, jparams.BinFHEMethod[method.name])
    want = keys.pack_bootstrap_key(port_bootstrap_key(bk), "cpu")
    np.testing.assert_array_equal(sk.s, jsk.s)
    assert torch.equal(getattr(kt, field), getattr(want, field)) and torch.equal(kt.ksk, want.ksk)
    # another seed is another file
    assert keycache.key_path(MICRO, method, 5) != path


def test_shape_checks(tmp_path, monkeypatch):
    """A cached key whose shapes are not its parameters' is refused."""
    monkeypatch.setenv("OECE_KEY_CACHE", str(tmp_path))
    keycache.load_or_generate(MICRO, BinFHEMethod.GINX, seed=1, device="cpu")
    path = keycache.key_path(MICRO, BinFHEMethod.GINX, 1)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["ginx_ext"] = arrays["ginx_ext"][:-1]
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="cached key shapes"):
        keycache.load_or_generate(MICRO, BinFHEMethod.GINX, seed=1, device="cpu")
    arrays["ginx_ext"] = np.zeros((MICRO.n, 2 * MICRO.d_g_used, 16, 2 * MICRO.N), np.int8)
    arrays["s"] = arrays["s"][:-1]
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="cached key shapes"):
        keycache.load_or_generate(MICRO, BinFHEMethod.GINX, seed=1, device="cpu")
