"""The port's TB harness on the hash and 64-bit arithmetic benches,
plaintext only (md5, sha1, sha256, sha512, keccak, arith64, as ``tb.py``
names them, on the repo's
``examples/``): the JAX package's ``HarnessResult`` apart from ``seconds``
(tests/test_torch_testlib.py has the others)."""

import pytest

from test_torch_testlib import assert_bench_plaintext_matches


@pytest.mark.parametrize("name", ["md5", "sha1", "sha256", "sha512", "keccak", "arith64"])
def test_bench_plaintext_matches_jax(name):
    assert_bench_plaintext_matches(name)
