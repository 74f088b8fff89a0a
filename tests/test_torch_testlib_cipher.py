"""The port's TB harness on the cipher and floating-point benches,
plaintext only (aes, des, aes_sizes, fp, as ``tb.py`` names them, on the
repo's ``examples/``): the JAX package's ``HarnessResult`` apart from
``seconds`` (tests/test_torch_testlib.py has the others)."""

import pytest

from test_torch_testlib import assert_bench_plaintext_matches


@pytest.mark.parametrize("name", ["aes", "des", "aes_sizes", "fp"])
def test_bench_plaintext_matches_jax(name):
    assert_bench_plaintext_matches(name)
