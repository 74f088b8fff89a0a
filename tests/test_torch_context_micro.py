"""The BinFHEContext call sequence of tests/test_torch_context.py at MICRO
(GINX, the exact gadget: R = 8 key rows), port against JAX, bit for bit."""

from test_torch_context import check_sequence


def test_context_sequence_matches_jax_micro(monkeypatch):
    check_sequence("MICRO", monkeypatch)
