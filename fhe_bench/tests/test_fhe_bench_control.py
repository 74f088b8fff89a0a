"""What decides ``correct`` has to fail what it should: the control (the
program's own approximate gadget at one digit) and faults planted under
the timed path, at MICRO on the CPU; and on a card, the control at the
cell's own size.  One chip: the cells exchange nothing between chips, so
that fault has no place here."""

import pytest
import torch

from fhe_bench import port, readings
from fhe_bench.tests import micro

CELL = "ginx.adder32.t4"
CELLS = ["ginx.adder32.t4", "ap.adder32.t4"]  # one of each configuration


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    _, cfg, traffic = micro.cell(cell)
    run = micro.run(readings.lowered(cfg), traffic)
    assert run["wrong_bits"] > 0 and run["failed"] == run["attempted"]


def _rotation_unchanged(orig):
    def blind_rotation(acc, a2N, keys):
        return acc
    return blind_rotation


def _keep(orig):
    return orig


def _half_batch(orig):
    def bootstrap_batch(prep, gate_ids, keys, tp=None):
        B = prep.shape[0]
        if B < 2:
            return orig(prep, gate_ids, keys, tp)
        out = orig(prep[: B // 2], gate_ids[: B // 2], keys, tp)
        return torch.cat([out, out])[:B]  # the left-out half takes the kept half's answers
    return bootstrap_batch


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_under_the_timed_path_fails(fault, cell):
    _, cfg, traffic = micro.cell(cell)
    if fault == "state_unchanged":
        restore = port.wrap_spans(_keep, _rotation_unchanged)
    else:
        restore = port.wrap_spans(_half_batch, _keep)
    try:
        run = micro.run(cfg, traffic)
    finally:
        restore()
    assert run["wrong_bits"] > 0


def test_answer_altered_where_produced_fails(monkeypatch):
    """One output ciphertext of each evaluation moved by q/4: its bit flips."""
    _, cfg, traffic = micro.cell(CELL)
    orig = port.output_ciphertexts

    def altered(c):
        outs = orig(c)
        outs[0][0, 0, -1] = (outs[0][0, 0, -1] + c.params.q // 4) % c.params.q
        return outs

    monkeypatch.setattr(port, "output_ciphertexts", altered)
    run = micro.run(cfg, traffic)
    assert run["wrong_bits"] == run["attempted"]


def test_noise_grown_with_bits_still_right_fails(monkeypatch):
    """An output moved by just under q/8 still decrypts right, but its
    phase error passes the configuration's limit."""
    from fhe_bench import run as bench_run

    bench, cfg, traffic = micro.cell(CELL)
    orig = port.output_ciphertexts

    def noisier(c):
        outs = orig(c)
        q = c.params.q
        outs[0][0, 0, -1] = (outs[0][0, 0, -1] + q // 8 - 3) % q
        return outs

    monkeypatch.setattr(port, "output_ciphertexts", noisier)
    run = micro.run(cfg, traffic)
    line = bench_run.result(run, bench, cfg, CELL, False, 1, "cpu (test)")
    assert run["wrong_bits"] == 0 and run["max_error"] > cfg["limits"]["max_output_error"]
    assert line["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", ["ginx.adder32.t4", "ginx.mult32.t4", "ap.adder32.t4"])
def test_control_at_the_cells_size(card, cell):
    import time

    from fhe_bench import run as bench_run

    _, cfg, traffic = bench_run.load_cell(cell)
    sound = bench_run.run_cell(cfg, traffic, 2**31 + 21, 0.0, False, device=card, t_start=time.time())
    control = bench_run.run_cell(readings.lowered(cfg), traffic, 2**31 + 21, 0.0, False,
                                 device=card, t_start=time.time())
    assert sound["wrong_bits"] == 0 and control["wrong_bits"] > 0
