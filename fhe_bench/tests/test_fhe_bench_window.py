"""The harness's window loop and result line at MICRO on the CPU, through
run_cell, which the CLI does not expose; the CLI itself refuses to run
without a card."""

import json
import time

import pytest

from fhe_bench import run as bench_run
from fhe_bench.tests import micro


def test_cli_without_a_card_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench_run.main(["--workload", "ginx.adder32.t4", "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", ["ginx.adder32.t4"])
def test_window_and_result_line(name):
    bench, cfg, traffic = micro.cell(name)
    run = bench_run.run_cell(cfg, traffic, 2**33 + 11, 0.5, False, device="cpu",
                             t_start=time.time())
    assert run["wrong_bits"] == 0 and run["failed"] == 0 and run["loaded"] == []
    assert len(run["evals"]) >= 1 and run["window_s"] >= max(0.5, sum(run["evals"]))
    assert run["bootstraps"] == 628 * len(run["evals"])
    assert run["attempted"] == len(run["evals"]) and run["output_bits"] == 33 * 4 * len(run["evals"])
    out = bench_run.result(run, bench, cfg, name, False, 1, "cpu (test)")
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in bench_run.cell_metrics(bench, name, False)}
    assert line["compared"] == {"wrong_bits": {"value": 0, "limit": 0},
                                "max_error": {"value": run["max_error"], "limit": 25}}


def test_same_seed_same_inputs_and_outputs():
    bench, cfg, traffic = micro.cell("ginx.adder32.t4")
    a = micro.run(cfg, traffic, seed=2**31 + 3)
    b = micro.run(cfg, traffic, seed=2**31 + 3)
    assert a["max_error"] == b["max_error"] and a["wrong_bits"] == b["wrong_bits"] == 0
