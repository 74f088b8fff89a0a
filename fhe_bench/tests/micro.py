"""A cell of the benchmark shrunk to MICRO parameters (n = 16, q = 256,
N = 128, the configuration's gadget), for runs on the CPU: the same
harness, key assembly and Circuit, the kernels' plain torch versions."""

import copy

from fhe_bench import run as bench_run

MICRO = {"n": 16, "q": 256, "N": 128}


def cell(name: str):
    bench, cfg, traffic = bench_run.load_cell(name)
    cfg = copy.deepcopy(cfg)
    cfg["paramset"] = "MICRO"
    q = cfg["params"]["q"]
    cfg["params"].update(MICRO)
    if "limits" in cfg:  # the widest output error scales with q
        cfg["limits"]["max_output_error"] = cfg["limits"]["max_output_error"] * MICRO["q"] // q
    return bench, cfg, traffic


def run(cfg: dict, traffic: dict, seed: int = 2**33 + 5):
    """One window of one evaluation on the CPU."""
    import time

    return bench_run.run_cell(cfg, traffic, seed, 0.0, False, device="cpu", t_start=time.time())
