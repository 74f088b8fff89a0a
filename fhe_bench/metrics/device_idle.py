"""device_idle.wide and .narrow: share of the profiled slice of levels in
which no device record ran (torch.profiler; fhe_bench/profile_slice.py)."""


def read(run):
    prof = run.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
