"""Bootstraps of the window's evaluations (the reference's count of
bootstrapped gates x T) over the window's host-clock time."""


def read(run):
    return run["bootstraps"] / run["window_s"]
