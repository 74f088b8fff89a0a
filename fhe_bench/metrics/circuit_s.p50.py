"""Median wall time of one evaluation, SetInput to the output ciphertexts
after a synchronize, over every evaluation of the window."""

import statistics


def read(run):
    return statistics.median(run["evals"])
