"""90th percentile (nearest rank) of one evaluation's wall time over every
evaluation of the window."""

import math


def read(run):
    times = sorted(run["evals"])
    return times[math.ceil(0.9 * len(times)) - 1]
