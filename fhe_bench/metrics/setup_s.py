"""Process start to the first timed request: the kernel build (on a
checkout's first run), key generation, parsing and warm-up."""


def read(run):
    return run["setup_s"]
