"""build_share.host: share of the profiled slice's busy device time in
records of the host-key rotation's block build (``std_build_kernel``,
csrc/rev_step.cu), which writes each step's K-major block from the
compact key into the ring; None where the slice holds no such record.

The build runs inside the one CUDA step loop, where no host span
reaches, so the device trace reads it by kernel name (the slice's own
time of each kernel, fhe_bench/profile_slice.py)."""

KERNEL = "std_build_kernel"


def read(run):
    prof = run.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    build = [t for name, t in prof["device_ops"] if KERNEL in name]
    if not build:
        return None
    return 100.0 * sum(build) / prof["busy_s"]
