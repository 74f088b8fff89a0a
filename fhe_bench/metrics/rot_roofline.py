"""rot_roofline.wide and .narrow: the blind rotations' share of their
roofline: the sum over calls of each call's least time
(fhe_bench/roofline.py: int8 operations at 1,979 TOPS or the compact
step keys and accumulators at 3.35 TB/s, whichever is longer) over the
sum of their span time."""


def read(run):
    spans = run.get("spans")
    if not spans or not spans["rot_calls"] or spans["rot_s"] <= 0:
        return None
    return 100.0 * spans["rot_least_s"] / spans["rot_s"]
