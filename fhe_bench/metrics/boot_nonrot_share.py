"""boot_nonrot_share.wide and .narrow: share of the gate batches' span time
outside their blind rotations: mod switches, accumulator init, sample
extract and key switch."""


def read(run):
    spans = run.get("spans")
    if not spans or not spans["rot_calls"] or spans["boot_s"] <= 0:
        return None
    return 100.0 * (spans["boot_s"] - spans["rot_s"]) / spans["boot_s"]
