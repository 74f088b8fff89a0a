"""eval_glue_ms.wide and .narrow: the evaluator's own time per level, the
mean over the window's levels of the level's wall time (Circuit.trace)
less the device time of its gate batches (bootstrap_batch spans):
gather, prep, scatter, linear gates and the per-level synchronize."""


def read(run):
    spans = run.get("spans")
    if not spans or not spans["boot_calls"] or not run["levels"]:
        return None
    return 1e3 * (run["level_walls_s"] - spans["boot_s"]) / run["levels"]
