"""stage2.ns_per_curve_pair: nanoseconds of stage 2 (its baby-step table
and its pairing phase) a curve a plan entry, (ECMDriver.timings
["stage2_init"] + ["stage2"]) over counters["paired"] times the curves a
batch."""


def read(run):
    if not run.paired or "stage2" not in run.timings:
        return None
    t = run.timings.get("stage2_init", 0.0) + run.timings["stage2"]
    return t * 1e9 / (run.paired * run.batch)
