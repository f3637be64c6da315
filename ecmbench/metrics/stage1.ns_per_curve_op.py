"""stage1.ns_per_curve_op: nanoseconds of stage 1 a curve a tape op (DUP
or ADD), ECMDriver.timings["stage1"] over the window's tape ops times the
curves a batch: the host's tape planning and checkpoints included."""


def read(run):
    ops = run.stage1_dups + run.stage1_adds
    if not ops or "stage1" not in run.timings:
        return None
    return run.timings["stage1"] * 1e9 / (ops * run.batch)
